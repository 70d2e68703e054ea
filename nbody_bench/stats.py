"""Arithmetic on a window's records and a trace's spans (pure Python)."""

from __future__ import annotations

import math


def rate(units: float, seconds: float) -> float:
    """Units completed over the window's seconds."""
    return units / seconds


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    the closest ranks, over every value."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def union(spans, t0: float = -math.inf, t1: float = math.inf) -> float:
    """Length of the union of the intervals (start, end) clipped to
    [t0, t1]."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        a, b = max(a, t0, end), min(b, t1)
        if b > a:
            busy += b - a
        end = max(end, b)
    return busy


def gaps(spans, t0: float, t1: float):
    """The idle intervals (start, end) of [t0, t1] that no span covers."""
    out, cur = [], t0
    for a, b in sorted(spans):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if t1 > cur:
        out.append((cur, t1))
    return out
