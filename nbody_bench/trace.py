"""A ``torch.profiler`` trace of a slice of whole calls, and its reading.

The traced run profiles a few calls inside its window, with CUDA activity
alone: CUPTI's records of the device operations and of the host's CUDA
runtime calls that launch them, without a record of every host operator
(which costs the host more per operator than the engine's own enqueue).
The harness marks each traced call by launching :data:`MARK_KERNEL`
(``torch.cuda._sleep(0)``, one thread that returns at once) just before
and just after it: the host timestamps of those two runtime launches are
the call's start and end, and the marks' kernels are left out of every
reading. The slice is padded by :data:`PAD_S` of host sleep on each side:
on the card the profiler moves a device operation's start onto the host's
clock, and after a minute of load that move went wrong by more than half
a second, dropping operations from an unpadded window. Once the window
has closed, the Chrome trace goes to a temporary directory under
``TMPDIR`` and is deleted once read.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from contextlib import contextmanager
from typing import NamedTuple

import torch

from nbody_bench import stats

PAD_S = 2.0
MARK_KERNEL = "spin_kernel"
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
_LAUNCH_WORDS = ("Launch", "Memcpy", "Memset")


class Span(NamedTuple):
    name: str
    start: float        # seconds on the trace's clock
    end: float


class Trace(NamedTuple):
    device: list        # Span of each device operation, by start
    launches: list      # Span of each runtime call that enqueues one
    runtime: list       # Span of every host runtime call
    marks: list         # Span of each traced call, start mark to end mark
    t0: float           # the slice: the first call's start mark, to when
    t1: float           # the host has returned from the last call and the
                        # card has run what the slice gave it

    def device_in_slice(self) -> list:
        return [s for s in self.device
                if s.end > self.t0 and s.start < self.t1]

    def busy_s(self) -> float:
        return stats.union([(s.start, s.end) for s in self.device],
                           self.t0, self.t1)

    def window_s(self) -> float:
        return self.t1 - self.t0


def _span(e) -> Span:
    ts = float(e["ts"]) * 1e-6
    return Span(e["name"], ts, ts + float(e.get("dur", 0.0)) * 1e-6)


def _corr(e):
    return (e.get("args") or {}).get("correlation")


def parse(path: str) -> Trace:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    marked = {_corr(e) for e in events
              if e.get("cat") in DEVICE_CATS and MARK_KERNEL in e["name"]}
    marked.discard(None)
    device, launches, runtime, points = [], [], [], []
    for e in events:
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            if _corr(e) not in marked:
                device.append(_span(e))
        elif cat in RUNTIME_CATS:
            if _corr(e) in marked:
                points.append(_span(e))
                continue
            runtime.append(_span(e))
            if any(w in e["name"] for w in _LAUNCH_WORDS):
                launches.append(_span(e))
    for lst in (device, launches, runtime, points):
        lst.sort(key=lambda s: s.start)
    marks = [Span("call", a.start, b.end)
             for a, b in zip(points[0::2], points[1::2])]
    t0 = t1 = 0.0
    if marks:
        t0 = marks[0].start
        t1 = max([marks[-1].end] + [s.end for s in device
                                    if s.start < marks[-1].end])
    return Trace(device, launches, runtime, marks, t0, t1)


@contextmanager
def profiled(sync, pad_s: float = PAD_S):
    """Profile the card's activity in the block, padded by ``pad_s``;
    yields a list that holds the stopped profiler once the block has
    ended (:func:`read` turns it into a :class:`Trace`)."""
    from torch.profiler import ProfilerActivity, profile

    out = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sync()
        time.sleep(pad_s)
        yield out
        sync()
        time.sleep(pad_s)
    out.append(prof)


def read(prof) -> Trace:
    """The stopped profiler's Chrome trace, written under ``TMPDIR``,
    parsed and deleted."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        return parse(path)


@contextmanager
def mark():
    """Mark one traced call: a :data:`MARK_KERNEL` launch before and after
    it."""
    torch.cuda._sleep(0)
    yield
    torch.cuda._sleep(0)


def enqueue_s(tr: Trace) -> float:
    """Host seconds from each call's start to the end of the runtime call
    that launched its last device operation, summed over the calls."""
    total = 0.0
    for m in tr.marks:
        inside = [s for s in tr.launches if m.start <= s.start <= m.end]
        if inside:
            total += inside[-1].end - m.start
    return total


def _label(tr: Trace, starts, dev_starts, a: float, b: float) -> str:
    """What the host was doing in the device's idle gap (a, b): the
    innermost runtime call running at its middle, else the host's own
    work before the launch of the operation that ends the gap."""
    t = 0.5 * (a + b)
    i = bisect.bisect_right(starts, t)
    for s in reversed(tr.runtime[max(0, i - 64):i]):
        if s.end >= t:
            return "host in " + s.name
    j = bisect.bisect_left(dev_starts, b)
    if j < len(tr.device):
        return "host, then " + tr.device[j].name
    return "host: after the last operation"


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the slice, and the
    device's idle time in the slice by what the host was doing
    (:func:`_label`)."""
    by_name = {}
    for s in tr.device_in_slice():
        by_name[s.name] = by_name.get(s.name, 0.0) + (s.end - s.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = {}
    starts = [s.start for s in tr.runtime]
    dev_starts = [s.start for s in tr.device]
    for a, b in stats.gaps([(s.start, s.end) for s in tr.device], tr.t0,
                           tr.t1):
        label = _label(tr, starts, dev_starts, a, b)
        idle[label] = idle.get(label, 0.0) + (b - a)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], v] for n, v in ops],
            "idle_gaps": [[n[:160], v] for n, v in gaps]}
