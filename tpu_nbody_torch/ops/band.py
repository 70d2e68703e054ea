"""P3M band short-range pass: the hand-written CUDA kernel and its plain
version (port of tpu_nbody.ops.band_pallas and mesh._band_short_range).

Bodies in Hilbert order are cut into blocks of ``band`` consecutive slots;
each body sums the switched pair force m·d·(r²+ε²)^{-3/2}·w(r²) from every
body of its own block and both neighbour blocks. Partners past either end
of the array carry mass 0, so there are no wrap-around pairs.

:func:`band_short_range` launches ``csrc/band.cu`` for a CUDA tensor and
runs :func:`band_short_range_ref` for a CPU tensor; any other device raises.
:data:`LAUNCHES` counts the kernel launches. :func:`_band_plan` chooses the
kernel's launch shape and :func:`pair_work` counts the work of one call.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F

from tpu_nbody_torch.kernels import _build

LAUNCHES = 0
# sharded ranks run as threads of one process and launch concurrently
_COUNT_LOCK = threading.Lock()

MAX_BAND = 1024
SWITCHES = ("exp4", "poly4")
_SWITCH_IDS = {"exp4": 0, "poly4": 1}  # SWITCH_* in csrc/band.cu
# flops per pair, counted from the plain formula with rsqrt, max and exp one
# operation each: d 2, r² 3, +ε² 1, rsqrt 1, inv³ 2, ×m 1, switch (poly4:
# s 1, 1−s 1, max 1, t⁴ 2; exp4: q 1, q² 1, exp 1), ×w 1, accumulate 4
_PAIR_FLOPS = {"poly4": 21, "exp4": 18}
_BODY_BYTES = 20          # pos and mass read once, (ax, ay) written once
_SMEM_LIMIT = 48 * 1024   # MAX_SMEM in csrc/band.cu
_MAX_THREADS = 1024
_CTA_THREADS = 128        # threads a CTA aims at when B is not given


class BandPlan(NamedTuple):
    """Launch shape of ``csrc/band.cu``: each CTA covers ``B`` S-blocks
    with ``tps`` threads per S-block, each thread ``T`` targets."""
    T: int
    B: int
    tps: int
    threads: int
    grid: int
    smem: int


def _band_plan(cap: int, S: int, T: int = 8, B: int | None = None
               ) -> BandPlan:
    """The kernel's launch shape for ``cap`` bodies in S-blocks of ``S``.

    ``T`` (1, 2, 4 or 8) is halved until it is at most ``S``; ``B``
    defaults to about 128 threads a CTA and is cut to the shared memory
    limit, 1024 threads and the number of S-blocks. The kernel computes the
    same ``tps``, thread count, grid and shared bytes from (T, B). T = 8
    with 128 threads was the fastest measured at S = 128, cap 2^20 on an
    H100 (T 1-8 by B 1-8; ``PERF.md``).
    """
    if not 1 <= S <= MAX_BAND:
        raise ValueError(f"band {S} outside [1, {MAX_BAND}]")
    if T not in (1, 2, 4, 8):
        raise ValueError(f"T must be 1, 2, 4 or 8, got {T}")
    while T > S:
        T //= 2
    tps = -(-S // T)
    nb = max(1, -(-cap // S))
    if B is None:
        B = max(1, _CTA_THREADS // tps)
    B = max(1, min(B, nb, _MAX_THREADS // tps, _SMEM_LIMIT // (16 * S) - 2))
    return BandPlan(T=T, B=B, tps=tps, threads=B * tps, grid=-(-nb // B),
                    smem=(B + 2) * S * 16)


def pair_work(cap: int, band: int, switch: str = "poly4") -> dict:
    """Pairs, flops and bytes of one band pass over ``cap`` bodies: every
    body meets each body of its own and both neighbour S-blocks that lies in
    [0, cap)."""
    _check_switch(switch)
    nb = -(-cap // band)
    last = cap - (nb - 1) * band
    pairs = (nb - 1) * band * band + last * last              # own block
    if nb >= 2:                                # both sides of each border
        pairs += 2 * ((nb - 2) * band * band + band * last)
    return dict(pairs=pairs, flops=pairs * _PAIR_FLOPS[switch],
                bytes=cap * _BODY_BYTES)


def _check_switch(switch: str):
    if switch not in SWITCHES:
        raise ValueError(f"unknown mesh switch {switch!r}; expected one of "
                         f"{SWITCHES}")


def _short_weight(r2, a, switch: str = "exp4"):
    """Short-range switch weight w(r²): F_short = w·F, F_long = (1 − w)·F.

    ``exp4`` — exp(−(r/a)⁴); ``poly4`` — (1 − r²/(2a)²)⁴ clamped at 0,
    compactly supported at exactly r = 2a. Both sides of the split consult
    this function, so F_short + F_long is exact for either. Any other name
    raises (the JAX version, ``mesh._short_weight``, silently treats it as
    exp4).
    """
    _check_switch(switch)
    if switch == "poly4":
        s = r2 / (4.0 * a * a)
        t = torch.clamp(1.0 - s, min=0.0)
        t2 = t * t
        return t2 * t2
    return torch.exp(-((r2 / (a * a)) ** 2))


def _block_bounds(cap, S, chunk):
    """Blocks, blocks per chunk and chunk count of the band/rescue passes."""
    nb = -(-cap // S)
    cb = max(1, min(nb, chunk // S))
    return nb, cb, -(-nb // cb)


def band_short_range_ref(spos, smass, soft2, a, *, band: int, chunk: int,
                         switch: str = "exp4"):
    """Plain torch band pass, chunked over blocks like the JAX version
    (``tpu_nbody/ops/mesh.py::_band_short_range``): (cap, 2) in sorted
    order."""
    cap = spos.shape[0]
    S = band
    nb, cb, n_chunks = _block_bounds(cap, S, chunk)
    fields = torch.cat([spos, smass[:, None]], dim=1)          # (cap, 3)
    X = F.pad(fields, (0, 0, 0, nb * S - cap)).reshape(nb, S, 3)
    # zero guard block in front, zero blocks behind: no wrap-around pairs
    Xp = F.pad(X, (0, 0, 0, 0, 1, 1 + n_chunks * cb - nb))
    out = []
    for c in range(n_chunks):
        b0 = c * cb
        ctr = Xp[b0 + 1:b0 + 1 + cb]
        part = torch.cat([Xp[b0:b0 + cb], ctr, Xp[b0 + 2:b0 + 2 + cb]],
                         dim=1)                                # (cb, 3S, 3)
        dx = part[:, None, :, 0] - ctr[:, :, None, 0]          # (cb, S, 3S)
        dy = part[:, None, :, 1] - ctr[:, :, None, 1]
        mj = part[:, None, :, 2]
        r2 = dx * dx + dy * dy
        inv = torch.rsqrt(r2 + soft2)
        w = mj * (inv * inv * inv)
        w = w * _short_weight(r2, a, switch)
        out.append(torch.stack([torch.sum(w * dx, dim=2),
                                torch.sum(w * dy, dim=2)], dim=-1))
    return torch.cat(out).reshape(n_chunks * cb * S, 2)[:cap]


def band_short_range(spos, smass, soft2, a, *, band: int, chunk: int,
                     switch: str = "exp4"):
    """Band pass on sorted arrays: (cap, 2) accelerations in sorted order.

    ``chunk`` bounds the plain version's memory; the kernel needs none.
    """
    if spos.device.type == "cpu" and smass.device.type == "cpu":
        return band_short_range_ref(spos, smass, soft2, a, band=band,
                                    chunk=chunk, switch=switch)
    _check_switch(switch)
    cap = spos.shape[0]
    _build.check_tensor("spos", spos, (cap, 2), align=8)
    _build.check_tensor("smass", smass, (cap,), device=spos.device)
    plan = _band_plan(cap, band)
    return _launch(spos, smass, soft2, a, band, switch, plan)


def _launch(spos, smass, soft2, a, band: int, switch: str, plan: BandPlan):
    """Launch the kernel with ``plan`` on checked arguments."""
    global LAUNCHES
    out = torch.empty_like(spos)
    cap = spos.shape[0]
    if cap == 0:
        return out
    inv_scale = 1.0 / (4.0 * a * a) if switch == "poly4" else 1.0 / (a * a)
    rc = _build.library().tnt_band_short_range(
        spos.data_ptr(), smass.data_ptr(), out.data_ptr(), cap, band,
        ctypes.c_float(float(soft2)), ctypes.c_float(inv_scale),
        _SWITCH_IDS[switch], plan.T, plan.B,
        torch.cuda.current_stream(spos.device).cuda_stream)
    _build.check_launch("band_short_range", rc)
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out
