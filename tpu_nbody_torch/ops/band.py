"""P3M band short-range pass: the hand-written CUDA kernel and its plain
version (port of tpu_nbody.ops.band_pallas and mesh._band_short_range).

Bodies in Hilbert order are cut into blocks of ``band`` consecutive slots;
each body sums the switched pair force m·d·(r²+ε²)^{-3/2}·w(r²) from every
body of its own block and both neighbour blocks. Partners past either end
of the array carry mass 0, so there are no wrap-around pairs.

:func:`band_short_range` launches ``csrc/band.cu`` for a CUDA tensor and
runs :func:`band_short_range_ref` for a CPU tensor; any other device raises.
:data:`LAUNCHES` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpu_nbody_torch.kernels import _build

LAUNCHES = 0

MAX_BAND = 1024  # one thread per body of a block
SWITCHES = ("exp4", "poly4")
_SWITCH_IDS = {"exp4": 0, "poly4": 1}  # SWITCH_* in csrc/band.cu


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
    global LAUNCHES
    if spos.device.type == "cpu" and smass.device.type == "cpu":
        return band_short_range_ref(spos, smass, soft2, a, band=band,
                                    chunk=chunk, switch=switch)
    _check_switch(switch)
    cap = spos.shape[0]
    _build.check_tensor("spos", spos, (cap, 2))
    _build.check_tensor("smass", smass, (cap,), device=spos.device)
    if not 1 <= band <= MAX_BAND:
        raise ValueError(f"band {band} outside [1, {MAX_BAND}]")
    out = torch.empty_like(spos)
    if cap == 0:
        return out
    lib = _build.library()
    rc = lib.tnt_band_short_range(
        spos.data_ptr(), smass.data_ptr(), out.data_ptr(), cap, band,
        ctypes.c_float(float(soft2)), ctypes.c_float(float(a)),
        _SWITCH_IDS[switch], torch.cuda.current_stream(spos.device)
        .cuda_stream)
    _build.check_launch("band_short_range", rc)
    LAUNCHES += 1
    return out
