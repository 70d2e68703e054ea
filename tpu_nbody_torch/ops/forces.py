"""Exact O(N²) all-pairs gravity: the hand-written CUDA kernel and its plain
version (port of tpu_nbody.ops.forces).

    a_i = G Σ_j m_j (p_j − p_i) / (|p_j − p_i|² + ε²)^{3/2}

with the softening inside r² as in both reference kernels
(``BarnesHutAlg.kt:253``, ``gpu/GPU.kt:139``), in dim 2 or 3. Self pairs
and dead (mass-0) bodies contribute exactly zero. Targets may differ from
the sources, so exact forces on a sample of bodies cost (samples x N)
pairs instead of N².

:func:`accel_allpairs` launches ``csrc/allpairs.cu`` for CUDA tensors and runs
:func:`accel_allpairs_ref` for CPU tensors; any other device raises.
``_build.LAUNCHES`` counts the kernel launches (``"allpairs"``) and the target
x source pairs evaluated on either device (``"allpairs_pairs"``).
:func:`_split_plan` chooses the kernel's launch shape and :func:`pair_work`
counts the work of one call.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tpu_nbody_torch.kernels import _build

THREADS = 128   # threads per block, THREADS in csrc/allpairs.cu
TILE = 256      # sources per staged tile, TILE in csrc/allpairs.cu
T = 8           # targets per thread, T in csrc/allpairs.cu
# flops per pair from the plain formula, rsqrt and divide one operation
# each: d (dim), r² (2 dim), rsqrt 1, /r² 1, ×m 1, accumulate (2 dim)
_PAIR_FLOPS = {2: 13, 3: 18}


class SplitPlan(NamedTuple):
    """Launch shape of ``csrc/allpairs.cu``: a grid of ``blocks`` target
    blocks (``THREADS`` threads of ``T`` targets) by ``splits`` source
    ranges. Split p sums the source tiles [p·tiles/splits,
    (p+1)·tiles/splits) of the ⌈ns/TILE⌉ tiles, so the splits differ by at
    most one tile."""
    blocks: int
    splits: int


def _split_plan(nt: int, ns: int, n_sm: int, per_sm: int) -> SplitPlan:
    """Split the sources so the grid fills ``n_sm`` SMs holding ``per_sm``
    blocks each at once (the CUDA occupancy API's count for the kernel):
    one full wave, where the sources allow it (a split holds at least one
    tile)."""
    blocks = max(1, -(-nt // (THREADS * T)))
    tiles = max(1, -(-ns // TILE))
    splits = min(tiles, max(1, -(-per_sm * n_sm // blocks)))
    return SplitPlan(blocks=blocks, splits=splits)


def pair_work(nt: int, ns: int, dim: int) -> dict:
    """Pairs, flops and bytes of one all-pairs call: targets, sources and
    masses read once, the accelerations written once."""
    pairs = nt * ns
    return dict(pairs=pairs, flops=pairs * _PAIR_FLOPS[dim],
                bytes=4 * (2 * nt * dim + ns * (dim + 1)))


def accel_allpairs_ref(pos, mass, G, soft2, *, targets=None, chunk=256):
    """Plain torch all-pairs acceleration, chunked over targets.

    Pair terms are float32; each target's sum over the sources is taken in
    float64 (the kernel adds float32 sums of 256 sources in float64): a
    float32 sum over 2^20 sources differs between summation orders by
    ~5e-5 of the result (measured on an H100), more than the
    kernel-vs-plain tolerance.
    """
    tgt = pos if targets is None else targets
    out = []
    for t0 in range(0, tgt.shape[0], chunk):
        d = pos[None, :, :] - tgt[t0:t0 + chunk, None, :]    # (C, N, dim)
        r2 = torch.sum(d * d, dim=-1) + soft2
        w = mass[None, :] * torch.rsqrt(r2) / r2
        out.append(torch.sum(w[:, :, None] * d, dim=1, dtype=torch.float64))
    if not out:
        return torch.zeros_like(tgt)
    return G * torch.cat(out).to(pos.dtype)


def accel_allpairs(pos, mass, G, soft2, *, targets=None):
    """Exact all-pairs acceleration on ``targets`` (default: ``pos``
    itself) from the sources ``pos`` (n, dim) with masses ``mass`` (n,);
    returns (n_targets, dim). Pass dead bodies with mass 0. On the card the
    same inputs give the same bits on every call."""
    tgt = pos if targets is None else targets
    if all(t.device.type == "cpu" for t in (pos, mass, tgt)):
        acc = accel_allpairs_ref(pos, mass, G, soft2, targets=targets)
        _build.count("allpairs_pairs", tgt.shape[0] * pos.shape[0])
        return acc
    ns, dim = pos.shape
    if dim not in (2, 3):
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    _build.check_tensor("pos", pos, (ns, dim), align=8)
    _build.check_tensor("mass", mass, (ns,), device=pos.device)
    _build.check_tensor("targets", tgt, (tgt.shape[0], dim),
                        device=pos.device)
    plan = _card_plan(tgt.shape[0], ns, dim, pos.device)
    return G * _launch(pos, mass, soft2, tgt, plan)


def _card_plan(nt: int, ns: int, dim: int, device) -> SplitPlan:
    """:func:`_split_plan` for this card: its SM count, and as many blocks
    an SM as one SM holds at once."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm = _build.library().tnt_allpairs_blocks_per_sm(dim)
    if per_sm < 1:
        raise RuntimeError(f"allpairs: no occupancy for dim={dim}")
    return _split_plan(nt, ns, n_sm, per_sm)


def _launch(pos, mass, soft2, tgt, plan: SplitPlan):
    """Launch the kernel with ``plan`` on checked arguments; returns the
    sums without G."""
    ns, dim = pos.shape
    nt = tgt.shape[0]
    out = torch.empty((nt, dim), dtype=pos.dtype, device=pos.device)
    if nt == 0:
        return out
    scratch = torch.empty((plan.splits, nt, dim), dtype=torch.float64,
                          device=pos.device)
    rc = _build.library().tnt_allpairs(
        tgt.data_ptr(), pos.data_ptr(), mass.data_ptr(), scratch.data_ptr(),
        out.data_ptr(), nt, ns, dim, ctypes.c_float(float(soft2)),
        plan.splits, _build.stream(pos.device))
    _build.check_launch("allpairs", rc)
    _build.count("allpairs_pairs", nt * ns)
    return out


def potential_energy(pos, mass, G, soft2, chunk=1024):
    """Total softened (Plummer) potential energy, consistent with the
    force: U = −½ G Σ_{i≠j} m_i m_j / sqrt(r² + ε²)."""
    n = pos.shape[0]
    idx = torch.arange(n, device=pos.device)
    total = torch.zeros((), dtype=pos.dtype, device=pos.device)
    for t0 in range(0, n, chunk):
        p = pos[t0:t0 + chunk]
        d = pos[None, :, :] - p[:, None, :]
        r2 = torch.sum(d * d, dim=-1) + soft2
        u = -torch.rsqrt(torch.clamp(r2, min=1e-30))
        pair = mass[t0:t0 + chunk, None] * mass[None, :] * u
        self_mask = idx[t0:t0 + chunk, None] == idx[None, :]
        total = total + torch.sum(torch.where(self_mask, 0.0, pair))
    return 0.5 * G * total
