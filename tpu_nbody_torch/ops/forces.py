"""Exact O(N²) all-pairs gravity: the hand-written CUDA kernel and its plain
version (port of tpu_nbody.ops.forces).

    a_i = G Σ_j m_j (p_j − p_i) / (|p_j − p_i|² + ε²)^{3/2}

with the softening inside r² as in both reference kernels
(``BarnesHutAlg.kt:253``, ``gpu/GPU.kt:139``), in dim 2 or 3. Self pairs
and dead (mass-0) bodies contribute exactly zero. Targets may differ from
the sources, so exact forces on a sample of bodies cost (samples x N)
pairs instead of N².

:func:`accel_allpairs` launches ``csrc/allpairs.cu`` for CUDA tensors and
runs :func:`accel_allpairs_ref` for CPU tensors; any other device raises.
:data:`LAUNCHES` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_nbody_torch.kernels import _build

LAUNCHES = 0


def accel_allpairs_ref(pos, mass, G, soft2, *, targets=None, chunk=256):
    """Plain torch all-pairs acceleration, chunked over targets.

    Pair terms are float32; each target's sum over the sources is taken in
    float64, as the kernel takes it: a float32 sum over 2^20 sources
    differs between summation orders by ~5e-5 of the result (measured on
    an H100), more than the kernel-vs-plain tolerance.
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
    returns (n_targets, dim). Pass dead bodies with mass 0."""
    global LAUNCHES
    tgt = pos if targets is None else targets
    if all(t.device.type == "cpu" for t in (pos, mass, tgt)):
        return accel_allpairs_ref(pos, mass, G, soft2, targets=targets)
    ns, dim = pos.shape
    if dim not in (2, 3):
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    _build.check_tensor("pos", pos, (ns, dim))
    _build.check_tensor("mass", mass, (ns,), device=pos.device)
    _build.check_tensor("targets", tgt, (tgt.shape[0], dim),
                        device=pos.device)
    nt = tgt.shape[0]
    out = torch.empty((nt, dim), dtype=pos.dtype, device=pos.device)
    if nt == 0:
        return out
    lib = _build.library()
    rc = lib.tnt_allpairs(
        tgt.data_ptr(), pos.data_ptr(), mass.data_ptr(), out.data_ptr(), nt,
        ns, dim, ctypes.c_float(float(soft2)),
        torch.cuda.current_stream(pos.device).cuda_stream)
    _build.check_launch("allpairs", rc)
    LAUNCHES += 1
    return G * out


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
