"""The yardstick's arithmetic: the card's peaks, the P3M mesh geometry and
the operations and bytes a force pass needs.

Frozen copies of the program's counts (``bench.phase_work``,
``mesh.deposit_work``, ``mesh.fd_work``, ``mesh.interp_work``, the poly4
pair flops of ``band``) and of its mesh geometry (``mesh._pm_geometry``),
so a change to the program cannot move them. Each input byte is read once
and each output byte written once; where the work depends on the data
(the pairs within the short-range cutoff, the mesh cells the bodies
touch) it is counted from the bodies themselves.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
# data sheet): float32 outside the tensor cores, and HBM3 bandwidth.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PAIR_FLOPS_POLY4 = 21       # d 2, r² 3, +ε² 1, rsqrt 1, inv³ 2, ×m 1,
                            # the poly4 switch 6, the two adds and muls 5
CELL_FLOPS_CIC = 16         # a body's CIC cell and weights
_F32, _C64 = 4, 8


def f32(x) -> float:
    return float(np.float32(x))


def root(world_w: float, world_h: float):
    """(origin, side) of the root square: max(W, H)/2 + 2 around the
    window's centre (``BarnesHutAlg.kt:359-362``)."""
    half = max(world_w, world_h) / 2.0 + 2.0
    return (world_w / 2.0 - half, world_h / 2.0 - half), 2.0 * half


def pm_geometry(origin, root_side, mesh_level, mesh_ny, split_cells):
    """(nw, ny, grid, grid_y, h, a, morigin) of the P3M mesh, in the
    program's float32 steps: nw = 2^level columns over the root side, a
    window of ny rows centred on the root, padded to twice each."""
    ox, oy = f32(origin[0]), f32(origin[1])
    side = f32(root_side)
    nw = 1 << mesh_level
    ny = mesh_ny or nw
    grid = 2 * nw
    grid_y = grid if ny == nw else 2 * ny
    h = f32(side / nw)
    a = f32(split_cells * h)
    if ny != nw:
        oy = f32(f32(oy + f32(0.5 * side)) - f32(f32(0.5 * ny) * h))
    return nw, ny, grid, grid_y, h, a, (ox, oy)


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds the card could take: the larger of flops over
    the float32 peak and bytes over the HBM peak."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def _fft_flops(points: int, real: bool) -> float:
    return (2.5 if real else 5.0) * points * math.log2(points)


def long_range_pass(n: int, cells_touched: int, nw: int, ny: int) -> dict:
    """Flops and bytes of one CIC fresh mesh pass of ``n`` bodies: the
    deposit into the occ = ny + 2 rows of the padded grid the FFT reads
    (the block written once, zeros included), the trimmed FFT convolution
    (the occupied rows forward, the ny + 7 stencil rows back, the full
    column transforms), the 6th-order FD gradient into the (ny + 1, nw +
    1) force windows, and the interpolation, reading fx and fy at the
    ``cells_touched`` window cells the bodies' taps touch."""
    K, grid, grid_y = 4, 2 * nw, 2 * ny
    cols = grid // 2 + 1
    occ, kept = ny + 2, ny + 7
    my, mx = ny + 1, nw + 1
    deposit = dict(flops=(CELL_FLOPS_CIC + 2 * K) * n,
                   bytes=n * (8 + 4) + n * (4 + 4 * K) + 4 * occ * grid)
    fft = dict(flops=(occ * _fft_flops(grid, True)
                      + kept * _fft_flops(grid, True)
                      + 2 * cols * _fft_flops(grid_y, False)
                      + 6 * grid_y * cols),
               bytes=occ * grid * _F32 + grid_y * cols * _C64
               + kept * grid * _F32)
    fd = dict(flops=16 * my * mx,
              bytes=4 * (my + 6) * (mx + 6) + 2 * 4 * my * mx)
    interp = dict(flops=2 * (2 * K - 1) * n,
                  bytes=2 * _F32 * cells_touched + n * (4 + 4 * K)
                  + n * 2 * _F32)
    parts = dict(deposit=deposit, fft=fft, fd=fd, interp=interp)
    return dict(flops=sum(p["flops"] for p in parts.values()),
                bytes=sum(p["bytes"] for p in parts.values()), parts=parts)


def short_range_pass(pairs: int, n: int) -> dict:
    """Flops and bytes of one short-range pass: ``pairs`` ordered pairs
    within the cutoff at the poly4 pair's flops, the bodies read once and
    their accelerations written once."""
    return dict(flops=pairs * PAIR_FLOPS_POLY4,
                bytes=n * (2 * _F32 + _F32) + n * 2 * _F32)


def cells_touched(pos, alive, morigin, h, nw, ny) -> int:
    """Distinct cells of the (ny + 1, nw + 1) force windows that the CIC
    taps of the alive bodies touch (``mesh.interp_work``'s count)."""
    p = pos[alive]
    org = torch.tensor(morigin, dtype=p.dtype, device=p.device)
    u = (p - org) / torch.tensor(h, dtype=p.dtype, device=p.device) - 0.5
    b = torch.floor(u).to(torch.int64)
    bx = torch.clamp(b[:, 0], 0, nw - 1)
    by = torch.clamp(b[:, 1], 0, ny - 1)
    ld = nw + 1
    c0 = by * ld + bx
    offs = torch.tensor([0, 1, ld, ld + 1], device=p.device)
    return int(torch.unique(c0[:, None] + offs[None, :]).numel())


def pairs_within(pos, mass, alive, rc: float, chunk: int = 1 << 24) -> int:
    """Ordered pairs (i, j), i != j, both alive with mass, with |x_i -
    x_j| < rc: a cell list of cells of side rc
    (:func:`nbody_bench.reference.p3m.cell_pairs`), in float64."""
    from nbody_bench.reference.p3m import cell_pairs

    live = alive & (mass > 0)
    p = pos[live].to(torch.float64)
    total = 0
    for order, i, j, _, _ in cell_pairs(p, rc, chunk):
        d = p[order[j]] - p[order[i]]
        total += int((((d * d).sum(dim=1) < rc * rc) & (i != j)).sum())
    return total
