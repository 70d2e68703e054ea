"""P3M (particle-mesh + short-range pair correction) force solver — port of
tpu_nbody.ops.mesh, fresh-pass path.

The softened force law F(d) = G m d / (|d|² + ε²)^{3/2}
(``BarnesHutAlg.kt:250-259``) is split as F = w·F + (1 − w)·F with a
short-range switch w (:func:`_short_weight`):

* F_long = (1 − w)·F is smooth at the split scale ``a`` and is computed on a
  mesh: CIC deposit, one zero-padded FFT convolution with a precomputed
  potential kernel, a 6th-order finite-difference gradient, and CIC
  interpolation back to the bodies;
* F_short = w·F is summed over a block-tridiagonal band in Hilbert order
  (:mod:`tpu_nbody_torch.ops.band`, the hand-written kernel on the card)
  plus an exact block rescue for neighbours the curve puts far apart
  (:func:`_block_rescue`).

The FFTs go to the device's FFT library through ``torch.fft``; deposit,
interpolation and rescue are plain torch in this port so far (hand kernels
for them are listed in ROADMAP.md, queue 2).

Not ported yet, and refused with ``NotImplementedError``: TSC/NGP
assignment, interlacing, two-tier rescue, the run-compressed deposit modes
and the carried-mesh (subcycling / heavy-direct) path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tpu_nbody_torch.config import ROADMAP_NOTE, f32
from tpu_nbody_torch.ops import band as band_ops
from tpu_nbody_torch.ops import morton
# The switch and the block layout are shared with the band pass, which owns
# them; they keep their JAX-package names here.
from tpu_nbody_torch.ops.band import (  # noqa: F401
    SWITCHES, _block_bounds, _check_switch, _short_weight)


def _refuse(what: str):
    raise NotImplementedError(f"{what}: {ROADMAP_NOTE}")


def _hilbert_sort(pos, mass, alive, origin, side):
    """Hilbert-sorted (pos, mass with dead zeroed, alive, unsort perm)."""
    codes = morton.hilbert_codes(pos, origin, side, alive)
    order = torch.argsort(codes, stable=True)
    unsort = torch.empty_like(order)
    unsort[order] = torch.arange(order.shape[0], device=order.device)
    alive_s = alive[order]
    return (pos[order], torch.where(alive_s, mass[order], 0.0), alive_s,
            unsort)


def _assignment_deconv(grid, grid_y, order, dtype, device):
    """1/Ŵ² on the rfft2 layout: compensation for the assignment window
    applied twice (deposit and interpolation), per axis sinc(q̃/N)^order
    at the wrapped frequency q̃ (Hockney & Eastwood ch. 8)."""
    qx = torch.arange(grid // 2 + 1, device=device).to(dtype)
    wx = torch.sinc(qx / grid) ** order
    qy = torch.arange(grid_y, device=device)
    qyw = torch.where(qy <= grid_y // 2, qy, qy - grid_y).to(dtype)
    wy = torch.sinc(qyw / grid_y) ** order
    w2 = (wx[None, :] * wy[:, None]) ** 2
    return 1.0 / torch.clamp(w2, min=1e-6)


def _d6(grid, h, dtype, device):
    """Eigenvalues of the 6th-order central difference on ``grid`` modes."""
    tw = 2.0 * math.pi * torch.arange(grid, device=device).to(dtype) / grid
    return (45.0 * torch.sin(tw) - 9.0 * torch.sin(2.0 * tw)
            + torch.sin(3.0 * tw)) / (30.0 * h)


def _kernel_hats(grid, h, soft2, a, dtype, device, grid_y=None,
                 deconv_order=0, switch="exp4"):
    """Spectral kernels for the long-range convolution: (Kx̂, Kŷ, φ̂).

    Kx̂/Kŷ are rfft2s of the sampled long-range force kernel over the
    padded (grid_y, grid) domain in wrapped order; φ̂ is the least-squares
    potential kernel whose 6th-order FD gradient reproduces them:
    φ̂ = −i·(d6x·Kx̂ + d6y·Kŷ) / (d6x² + d6y²), 0 where both eigenvalues
    vanish. ``deconv_order`` > 0 multiplies all three by
    :func:`_assignment_deconv`. See ``tpu_nbody/ops/mesh.py::_kernel_hats``.
    """
    gy = grid if grid_y is None else grid_y
    ix = torch.arange(grid, device=device)
    off = torch.where(ix <= grid // 2, ix, ix - grid).to(dtype) * h
    iy = torch.arange(gy, device=device)
    offy = torch.where(iy <= gy // 2, iy, iy - gy).to(dtype) * h
    dy = offy[:, None]
    dx = off[None, :]
    r2 = dx * dx + dy * dy
    inv = torch.rsqrt(r2 + soft2) / (r2 + soft2)
    long_frac = 1.0 - _short_weight(r2, a, switch)
    kx_hat = torch.fft.rfft2(-dx * inv * long_frac)
    ky_hat = torch.fft.rfft2(-dy * inv * long_frac)
    del r2, inv, long_frac
    d6x = _d6(grid, h, dtype, device)[None, : grid // 2 + 1]
    d6y = _d6(gy, h, dtype, device)[:, None]
    den = d6x * d6x + d6y * d6y
    safe = torch.where(den > 0, den, 1.0)
    phi_hat = torch.where(den > 0,
                          -1j * (d6x * kx_hat + d6y * ky_hat) / safe,
                          0.0)
    if deconv_order:
        d = _assignment_deconv(grid, gy, deconv_order, dtype, device)
        kx_hat, ky_hat, phi_hat = kx_hat * d, ky_hat * d, phi_hat * d
    return kx_hat, ky_hat, phi_hat


def kernel_hats_for(root_side, soft2, *, mesh_level: int, split_cells: float,
                    mesh_ny: int = 0, dtype=torch.float32, order: int = 2,
                    deconvolve: bool = True, switch: str = "exp4",
                    device="cpu"):
    """Precompute the (Kx̂, Kŷ, φ̂) long-range kernel FFTs on ``device``.

    They depend only on the config and ``soft2``: compute them once per
    ``step(n)`` call and pass them as ``pm_accel(..., kernel=...)``.
    """
    if order != 2:
        _refuse(f"mesh_order={order}")
    nw = 1 << mesh_level
    ny = mesh_ny or nw
    grid = 2 * nw
    h = f32(f32(root_side) / nw)
    a = f32(split_cells * h)
    return _kernel_hats(grid, h, soft2, a, dtype, device, grid_y=2 * ny,
                        deconv_order=order if deconvolve else 0,
                        switch=switch)


def _topk_lowest_index(score, k):
    """``torch.topk`` of non-negative scores along dim 1, ties broken
    towards the lower index as ``jax.lax.top_k`` breaks them.

    The float bits of a non-negative float32 order like the value, so the
    int64 key (bits << 32) | (n − 1 − index) has no ties.
    """
    n = score.shape[1]
    idx = torch.arange(n - 1, -1, -1, device=score.device)
    key = (score.view(torch.int32).to(torch.int64) << 32) | idx
    _, midx = torch.topk(key, k, dim=1)
    return torch.gather(score, 1, midx), midx


def _block_rescue(spos, smass, salive, soft2, a, *, band: int, k: int,
                  chunk: int, k_hot: int = 0, switch: str = "exp4"):
    """Exact short-range rescue for pairs more than one block apart in
    sorted order (single tier).

    Per band block: alive-only bounding boxes, a chunked (cb, B) box-gap
    test against the cutoff 2a, the ``k`` closest partner blocks that are
    more than one block away (closest box first, so an overflow drops the
    farthest, weakest pairs), one block-row gather and a dense
    (cb, S, kS) pair sum. Returns ``(acc_sorted (cap, 2), need,
    hot_count)``: ``need`` is the largest partner count any block wanted
    (coverage is exact iff need <= k), ``hot_count`` the number of blocks
    that wanted more than ``k``. See the JAX version for the measurements
    behind the design.
    """
    if k_hot > k:
        _refuse("two-tier rescue (mesh_rescue_hot > 0)")
    _check_switch(switch)
    cap = spos.shape[0]
    S = band
    dtype, dev = spos.dtype, spos.device
    B, cb, n_chunks = _block_bounds(cap, S, chunk)
    pad = B * S - cap
    fields = torch.cat([spos, smass[:, None]], dim=1)
    fields = F.pad(fields, (0, 0, 0, pad))
    live = F.pad(salive, (0, pad))
    X = fields.reshape(B, S, 3)
    lv = live.reshape(B, S)
    big = torch.finfo(dtype).max
    # alive-only bounding boxes; empty blocks get inverted boxes whose gap
    # to everything is huge => no partners.
    bminx = torch.where(lv, X[..., 0], big).amin(dim=1)
    bmaxx = torch.where(lv, X[..., 0], -big).amax(dim=1)
    bminy = torch.where(lv, X[..., 1], big).amin(dim=1)
    bmaxy = torch.where(lv, X[..., 1], -big).amax(dim=1)
    rcut2 = (2.0 * a) * (2.0 * a)

    k = min(k, B)
    n_pad = n_chunks * cb - B
    Xb = F.pad(X.reshape(B, S * 3), (0, 0, 0, n_pad))
    bbox = torch.stack([bminx, bmaxx, bminy, bmaxy], dim=1)
    bbox = torch.cat([bbox, torch.tensor([big, -big, big, -big], dtype=dtype,
                                         device=dev).expand(n_pad, 4)])
    idx_all = torch.arange(B, device=dev)
    accs, cnts = [], []
    for c in range(n_chunks):
        b0 = c * cb
        bb = bbox[b0:b0 + cb]                                # my boxes
        gx = torch.clamp(torch.maximum(bb[:, 0:1] - bmaxx[None, :],
                                       bminx[None, :] - bb[:, 1:2]), min=0.0)
        gy = torch.clamp(torch.maximum(bb[:, 2:3] - bmaxy[None, :],
                                       bminy[None, :] - bb[:, 3:4]), min=0.0)
        g2 = gx * gx + gy * gy
        near = g2 < rcut2                                    # (cb, B)
        dblk = (b0 + torch.arange(cb, device=dev))[:, None] - idx_all[None, :]
        mask = near & (dblk.abs() > 1)
        cnts.append(mask.sum(dim=1, dtype=torch.int32))     # partners needed
        score = torch.where(mask, rcut2 - g2, 0.0)
        mval, midx = _topk_lowest_index(score, k)            # (cb, k)
        mval = (mval > 0).to(dtype)
        part = Xb[midx].reshape(cb, k, S, 3)                 # block row gather
        pm = (part[..., 2] * mval[:, :, None]).reshape(cb, k * S)
        px = part[..., 0].reshape(cb, k * S)
        py = part[..., 1].reshape(cb, k * S)
        ctr = Xb[b0:b0 + cb].reshape(cb, S, 3)
        dx = px[:, None, :] - ctr[:, :, None, 0]             # (cb, S, kS)
        dy = py[:, None, :] - ctr[:, :, None, 1]
        r2 = dx * dx + dy * dy
        inv = torch.rsqrt(r2 + soft2)
        w = pm[:, None, :] * (inv * inv * inv)
        w = w * _short_weight(r2, a, switch)
        accs.append(torch.stack([torch.sum(w * dx, dim=2),
                                 torch.sum(w * dy, dim=2)], dim=-1))
    acc = torch.cat(accs).reshape(n_chunks * cb * S, 2)
    cnt_all = torch.cat(cnts)[:B]                            # exact needs
    need = cnt_all.max()
    hot_count = (cnt_all > k).sum(dtype=torch.int32)
    return acc[:cap], need, hot_count


def _cic_cells(spos, origin, h, nw, order, ny=None):
    """Base world cell (row-major, clipped) and the four CIC weights for
    offsets [(0,0), (+x,0), (0,+y), (+x,+y)] in cell-centre coordinates.

    The base is clipped to [0, n-1] per axis (nw columns, ``ny`` or nw
    rows); positive offsets reach row/column n, the first padded row/column
    of the FFT domain.
    """
    if order != 2:
        _refuse(f"mesh_order={order}")
    dtype = spos.dtype
    ny = nw if ny is None else ny
    org = torch.as_tensor(origin, dtype=dtype, device=spos.device)
    scaled = (spos - org) / h
    u = scaled - 0.5                   # in cell-CENTER coordinates
    b = torch.floor(u).to(torch.int32)
    frac = u - b.to(dtype)             # in [0, 1)
    bx = torch.clamp(b[:, 0], 0, nw - 1)
    by = torch.clamp(b[:, 1], 0, ny - 1)
    wx1, wy1 = frac[:, 0], frac[:, 1]
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    w4 = torch.stack([wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1], dim=1)
    return by * nw + bx, w4


def _deposit_packed(smass, base, w, nw, grid, run_compress: bool = False,
                    ny=None, grid_y=None):
    """Mass deposit: four independent plane scatter-adds (one per CIC
    offset, all at the shared base cell), then a pad-shift combine into
    the padded (grid_y, grid) FFT grid.

    ``index_add_`` uses atomics on the card, so the per-cell summation
    order changes from run to run there.
    """
    if run_compress:
        _refuse(f"run_compress={run_compress!r}")
    if w.shape[1] != 4:
        _refuse(f"deposit with {w.shape[1]} cells per body")
    dtype = smass.dtype
    ny = nw if ny is None else ny
    grid_y = grid if grid_y is None else grid_y
    planes = [torch.zeros((ny * nw,), dtype=dtype, device=smass.device)
              .index_add_(0, base, smass * w[:, k]).reshape(ny, nw)
              for k in range(4)]
    # F.pad pads the last dim first: (left, right, top, bottom)
    world = (F.pad(planes[0], (0, 1, 0, 1)) + F.pad(planes[1], (1, 0, 0, 1))
             + F.pad(planes[2], (0, 1, 1, 0)) + F.pad(planes[3], (1, 0, 1, 0)))
    rho = torch.zeros((grid_y, grid), dtype=dtype, device=smass.device)
    rho[:ny + 1, :nw + 1] = world
    return rho


def _interp_table(fx, fy, nw, order, ny=None):
    """Pack the (fx, fy) values of the four CIC cells into one
    (ny*nw, 8) row per base cell, so each body fetches one row."""
    if order != 2:
        _refuse(f"mesh_order={order}")
    ny = nw if ny is None else ny

    def sl(g, dy, dx):
        return g[dy:dy + ny, dx:dx + nw]

    T = torch.stack([sl(fx, 0, 0), sl(fy, 0, 0), sl(fx, 0, 1), sl(fy, 0, 1),
                     sl(fx, 1, 0), sl(fy, 1, 0), sl(fx, 1, 1), sl(fy, 1, 1)],
                    dim=-1)
    return T.reshape(ny * nw, 8)


def _interp_rows(T, base, w):
    """One row gather per body from :func:`_interp_table`, weighted."""
    K = w.shape[1]
    rows = T[base]                                  # (n, 2K) single gather
    ax = sum(w[:, k] * rows[:, 2 * k] for k in range(K))
    ay = sum(w[:, k] * rows[:, 2 * k + 1] for k in range(K))
    return torch.stack([ax, ay], dim=-1)


def _interp_packed(fx, fy, base, w, nw, ny=None):
    """Force interpolation with one row gather per body; mirrors
    :func:`_deposit_packed`'s assignment so the odd kernel's self-force
    cancels."""
    return _interp_rows(_interp_table(fx, fy, nw, 2, ny=ny), base, w)


def _conv_potential(rho, phi_hat, ny, grid, grid_y, extra=0):
    """Trimmed FFT convolution: deposited grid -> potential FD window.

    Only rows 0..ny+1 of the padded grid hold mass, so the forward row
    transforms run on those; only potential rows -3..ny+3 feed the FD
    stencil, so the inverse row transforms run on ny+7 rows (the three
    negative rows wrap to the far padded edge, ``sp[-3:]``). The column
    transforms stay full. Returns the (ny+7+extra, grid) rows -3..ny+3.
    """
    occ = ny + 2 + extra
    rh = torch.fft.rfft(rho[:occ], dim=1)
    rh = F.pad(rh, (0, 0, 0, grid_y - occ))
    sp = torch.fft.ifft(torch.fft.fft(rh, dim=0) * phi_hat, dim=0)
    rows = torch.cat([sp[-3:], sp[:ny + 4 + extra]])
    return torch.fft.irfft(rows, n=grid, dim=1)


def _mesh_grids_one(spos, smass, origin, h, nw, grid, order, kernel,
                    ny=None):
    """Deposit -> FFT convolution -> 6th-order FD gradient.

    Returns the force-grid windows ``(fx, fy)`` of shape (ny+1, nw+1): the
    long-range field at world cell corners. The stencil's three negative
    taps per axis wrap to the far padded edge (the ``sp[-3:]`` rows and the
    column roll), as in the JAX version.
    """
    ny = nw if ny is None else ny
    grid_y = grid if ny == nw else 2 * ny
    base, w = _cic_cells(spos, origin, h, nw, order, ny=ny)
    rho = _deposit_packed(smass, base, w, nw, grid, ny=ny, grid_y=grid_y)
    _, _, phi_hat = kernel
    pw = _conv_potential(rho, phi_hat, ny, grid, grid_y)
    win = nw + 7
    pw = torch.roll(pw, 3, dims=1)[:, :win]
    c1 = 45.0 / (60.0 * h)
    c2 = 9.0 / (60.0 * h)
    c3 = 1.0 / (60.0 * h)
    mx = nw + 1
    my = ny + 1
    fx = (c1 * (pw[3:3 + my, 4:4 + mx] - pw[3:3 + my, 2:2 + mx])
          - c2 * (pw[3:3 + my, 5:5 + mx] - pw[3:3 + my, 1:1 + mx])
          + c3 * (pw[3:3 + my, 6:6 + mx] - pw[3:3 + my, 0:0 + mx]))
    fy = (c1 * (pw[4:4 + my, 3:3 + mx] - pw[2:2 + my, 3:3 + mx])
          - c2 * (pw[5:5 + my, 3:3 + mx] - pw[1:1 + my, 3:3 + mx])
          + c3 * (pw[6:6 + my, 3:3 + mx] - pw[0:0 + my, 3:3 + mx]))
    return fx, fy


def _mesh_force(spos, smass, origin, h, nw, grid, soft2, a, order, kernel,
                ny=None):
    """Deposit -> FFT convolution -> interpolate, one grid registration.
    Deposit and interpolation use the same assignment, so a body's own
    image exerts no force on it."""
    fx, fy = _mesh_grids_one(spos, smass, origin, h, nw, grid, order, kernel,
                             ny=ny)
    base, w = _cic_cells(spos, origin, h, nw, order, ny=ny)
    return _interp_packed(fx, fy, base, w, nw, ny=ny)


def _pm_geometry(origin, root_side, mesh_level, mesh_ny, split_cells):
    """Shared mesh geometry: (nw, ny, grid, grid_y, h, a, morigin).

    Scalars are float32 values held as Python floats, computed in the same
    float32 steps as the JAX version, so cell indices agree bit for bit.
    ``morigin`` is the world-grid origin: the root origin for a square
    mesh, shifted to centre the ``mesh_ny``-row window vertically on the
    root centre for a rectangular one.
    """
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


def pm_accel_sorted(spos, smass, salive, G, soft2, origin, root_side, *,
                    mesh_level: int, split_cells: float, band: int,
                    chunk: int, order: int = 2, interlace: bool = False,
                    rescue_k: int = 0, rescue_k_hot: int = 0,
                    mesh_ny: int = 0, deconvolve: bool = True, kernel=None,
                    heavy_cap: int = 0, switch: str = "exp4"):
    """P3M acceleration in the Hilbert-SORTED frame: (n, 2) -> (n, 2).

    The body arrays must already be in Hilbert order over the root quad
    (:func:`_hilbert_sort`); the result is in the same order. Returns
    ``(acc_sorted, (rescue_need, hot_count, mesh_oob))``, the stats as
    0-dim int32 tensors on the bodies' device. ``mesh_oob`` counts alive
    bodies outside a rectangular mesh's row window (they clamp to the edge
    rows). The band pass runs the hand-written kernel for a CUDA tensor.
    """
    if order != 2:
        _refuse(f"mesh_order={order}")
    if interlace:
        _refuse("mesh_interlace")
    if heavy_cap:
        _refuse(f"pm_heavy_cap={heavy_cap}")
    _check_switch(switch)
    dtype, dev = spos.dtype, spos.device
    nw, ny, grid, _, h, a, morigin = _pm_geometry(
        origin, root_side, mesh_level, mesh_ny, split_cells)
    smass = torch.where(salive, smass, 0.0)
    mesh_oob = torch.zeros((), dtype=torch.int32, device=dev)
    if ny != nw:
        sy = (spos[:, 1] - morigin[1]) / h
        mesh_oob = (salive & ((sy < 0.0) | (sy >= ny))).sum(dtype=torch.int32)

    if kernel is None:
        kernel = _kernel_hats(grid, h, soft2, a, dtype, dev, grid_y=2 * ny,
                              deconv_order=order if deconvolve else 0,
                              switch=switch)
    acc_mesh = _mesh_force(spos, smass, morigin, h, nw, grid, soft2, a,
                           order, kernel, ny=ny)

    acc_short = band_ops.band_short_range(spos, smass, soft2, a, band=band,
                                          chunk=chunk, switch=switch)
    rescue_need = torch.zeros((), dtype=torch.int32, device=dev)
    hot_count = torch.zeros((), dtype=torch.int32, device=dev)
    if rescue_k:
        acc_r, rescue_need, hot_count = _block_rescue(
            spos, smass, salive, soft2, a, band=band, k=rescue_k,
            chunk=chunk, k_hot=rescue_k_hot, switch=switch)
        acc_short = acc_short + acc_r

    acc = (acc_mesh + acc_short) * salive[:, None].to(dtype)
    return G * acc, (rescue_need, hot_count, mesh_oob)


def pm_accel(pos, mass, alive, G, soft2, origin, root_side, *,
             mesh_level: int, split_cells: float, band: int, chunk: int,
             order: int = 2, interlace: bool = False, rescue_k: int = 0,
             rescue_k_hot: int = 0, mesh_ny: int = 0, deconvolve: bool = True,
             return_stats: bool = False, kernel=None, heavy_cap: int = 0,
             switch: str = "exp4"):
    """P3M acceleration in the original body order, (n, 2) -> (n, 2).

    Sorts by Hilbert code, runs :func:`pm_accel_sorted` and unsorts. With
    ``return_stats`` also returns ``{"rescue_need", "rescue_hot",
    "mesh_oob"}``. Parameters as in ``tpu_nbody.ops.mesh.pm_accel``.
    """
    spos, smass, salive, unsort = _hilbert_sort(pos, mass, alive, origin,
                                                root_side)
    acc, (rescue_need, hot_count, mesh_oob) = pm_accel_sorted(
        spos, smass, salive, G, soft2, origin, root_side,
        mesh_level=mesh_level, split_cells=split_cells, band=band,
        chunk=chunk, order=order, interlace=interlace, rescue_k=rescue_k,
        rescue_k_hot=rescue_k_hot, mesh_ny=mesh_ny, deconvolve=deconvolve,
        kernel=kernel,
        heavy_cap=heavy_cap, switch=switch)
    out = acc[unsort]
    if return_stats:
        return out, {"rescue_need": rescue_need, "rescue_hot": hot_count,
                     "mesh_oob": mesh_oob}
    return out
