"""P3M (particle-mesh + short-range pair correction) force solver — port of
tpu_nbody.ops.mesh.

The softened force law F(d) = G m d / (|d|² + ε²)^{3/2}
(``BarnesHutAlg.kt:250-259``) is split as F = w·F + (1 − w)·F with a
short-range switch w (:func:`_short_weight`):

* F_long = (1 − w)·F is smooth at the split scale ``a`` and is computed on a
  mesh: mass assignment (NGP, CIC or TSC), one zero-padded FFT convolution
  with a precomputed potential kernel, a 6th-order finite-difference
  gradient, and interpolation back to the bodies with the same assignment;
  optionally averaged with a half-cell-shifted second mesh (interlace);
* F_short = w·F is summed over a block-tridiagonal band in Hilbert order
  (:mod:`tpu_nbody_torch.ops.band`, the hand-written kernel on the card)
  plus an exact block rescue for neighbours the curve puts far apart
  (:func:`_block_rescue`, one or two tiers: the partner choice
  :func:`rescue_select`, a hand-written kernel on the card, and the pair
  sum a second one, ``band.rescue_pair_sum``).

The long-range grids can also be carried across steps
(:func:`pm_mesh_state`): F_long subcycling, with the heaviest bodies kept
off the mesh and summed directly (:func:`_heavy_direct`) and the stale
self-image cancelled (:func:`_self_term`).

The FFTs go to the device's FFT library through ``torch.fft``; the
heavy-direct sum and the self-term are plain torch in this port so far.
The assignment cells and the deposit, :func:`_cic_cells`,
:func:`_deposit_packed` and both at once (:func:`deposit_cells`, the
fresh pass, whose cells the interpolation reuses), launch
``csrc/deposit.cu`` for CUDA tensors (:data:`DEPOSIT_LAUNCHES`) and run
:func:`_cic_cells_ref` and :func:`_deposit_packed_ref` for CPU tensors;
the FD gradient, :func:`_fd_gradient` and the general
:func:`fd_window`, launches ``csrc/fd.cu`` (:data:`FD_LAUNCHES`) and runs
:func:`_fd_window_ref` for CPU tensors.
The rescue's block rows and boxes, :func:`_block_boxes`, launch
``csrc/block_boxes.cu`` for CUDA tensors (:data:`BOXES_LAUNCHES`), which
also builds the selection's :class:`UnionTable` when asked, and run
:func:`_block_boxes_ref` for CPU tensors;
:func:`rescue_select` launches ``csrc/rescue_select.cu`` for CUDA tensors
and runs :func:`_rescue_select_ref` for CPU tensors;
:data:`SELECT_LAUNCHES` counts its launches, :func:`_select_plan` chooses
its launch shape and :func:`select_work` counts the work a run's data
needs of it; a caller that brings no union table gets one from
:func:`select_unions` (the same file's union kernel,
:data:`UNION_LAUNCHES`). The interpolation, :func:`_interp_packed` from
the force-grid windows and :func:`_interp_rows` from a carried table, launches
``csrc/interp.cu`` for CUDA tensors (:data:`INTERP_LAUNCHES`) and runs
:func:`_interp_packed_ref` and :func:`_interp_rows_ref` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from tpu_nbody_torch.config import f32
from tpu_nbody_torch.kernels import _build
from tpu_nbody_torch.ops import band as band_ops
from tpu_nbody_torch.ops import morton
# The switch and the block layout are shared with the band pass, which owns
# them; they keep their JAX-package names here.
from tpu_nbody_torch.ops.band import (  # noqa: F401
    SWITCHES, _block_bounds, _check_switch, _pair_sum, _short_weight)

ORDERS = (1, 2, 3)          # NGP, CIC, TSC
SELECT_LAUNCHES = 0         # csrc/rescue_select.cu, the selection
UNION_LAUNCHES = 0          # csrc/rescue_select.cu, the union table alone
INTERP_LAUNCHES = 0         # csrc/interp.cu
DEPOSIT_LAUNCHES = 0        # csrc/deposit.cu, every entry
FD_LAUNCHES = 0             # csrc/fd.cu
BOXES_LAUNCHES = 0          # csrc/block_boxes.cu
INTERP_TAPS = {1: 0, 4: 1, 9: 2}   # cells a body -> its reach past the base
# flops a body of the cells (by taps: NGP, CIC, TSC), counted from
# _cic_cells_ref: scale 4, floor 2, then the weights
CELL_FLOPS = {1: 6, 4: 16, 9: 35}
_SELECT_WARPS = 16          # warps a selection CTA, one target each; the
                            # most csrc/rescue_select.cu takes
_SELECT_GROUP = 32          # candidates behind one union box of the kernel
_BOX_TEST_FLOPS = 11        # _box_gaps of one pair of boxes
_SELECT_SLACK = 128         # keys a warp buffers beyond kh between prunes
_SELECT_SMEM = 232448       # shared memory a CTA may use (227 KB)
_SELECT_UNIONS = 4096       # union boxes a shared tile holds at most (64 KB)


def _check_order(order: int):
    if order not in ORDERS:
        raise ValueError(f"unknown mesh order {order!r}; expected one of "
                         f"{ORDERS} (1 NGP, 2 CIC, 3 TSC)")


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
                    device):
    """Precompute the (Kx̂, Kŷ, φ̂) long-range kernel FFTs on ``device``.

    They depend only on the config and ``soft2``: compute them once per
    ``step(n)`` call and pass them as ``pm_accel(..., kernel=...)``.
    ``order`` and ``deconvolve`` must match the consuming assignment.
    """
    _check_order(order)
    nw = 1 << mesh_level
    ny = mesh_ny or nw
    grid = 2 * nw
    h = f32(f32(root_side) / nw)
    a = f32(split_cells * h)
    return _kernel_hats(grid, h, soft2, a, dtype, device, grid_y=2 * ny,
                        deconv_order=order if deconvolve else 0,
                        switch=switch)


def _topk_lowest_index(score, k):
    """``torch.topk`` of float32 scores along the last dim, ties broken
    towards the lower index as ``jax.lax.top_k`` breaks them.

    The float bits, with the 31 low bits flipped for negative values,
    order like the value as int32, so the int64 key
    (bits << 32) | (n − 1 − index) has no ties.
    """
    n = score.shape[-1]
    idx = torch.arange(n - 1, -1, -1, device=score.device)
    bits = score.view(torch.int32)
    bits = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    key = (bits.to(torch.int64) << 32) | idx
    _, midx = torch.topk(key, k, dim=-1)
    return torch.gather(score, -1, midx), midx


def _box_gaps(bb, bminx, bmaxx, bminy, bmaxy):
    """Squared gaps between the boxes ``bb`` (m, 4) and every block box."""
    gx = torch.clamp(torch.maximum(bb[:, 0:1] - bmaxx[None, :],
                                   bminx[None, :] - bb[:, 1:2]), min=0.0)
    gy = torch.clamp(torch.maximum(bb[:, 2:3] - bmaxy[None, :],
                                   bminy[None, :] - bb[:, 3:4]), min=0.0)
    return gx * gx + gy * gy


def _block_boxes_ref(spos, smass, salive, band):
    """Block rows and alive-only bounding boxes of sorted bodies.

    Returns (X (B, S, 3) packed pos+mass rows, bbox (B, 4) as [minx, maxx,
    miny, maxy]); empty and padding blocks get the inverted box (+big,
    -big, +big, -big), whose gap to everything is huge, so they never
    pair."""
    cap = spos.shape[0]
    S = band
    B = -(-cap // S)
    pad = B * S - cap
    X = F.pad(torch.cat([spos, smass[:, None]], dim=1),
              (0, 0, 0, pad)).reshape(B, S, 3)
    lv = F.pad(salive, (0, pad)).reshape(B, S, 1)
    big = torch.finfo(spos.dtype).max
    lo = torch.where(lv, X[..., :2], big).amin(dim=1)          # (B, 2)
    hi = torch.where(lv, X[..., :2], -big).amax(dim=1)
    return X, torch.stack([lo, hi], dim=2).reshape(B, 4)


class UnionTable:
    """The selection's table of union boxes: ``boxes`` (ceil(C / 32), 4),
    the union of each :data:`_SELECT_GROUP` consecutive candidate boxes
    (:func:`_union_boxes`), and ``stats`` (4,) int32, the counters of the
    one :func:`rescue_select` call that reads the table (need, hot and the
    64-bit near-group count), zeroed by the kernel that built it. A table
    serves one selection, since the selection adds its counts into
    ``stats``: the selection takes it (:meth:`take`), and a second
    selection with the same table raises."""
    __slots__ = ("boxes", "stats", "used")

    def __init__(self, boxes: torch.Tensor, stats: torch.Tensor):
        self.boxes, self.stats, self.used = boxes, stats, False

    def take(self) -> "UnionTable":
        """Mark the table as read by a selection; raise if one read it."""
        if self.used:
            raise ValueError("this UnionTable has served a selection, whose "
                             "counts its stats hold; build a new table")
        self.used = True
        return self


def _plain_unions(cbox) -> UnionTable:
    return UnionTable(_union_boxes(cbox),
                      torch.zeros((4,), dtype=torch.int32,
                                  device=cbox.device))


def _block_boxes(spos, smass, salive, band, unions=False):
    """Block rows and boxes (:func:`_block_boxes_ref`), and with
    ``unions`` also the selection's :class:`UnionTable` of the boxes. CPU
    tensors take the plain versions; CUDA tensors launch
    ``csrc/block_boxes.cu`` once (:data:`BOXES_LAUNCHES`), which reads the
    bodies once and writes the same bits, the unions and the zeroed stats
    included."""
    global BOXES_LAUNCHES
    if all(t.device.type == "cpu" for t in (spos, smass, salive)):
        X, bbox = _block_boxes_ref(spos, smass, salive, band)
        return (X, bbox, _plain_unions(bbox)) if unions else (X, bbox)
    cap = spos.shape[0]
    S = band
    if not 1 <= S <= band_ops.MAX_BAND:
        raise ValueError(f"band {S} outside [1, {band_ops.MAX_BAND}]")
    spos, smass, salive = (t.contiguous() for t in (spos, smass, salive))
    dev = spos.device
    _build.check_tensor("spos", spos, (cap, 2), align=8)
    _build.check_tensor("smass", smass, (cap,), device=dev)
    _build.check_tensor("salive", salive, (cap,), device=dev,
                        dtype=torch.bool)
    B = -(-cap // S)
    X = torch.empty((B, S, 3), dtype=spos.dtype, device=dev)
    bbox = torch.empty((B, 4), dtype=spos.dtype, device=dev)
    table = None
    if unions:
        table = UnionTable(
            torch.empty((-(-B // _SELECT_GROUP), 4), dtype=spos.dtype,
                        device=dev),
            torch.empty((4,), dtype=torch.int32, device=dev))
    if B == 0:
        if unions:
            table.stats.zero_()
        return (X, bbox, table) if unions else (X, bbox)
    rc = _build.library().tnt_block_boxes(
        spos.data_ptr(), smass.data_ptr(), salive.data_ptr(), X.data_ptr(),
        bbox.data_ptr(), None if table is None else table.boxes.data_ptr(),
        None if table is None else table.stats.data_ptr(), cap, S,
        _build.stream(dev))
    _build.check_launch("block_boxes", rc)
    with band_ops._COUNT_LOCK:
        BOXES_LAUNCHES += 1
    return (X, bbox, table) if unions else (X, bbox)


def block_boxes_work(cap: int, S: int, unions: bool = False) -> dict:
    """Bytes of one :func:`_block_boxes`: positions, masses and alive
    flags read once, the zero-padded (B, S, 3) rows and (B, 4) boxes
    written once, and with ``unions`` the (ceil(B / 32), 4) union boxes
    and the 16 bytes of zeroed stats; no arithmetic but compares."""
    B = -(-cap // S)
    extra = 16 * -(-B // _SELECT_GROUP) + 16 if unions else 0
    return dict(flops=0, bytes=cap * 13 + B * S * 12 + B * 16 + extra)


def _rcut2(a):
    """The rescue's squared cutoff (2a)², in Python double as the JAX
    package writes it; torch compares and subtracts it as float32."""
    return (2.0 * a) * (2.0 * a)


class Selection(NamedTuple):
    """What :func:`rescue_select` returns for M targets."""
    mval: torch.Tensor       # (M, kh) scores, highest first; > 0 if wanted
    midx: torch.Tensor       # (M, kh) int64 candidate indices
    cnt: torch.Tensor        # (M,) int32 candidates each target wanted
    need: torch.Tensor       # () int32 max cnt
    hot: torch.Tensor        # () int32 targets with cnt > k
    groups: torch.Tensor | None = None  # () int64 near groups, if counted


class SelectPlan(NamedTuple):
    """Launch shape of ``csrc/rescue_select.cu``: ``warps`` a CTA, a
    shared tile of the union boxes of ``tile`` candidates (tile / 32
    boxes), ``bufcap`` buffered keys a warp (0: the best keys in
    registers); ``smem`` bytes of shared memory (:func:`_plan_smem`)."""
    warps: int
    tile: int
    bufcap: int
    smem: int


_SELECT_REGS = 32           # kh up to this keeps the best keys in registers


def _plan_smem(warps: int, tile: int, bufcap: int, kh: int) -> int:
    """Shared bytes of a selection CTA: its 32-byte head (counters and the
    union of its targets), the union boxes of a tile of ``tile``
    candidates and their near list (an int each, rounded up to 8 bytes)
    and, with ``bufcap`` > 0, each warp's key buffer and sort space."""
    kp = -(-kh // 32) * 32
    ut = tile // _SELECT_GROUP
    return (32 + 16 * ut + 8 * ((ut + 1) // 2)
            + (8 * warps * (bufcap + kp) if bufcap else 0))


@functools.lru_cache(maxsize=None)
def _select_plan(C: int, kh: int) -> SelectPlan:
    """The selection kernel's launch shape for ``C`` candidates and ``kh``
    partner slots. Up to :data:`_SELECT_REGS` slots a warp keeps its best
    keys in registers (``bufcap`` 0); past that it buffers kh rounded up
    to 32 keys plus :data:`_SELECT_SLACK` in shared memory and sorts into
    as many again, and the :data:`_SELECT_WARPS` warps a CTA are cut so
    the buffers take at most half of it. The union boxes take the rest, up
    to :data:`_SELECT_UNIONS` of them, those of all ``C`` candidates (one
    tile) where they fit; the candidate boxes stay in global memory."""
    if kh < 0 or C < 1:
        raise ValueError(f"a selection needs C >= 1 candidates and kh >= 0 "
                         f"slots, got C={C}, kh={kh}")
    kp = -(-kh // 32) * 32
    bufcap = 0 if kh <= _SELECT_REGS else kp + _SELECT_SLACK
    per_warp = 8 * (bufcap + kp) if bufcap else 0
    warps = max(1, min(_SELECT_WARPS, (_SELECT_SMEM // 2) // per_warp
                       if per_warp else _SELECT_WARPS))
    room = _SELECT_SMEM - 32 - 8 - warps * per_warp
    fit = min(room // 20, _SELECT_UNIONS) * _SELECT_GROUP
    if fit < _SELECT_GROUP:
        raise ValueError(f"kh={kh} partner slots leave no room for the "
                         f"union table in shared memory")
    tile = min(-(-C // 32) * 32, fit)
    return SelectPlan(warps=warps, tile=tile, bufcap=bufcap,
                      smem=_plan_smem(warps, tile, bufcap, kh))


@functools.lru_cache(maxsize=None)
def _select_capacity(device_index: int, warps: int, smem: int) -> int:
    """CTAs of ``warps`` warps and ``smem`` bytes the card holds at once,
    asked of the CUDA occupancy API once a (device, plan); the same call
    lifts the kernel's shared-memory limit on that device."""
    with torch.cuda.device(device_index):
        per_sm = _build.library().tnt_rescue_select_blocks_per_sm(
            32 * warps, smem)
        n_sm = torch.cuda.get_device_properties(
            device_index).multi_processor_count
    if per_sm < 1:
        raise RuntimeError(f"rescue_select: no CTA of {warps} warps and "
                           f"{smem} bytes fits an SM")
    return n_sm * per_sm


def _union_boxes(cbox):
    """The union box of each :data:`_SELECT_GROUP` consecutive candidate
    boxes of ``cbox`` (C, 4), the last group padded with the inverted
    infinite box, as the selection's kernels build them: a coordinate is
    NaN where any member's is (``amin`` and ``amax`` propagate NaN)."""
    C = cbox.shape[0]
    pad = -C % _SELECT_GROUP
    inf = math.inf
    fill = torch.tensor([inf, -inf, inf, -inf], dtype=cbox.dtype,
                        device=cbox.device).expand(pad, 4)
    g = torch.cat([cbox, fill]).reshape(-1, _SELECT_GROUP, 4)
    return torch.stack([g[..., 0].amin(1), g[..., 1].amax(1),
                        g[..., 2].amin(1), g[..., 3].amax(1)], dim=1)


def select_work(M: int, C: int, kh: int, groups: int, *,
                boxes=None) -> dict:
    """Flops and bytes of one selection of ``M`` targets among ``C``
    candidates that this run's data needs: the box test (11 flops) of each
    of the :data:`_SELECT_GROUP` members of the ``groups`` (target, group)
    pairs whose union box is near (the kernel's counter,
    :func:`rescue_select` with ``count_groups``); the ``boxes`` distinct
    boxes read (default M + C; M where the targets are the candidates),
    and the kh scores and indices and the count of each target written.
    The union tests that find the near groups are not counted: how many a
    design makes is its own (a CTA's targets against every union box, then
    each target against its CTA's list), so the bound holds for any design
    that tests the near groups member by member."""
    boxes = M + C if boxes is None else boxes
    return dict(flops=_BOX_TEST_FLOPS * _SELECT_GROUP * groups,
                bytes=16 * boxes + M * (12 * kh + 4) + 8)


def _rescue_select_ref(tbox, cbox, rcut2, kh, *, k=None, tgid0=0,
                       cgid=None, cvalid=None, chunk=None,
                       count_groups=False) -> Selection:
    """Plain torch selection: for each target box of ``tbox`` (M, 4), the
    squared gap to every candidate box of ``cbox`` (C, 4), masked by
    g2 < rcut2, |gid_t − gid_j| > 1 (gid_t = tgid0 + t, gid_j = ``cgid[j]``
    or j) and ``cvalid``; the ``kh`` highest scores rcut2 − g2 (0 where
    masked out), ties to the lower index as ``jax.lax.top_k``; the counts,
    their max and the number above ``k`` (default kh). ``chunk`` targets
    at a time (default all) bound the (chunk, C) temporaries; the rows are
    independent, so it changes no bit. ``count_groups``: also the
    (target, group of 32 candidates) pairs whose union box passes the
    kernel's skip test, what the kernel's counter counts."""
    M, C = tbox.shape[0], cbox.shape[0]
    dev = tbox.device
    k = kh if k is None else k
    chunk = chunk or M
    cg = torch.arange(C, device=dev) if cgid is None else cgid
    tg = tgid0 + torch.arange(M, device=dev)
    boxes = cbox.unbind(1)
    unions = _union_boxes(cbox).unbind(1) if count_groups else None
    vals, idxs, cnts = [], [], []
    groups = torch.zeros((), dtype=torch.int64, device=dev)
    for r0 in range(0, M, chunk):
        if count_groups:
            g2u = _box_gaps(tbox[r0:r0 + chunk], *unions)
            groups += (~(g2u >= rcut2)).sum()
        g2 = _box_gaps(tbox[r0:r0 + chunk], *boxes)              # (m, C)
        mask = (g2 < rcut2) & ((tg[r0:r0 + chunk, None]
                                - cg[None, :]).abs() > 1)
        if cvalid is not None:
            mask = mask & cvalid[None, :]
        cnts.append(mask.sum(dim=1, dtype=torch.int32))        # exact needs
        score = torch.where(mask, rcut2 - g2, 0.0)
        mval, midx = _topk_lowest_index(score, kh)               # (m, kh)
        vals.append(mval)
        idxs.append(midx)
    cnt = torch.cat(cnts)
    return Selection(mval=torch.cat(vals), midx=torch.cat(idxs), cnt=cnt,
                     need=cnt.max(), hot=(cnt > k).sum(dtype=torch.int32),
                     groups=groups if count_groups else None)


def select_unions(cbox) -> UnionTable:
    """The :class:`UnionTable` of the candidate boxes ``cbox`` (C, 4), its
    stats zeroed. CPU tensors take :func:`_union_boxes`; CUDA tensors
    launch ``csrc/rescue_select.cu``'s union kernel once
    (:data:`UNION_LAUNCHES`), the same bits."""
    global UNION_LAUNCHES
    if cbox.device.type == "cpu":
        return _plain_unions(cbox)
    C = cbox.shape[0]
    dev = cbox.device
    _build.check_tensor("cbox", cbox, (C, 4), align=16)
    table = UnionTable(
        torch.empty((-(-C // _SELECT_GROUP), 4), dtype=cbox.dtype,
                    device=dev),
        torch.empty((4,), dtype=torch.int32, device=dev))
    rc = _build.library().tnt_select_unions(
        cbox.data_ptr(), table.boxes.data_ptr(), table.stats.data_ptr(), C,
        _build.stream(dev))
    _build.check_launch("select_unions", rc)
    with band_ops._COUNT_LOCK:
        UNION_LAUNCHES += 1
    return table


def rescue_select(tbox, cbox, rcut2, kh, *, k=None, tgid0=0, cgid=None,
                  cvalid=None, chunk=None, count_groups=False,
                  unions: UnionTable | None = None) -> Selection:
    """The rescue's partner selection (:func:`_rescue_select_ref`). CPU
    tensors take the plain version, chunked by ``chunk`` (``unions`` is
    taken but not read); CUDA tensors launch ``csrc/rescue_select.cu`` once, which needs
    no chunks and keeps ``need`` and ``hot`` on the device. ``unions`` is
    the :class:`UnionTable` of ``cbox`` made for this call (by
    :func:`_block_boxes` or :func:`select_unions`); without one the
    wrapper makes it with :func:`select_unions` first. ``cgid`` holds
    int64 ids, ``cvalid`` bools; ``kh`` is at most C. ``count_groups``
    fills ``groups``, the near groups the kernel tests in full (its
    counter on the card)."""
    given = [t for t in (tbox, cbox, cgid, cvalid) if t is not None]
    if all(t.device.type == "cpu" for t in given):
        if unions is not None:
            unions.take()
        return _rescue_select_ref(tbox, cbox, rcut2, kh, k=k, tgid0=tgid0,
                                  cgid=cgid, cvalid=cvalid, chunk=chunk,
                                  count_groups=count_groups)
    M, C = tbox.shape[0], cbox.shape[0]
    dev = tbox.device
    _build.check_tensor("tbox", tbox, (M, 4), align=16)
    _build.check_tensor("cbox", cbox, (C, 4), device=dev, align=16)
    if cgid is not None:
        _build.check_tensor("cgid", cgid, (C,), device=dev, dtype=torch.int64)
    if cvalid is not None:
        _build.check_tensor("cvalid", cvalid, (C,), device=dev,
                            dtype=torch.bool)
    if not 0 <= kh <= C:
        raise ValueError(f"kh={kh} partner slots for {C} candidates")
    k = kh if k is None else k
    if C == 0:                  # no candidate: nothing to launch
        if unions is not None:
            unions.take()
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return Selection(
            mval=torch.zeros((M, kh), dtype=tbox.dtype, device=dev),
            midx=torch.zeros((M, kh), dtype=torch.int64, device=dev),
            cnt=torch.zeros((M,), dtype=torch.int32, device=dev),
            need=zero, hot=zero.clone(),
            groups=(torch.zeros((), dtype=torch.int64, device=dev)
                    if count_groups else None))
    return _select_launch(tbox, cbox, rcut2, kh, k, tgid0, cgid, cvalid,
                          _select_plan(C, kh), count_groups, unions)


def _select_launch(tbox, cbox, rcut2, kh, k, tgid0, cgid, cvalid,
                   plan: SelectPlan, count_groups=False,
                   unions: UnionTable | None = None) -> Selection:
    """Launch the selection kernel with ``plan`` on checked arguments,
    with the union table ``unions`` (made here when None; taken, so it
    serves no other selection)."""
    global SELECT_LAUNCHES
    M, C = tbox.shape[0], cbox.shape[0]
    dev = tbox.device
    if unions is None:
        unions = select_unions(cbox)
    else:
        _build.check_tensor("unions.boxes", unions.boxes,
                            (-(-C // _SELECT_GROUP), 4), device=dev,
                            align=16)
        _build.check_tensor("unions.stats", unions.stats, (4,), device=dev,
                            align=8, dtype=torch.int32)
        unions.take()
    mval = torch.empty((M, kh), dtype=tbox.dtype, device=dev)
    midx = torch.empty((M, kh), dtype=torch.int64, device=dev)
    cnt = torch.empty((M,), dtype=torch.int32, device=dev)
    grid = min(-(-M // plan.warps),
               _select_capacity(dev.index, plan.warps, plan.smem))
    stats = unions.stats
    rc = _build.library().tnt_rescue_select(
        tbox.data_ptr(), cbox.data_ptr(), unions.boxes.data_ptr(),
        None if cgid is None else cgid.data_ptr(),
        None if cvalid is None else cvalid.data_ptr(),
        mval.data_ptr(), midx.data_ptr(), cnt.data_ptr(), stats.data_ptr(),
        int(count_groups), tgid0, M, C, kh, k, ctypes.c_float(float(rcut2)),
        plan.warps, plan.tile, plan.bufcap, plan.smem, grid,
        _build.stream(dev))
    _build.check_launch("rescue_select", rc)
    with band_ops._COUNT_LOCK:
        SELECT_LAUNCHES += 1
    return Selection(mval=mval, midx=midx, cnt=cnt, need=stats[0],
                     hot=stats[1],
                     groups=(stats[2:].view(torch.int64)[0] if count_groups
                             else None))


class RescueSelection(NamedTuple):
    """Both tiers' partner choice of :func:`_rescue_select`."""
    rows: torch.Tensor       # (B, 3S) block rows
    bbox: torch.Tensor       # (B, 4) block boxes, inverted where empty
    midx: torch.Tensor       # (B, k) partner blocks, closest first
    mval: torch.Tensor       # (B, k) their scores; > 0 where wanted
    hot_midx: torch.Tensor   # (B, kh - k) ranks k..kh-1 of the same ranking
    hot_mval: torch.Tensor   # (B, kh - k)
    cnt: torch.Tensor        # (B,) partner blocks each block wanted
    need: torch.Tensor       # () max cnt
    hot: torch.Tensor        # () blocks with cnt > k
    k: int                   # partner slots, min(k, B)
    cb: int                  # blocks a chunk of the plain versions
    groups: torch.Tensor | None = None  # near groups, if counted


def _rescue_select(spos, smass, salive, a, *, band: int, k: int,
                   chunk: int, k_hot: int = 0,
                   count_groups: bool = False) -> RescueSelection:
    """The rescue's selection, everything but the pair sum: alive-only
    block boxes with their union table (one launch on the card), then one
    :func:`rescue_select` of every block against
    every block with the cutoff 2a: the kh = max(k, min(k_hot, B)) closest
    partner blocks more than one block away, closest first (ties towards
    the lower index as in JAX), and the exact partner counts. Ranks
    0..k-1 are the base tier, ranks k..kh-1 the hot tier's, so both tiers
    come from one ranking and one launch. ``count_groups``: also the
    selection's near groups (:func:`rescue_select`)."""
    cap = spos.shape[0]
    S = band
    B, cb, _ = _block_bounds(cap, S, chunk)
    X, bbox, table = _block_boxes(spos, smass, salive, band, unions=True)
    k = min(k, B)
    kh = max(k, min(k_hot, B))
    sel = rescue_select(bbox, bbox, _rcut2(a), kh, k=k, chunk=cb,
                        count_groups=count_groups, unions=table)
    return RescueSelection(
        rows=X.reshape(B, S * 3), bbox=bbox,
        midx=sel.midx[:, :k], mval=sel.mval[:, :k],
        hot_midx=sel.midx[:, k:], hot_mval=sel.mval[:, k:], cnt=sel.cnt,
        need=sel.need, hot=sel.hot, k=k, cb=cb, groups=sel.groups)


def _block_rescue(spos, smass, salive, soft2, a, *, band: int, k: int,
                  chunk: int, k_hot: int = 0, hot_cap: int = 128,
                  switch: str = "exp4"):
    """Exact short-range rescue for pairs more than one block apart in
    sorted order.

    Per band block: the ``k`` closest partner blocks more than one block
    away (:func:`_rescue_select`, through :func:`rescue_select`: the
    selection kernel on the card; closest box first, so an overflow drops
    the farthest, weakest pairs), then one switched pair sum over them
    (:func:`band_ops.rescue_pair_sum`: the rescue kernel on the card, the
    dense (cb, S, kS) plain version a chunk of cb blocks at a time on the
    CPU). Returns ``(acc_sorted (cap, 2), need, hot_count)``: ``need`` is
    the largest partner count any block wanted (coverage is exact iff need
    <= k), ``hot_count`` the number of blocks that wanted more than ``k``.

    Two tiers (``k_hot > k``): the at most ``hot_cap`` hot blocks (need >
    ``k``), found in block order by a rank search, also sum their partner
    ranks ``k..k_hot-1`` of the same closest-first ranking, added into
    their rows with ``index_add_``; hot blocks past ``hot_cap`` stay at the
    base tier. See the JAX version for the measurements behind the design.
    """
    _check_switch(switch)
    cap = spos.shape[0]
    S = band
    dev = spos.device
    sel = _rescue_select(spos, smass, salive, a, band=band, k=k, chunk=chunk,
                         k_hot=k_hot)
    rows, k, cnt_all = sel.rows, sel.k, sel.cnt
    B = cnt_all.shape[0]
    tid = torch.arange(B, device=dev)
    acc = band_ops.rescue_pair_sum(rows, tid, rows, sel.midx, sel.mval > 0,
                                   soft2, a, switch, chunk=sel.cb)
    acc = acc.reshape(-1, 2)

    if k_hot > k:
        H = min(hot_cap, B)
        hrank = torch.cumsum((cnt_all > k).to(torch.int64), 0)  # 1-indexed
        hid = torch.clamp(torch.searchsorted(
            hrank, torch.arange(1, H + 1, device=dev), side="left"),
            0, B - 1)
        hvalid = torch.arange(H, device=dev) < torch.clamp(sel.hot, max=H)
        # ranks k..kh-1; an invalid row (hid clamped to B - 1) sums nothing
        acc2 = band_ops.rescue_pair_sum(
            rows, hid, rows, sel.hot_midx[hid],
            (sel.hot_mval[hid] > 0) & hvalid[:, None],
            soft2, a, switch)                                 # (H, S, 2)
        rows_h = (hid[:, None] * S
                  + torch.arange(S, device=dev)[None, :]).reshape(-1)
        acc.index_add_(0, rows_h, torch.where(hvalid[:, None, None], acc2,
                                              0.0).reshape(-1, 2))
    return acc[:cap], sel.need, sel.hot


def _cic_cells(spos, origin, h, nw, order, ny=None):
    """Base world cell (row-major, clipped, int32) and the per-offset
    weights of :func:`_cic_cells_ref`. CPU tensors take the plain version;
    CUDA tensors launch ``csrc/deposit.cu``'s cells entry, the same
    bits."""
    if spos.device.type == "cpu":
        return _cic_cells_ref(spos, origin, h, nw, order, ny=ny)
    _, base, w = _deposit_launch(spos, None, origin, h, nw, order, ny)
    return base, w


def _cic_cells_ref(spos, origin, h, nw, order, ny=None):
    """Base world cell (row-major, clipped) and the per-offset weights.

    Order 2 (CIC): weights (n, 4) for offsets [(0,0), (+x,0), (0,+y),
    (+x,+y)] in cell-centre coordinates. Order 1 (NGP): weights (n, 1) for
    the containing cell. Order 3 (TSC): weights (n, 9) for the 3x3 window
    around the containing cell in the offset order k = 3·oy + ox, the base
    at its low corner; per axis [(0.5−d)²/2, 0.75−d², (0.5+d)²/2] at the
    offset d of the body from the containing cell's centre.

    The base is clipped to [0, n-1] per axis (nw columns, ``ny`` or nw
    rows); positive offsets reach row/column n (n+1 for TSC), the first
    padded rows/columns of the FFT domain. ``h`` divides as a 0-dim
    tensor on the bodies' device: torch on the card multiplies by the
    reciprocal of a Python-scalar divisor, which can differ from the
    division in the last bit.
    """
    _check_order(order)
    dtype = spos.dtype
    ny = nw if ny is None else ny
    org = torch.as_tensor(origin, dtype=dtype, device=spos.device)
    scaled = (spos - org) / torch.tensor(h, dtype=dtype, device=spos.device)
    if order == 1:
        c = torch.floor(scaled).to(torch.int32)
        cx = torch.clamp(c[:, 0], 0, nw - 1)
        cy = torch.clamp(c[:, 1], 0, ny - 1)
        return cy * nw + cx, torch.ones((spos.shape[0], 1), dtype=dtype,
                                        device=spos.device)
    if order == 3:
        c = torch.floor(scaled).to(torch.int32)       # containing cell
        d = (scaled - c.to(dtype)) - 0.5              # in [-0.5, 0.5)
        bx = torch.clamp(c[:, 0] - 1, 0, nw - 1)
        by = torch.clamp(c[:, 1] - 1, 0, ny - 1)

        def w3(di):
            return torch.stack([0.5 * (0.5 - di) ** 2, 0.75 - di * di,
                                0.5 * (0.5 + di) ** 2], dim=1)   # (n, 3)

        wx, wy = w3(d[:, 0]), w3(d[:, 1])
        return by * nw + bx, (wy[:, :, None] * wx[:, None, :]).reshape(-1, 9)
    u = scaled - 0.5                   # in cell-CENTER coordinates
    b = torch.floor(u).to(torch.int32)
    frac = u - b.to(dtype)             # in [0, 1)
    bx = torch.clamp(b[:, 0], 0, nw - 1)
    by = torch.clamp(b[:, 1], 0, ny - 1)
    wx1, wy1 = frac[:, 0], frac[:, 1]
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    w4 = torch.stack([wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1], dim=1)
    return by * nw + bx, w4


def _compressed_planes(base, first, contrib, cells):
    """Scatter each run's sum ``contrib`` (K, n), kept where ``first`` is
    set, into K planes of ``cells``; the other rows go to a dump cell."""
    tgt = torch.where(first, base, cells)
    vals_f = torch.where(first[None, :], contrib, 0.0)
    return [torch.zeros((cells + 1,), dtype=contrib.dtype,
                        device=contrib.device)
            .index_add_(0, tgt, v)[:cells] for v in vals_f]


def _deposit_packed(smass, base, w, nw, grid, run_compress=False,
                    ny=None, grid_y=None):
    """Mass deposit into the padded (grid_y, grid) FFT grid from the base
    cells and weights (:func:`_deposit_packed_ref`). CPU tensors take the
    plain version; CUDA tensors launch ``csrc/deposit.cu``'s entry from
    given cells in every ``run_compress`` mode (the modes differ only in
    the order of the sums, which the kernel's atomics choose anyway; a
    window must still divide the bodies), which zeroes the whole grid (a
    memset) and adds into it."""
    if smass.device.type == "cpu":
        return _deposit_packed_ref(smass, base, w, nw, grid,
                                   run_compress=run_compress, ny=ny,
                                   grid_y=grid_y)
    global DEPOSIT_LAUNCHES
    n, K = w.shape
    dev = smass.device
    if int(run_compress) > 1 and n % int(run_compress):
        raise ValueError(f"run_compress window {int(run_compress)} does "
                         f"not divide the {n} bodies")
    if K not in INTERP_TAPS:
        raise ValueError(f"_deposit_packed: {K} weights a body, expected "
                         f"1, 4 or 9")
    if base.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"base: expected int32 or int64, got {base.dtype}")
    _build.check_tensor("smass", smass, (n,))
    _build.check_tensor("base", base, (n,), device=dev, dtype=base.dtype)
    _build.check_tensor("w", w, (n, K), device=dev)
    grid_y = grid if grid_y is None else grid_y
    rho = _grid_block(nw, grid, ny, grid_y, grid_y, INTERP_TAPS[K],
                      smass.dtype, dev)
    rc = _build.library().tnt_deposit_given(
        smass.data_ptr(), base.data_ptr(), int(base.dtype == torch.int64),
        w.data_ptr(), rho.data_ptr(), n, K, nw, grid, grid_y,
        _build.stream(dev))
    _build.check_launch("deposit_given", rc)
    with band_ops._COUNT_LOCK:
        DEPOSIT_LAUNCHES += 1
    return rho


def occ_rows(ny: int, order: int) -> int:
    """Rows of the padded grid that hold mass and that the FFT reads
    (:func:`_conv_potential`; the sharded slab FFT pads them to its
    shards): the mesh's ny, the CIC reach and a zero row, and TSC's longer
    reach. The one place that says which rows a deposit's block holds."""
    return ny + 2 + (1 if order == 3 else 0)


def deposit_cells(spos, smass, origin, h, nw, grid, order, ny=None,
                  grid_y=None, rows=None):
    """The fresh pass's assignment and deposit at once: ``(rho, base,
    w)``, rho the leading ``rows`` rows (default :func:`occ_rows`, those
    the FFT reads) of the padded (grid_y, grid) grid of
    :func:`_deposit_packed`, and the cells of :func:`_cic_cells`, which
    the interpolation reuses. No row past ``rows`` ever holds mass or is
    read. CPU tensors take the two plain versions and return the plain
    grid's leading rows; CUDA tensors zero the (rows, grid) block (a
    memset) and launch ``csrc/deposit.cu`` once, which writes the cells
    and adds each body's K products into the block, a warp's bodies of
    one cell summed before their atomics: no row past ``rows`` is
    written."""
    ny = nw if ny is None else ny
    rows = occ_rows(ny, order) if rows is None else rows
    if spos.device.type == "cpu":
        base, w = _cic_cells_ref(spos, origin, h, nw, order, ny=ny)
        grid_y = grid if grid_y is None else grid_y
        _grid_block(nw, grid, ny, grid_y, rows, INTERP_TAPS[w.shape[1]],
                    spos.dtype, None)
        return (_deposit_packed_ref(smass, base, w, nw, grid, ny=ny,
                                    grid_y=grid_y)[:rows], base, w)
    return _deposit_launch(spos, smass, origin, h, nw, order, ny, grid,
                           grid_y, rows)


def _grid_block(nw, grid, ny, grid_y, rows, reach, dtype, dev):
    """The leading ``rows`` rows of the padded (grid_y, grid) grid, left
    for the launch to zero (``dev`` None: checked only), checked to hold
    the (ny + reach + 1, nw + reach + 1) cells a deposit reaches."""
    ny = nw if ny is None else ny
    grid_y = grid if grid_y is None else grid_y
    if rows > grid_y:
        raise ValueError(f"a block of {rows} rows of a ({grid_y}, {grid}) "
                         f"grid: more rows than the grid has")
    if rows < ny + reach + 1 or grid < nw + reach + 1:
        raise ValueError(f"a ({rows}, {grid}) block of a ({grid_y}, "
                         f"{grid}) grid is too small for a ({ny}, {nw}) "
                         f"mesh at reach {reach}")
    if dev is None:
        return None
    return torch.empty((rows, grid), dtype=dtype, device=dev)


def _deposit_launch(spos, smass, origin, h, nw, order, ny, grid=None,
                    grid_y=None, rows=None):
    """Launch ``csrc/deposit.cu``'s cells entry: ``(rho, base, w)``, rho
    the zeroed and filled (rows, grid) block, None without ``smass``
    (cells only)."""
    global DEPOSIT_LAUNCHES
    _check_order(order)
    n = spos.shape[0]
    dev = spos.device
    K = {1: 1, 2: 4, 3: 9}[order]
    ny = nw if ny is None else ny
    _build.check_tensor("spos", spos, (n, 2), align=8)
    rho = None
    if smass is not None:
        _build.check_tensor("smass", smass, (n,), device=dev)
        rows = occ_rows(ny, order) if rows is None else rows
        rho = _grid_block(nw, grid, ny, grid_y, rows, INTERP_TAPS[K],
                          spos.dtype, dev)
    base = torch.empty((n,), dtype=torch.int32, device=dev)
    w = torch.empty((n, K), dtype=spos.dtype, device=dev)
    ox, oy = (float(o) for o in origin)
    rc = _build.library().tnt_deposit_cells(
        spos.data_ptr(), None if rho is None else smass.data_ptr(),
        base.data_ptr(), w.data_ptr(), None if rho is None else rho.data_ptr(),
        n, order, ctypes.c_float(ox), ctypes.c_float(oy),
        ctypes.c_float(float(h)), nw, ny, 0 if grid is None else grid,
        0 if rho is None else rows, _build.stream(dev))
    _build.check_launch("deposit_cells", rc)
    with band_ops._COUNT_LOCK:
        DEPOSIT_LAUNCHES += 1
    return rho, base, w


def deposit_work(n: int, K: int, block_cells: int) -> dict:
    """Flops and bytes of ``n`` bodies through the cells-and-deposit
    entry of ``csrc/deposit.cu`` (:func:`deposit_cells`) with ``K`` taps:
    positions and masses read, the base cell and K weights written,
    :data:`CELL_FLOPS` and K products and adds a body, and the
    ``block_cells`` floats of the block the pass writes (its zeros
    included: at the fresh pass the :func:`occ_rows` rows times the grid's
    width) written once."""
    return dict(flops=(CELL_FLOPS[K] + 2 * K) * n,
                bytes=n * (8 + 4) + n * (4 + 4 * K) + 4 * block_cells)


def fd_work(rows: int, cols: int) -> dict:
    """Flops and bytes of one FD gradient into (rows, cols) windows
    (:func:`fd_window`): 16 flops a cell, the rows + 6 source rows read
    once at the cols + 6 columns the stencil touches, fx and fy written
    once."""
    return dict(flops=16 * rows * cols,
                bytes=4 * (rows + 6) * (cols + 6) + 2 * 4 * rows * cols)


def _deposit_packed_ref(smass, base, w, nw, grid, run_compress=False,
                        ny=None, grid_y=None):
    """Mass deposit: K independent plane scatter-adds (one per assignment
    offset, all at the shared base cell; K = 1, 4 or 9), then a pad-shift
    combine into the padded (grid_y, grid) FFT grid.

    ``run_compress`` (bodies in Hilbert order, so same-cell bodies form
    runs of equal ``base``) pre-sums runs before the scatter:

    * ``True`` / ``1``: exact run sums. Torch has no associative scan, so
      this is a segment sum by run id (``index_add_`` of each body into its
      run's slot), gathered back to each run's first body;
    * integer ``W > 1``: same-cell bodies are pre-summed within fixed
      W-slot windows by dense compares (no scan); the body count must be a
      multiple of W.

    ``index_add_`` uses atomics on the card, so the per-cell summation
    order changes from run to run there. Every mode is exact up to that
    order.
    """
    dtype = smass.dtype
    ny = nw if ny is None else ny
    grid_y = grid if grid_y is None else grid_y
    n, K = w.shape
    cells = ny * nw
    vals = (smass[:, None] * w).T                             # (K, n)
    if run_compress and int(run_compress) > 1:
        W = int(run_compress)
        if n % W:
            raise ValueError(f"run_compress window {W} does not divide the "
                             f"{n} bodies")
        bw = base.reshape(n // W, W)
        eq = bw[:, :, None] == bw[:, None, :]                 # (nb, W, W)
        jj = torch.arange(W, device=base.device)
        upper = jj[:, None] <= jj[None, :]                    # k >= j
        first = ~torch.any(eq & ~upper, dim=2)                # no earlier eq
        take = eq & upper                                     # (nb, W, W)
        vw = vals.reshape(K, n // W, 1, W)
        contrib = torch.where(take[None], vw, 0.0).sum(dim=3).reshape(K, n)
        planes = _compressed_planes(base, first.reshape(n), contrib, cells)
    elif run_compress:
        first = torch.ones((n,), dtype=torch.bool, device=base.device)
        first[1:] = base[1:] != base[:-1]
        run = torch.cumsum(first.to(torch.int64), 0) - 1      # run id
        runsum = torch.zeros_like(vals).index_add_(1, run, vals)
        planes = _compressed_planes(base, first, runsum[:, run], cells)
    else:
        planes = [torch.zeros((cells,), dtype=dtype, device=smass.device)
                  .index_add_(0, base, vals[k]) for k in range(K)]
    planes = [p.reshape(ny, nw) for p in planes]
    # F.pad pads the last dim first: (left, right, top, bottom)
    if K == 1:
        world = F.pad(planes[0], (0, 1, 0, 1))
    elif K == 9:
        # TSC: 3x3 offsets from the base (low corner), canvas (ny+2, nw+2)
        world = sum(F.pad(planes[3 * oy + ox], (ox, 2 - ox, oy, 2 - oy))
                    for oy in range(3) for ox in range(3))
    else:
        world = (F.pad(planes[0], (0, 1, 0, 1))
                 + F.pad(planes[1], (1, 0, 0, 1))
                 + F.pad(planes[2], (0, 1, 1, 0))
                 + F.pad(planes[3], (1, 0, 1, 0)))
    rho = torch.zeros((grid_y, grid), dtype=dtype, device=smass.device)
    rho[:world.shape[0], :world.shape[1]] = world
    return rho


def _interp_table(fx, fy, nw, order, ny=None):
    """Pack the (fx, fy) values of every cell a body of the given
    assignment order touches into one (ny*nw, 2K) row per base cell
    (K = 1 NGP, 4 CIC, 9 TSC), so each body fetches one row."""
    ny = nw if ny is None else ny

    def sl(g, dy, dx):
        return g[dy:dy + ny, dx:dx + nw]

    if order == 1:
        offsets = [(0, 0)]
    elif order == 3:
        offsets = [(oy, ox) for oy in range(3) for ox in range(3)]
    else:
        offsets = [(0, 0), (0, 1), (1, 0), (1, 1)]
    T = torch.stack([s for oy, ox in offsets
                     for s in (sl(fx, oy, ox), sl(fy, oy, ox))], dim=-1)
    return T.reshape(ny * nw, 2 * len(offsets))


def _interp_rows_ref(T, base, w, frac=None):
    """One row gather per body from :func:`_interp_table`, weighted: the
    plain version of :func:`_interp_rows`.

    A table with 4K lanes carries ``[T | ΔT]`` (:func:`pm_mesh_state`):
    the gathered rows are extrapolated ``T + frac·ΔT`` (``frac`` None
    reads T alone).
    """
    K = w.shape[1]
    rows = T[base]                                  # (n, 2K) single gather
    if T.shape[1] == 4 * K:
        rows = (rows[:, :2 * K] if frac is None
                else rows[:, :2 * K] + frac * rows[:, 2 * K:])
    if K == 1:
        return rows * w[:, 0:1]
    ax = sum(w[:, k] * rows[:, 2 * k] for k in range(K))
    ay = sum(w[:, k] * rows[:, 2 * k + 1] for k in range(K))
    return torch.stack([ax, ay], dim=-1)


def _interp_rows(T, base, w, frac=None):
    """Interpolation from a packed table (:func:`_interp_rows_ref`'s
    semantics): CPU tensors take the plain version, CUDA tensors launch
    ``csrc/interp.cu`` (its table entry), the same bits."""
    if T.device.type == "cpu":
        return _interp_rows_ref(T, base, w, frac)
    n, K = w.shape
    L = T.shape[1] if T.dim() == 2 else -1
    if L not in (2 * K, 4 * K):
        raise ValueError(f"_interp_rows: a table of {tuple(T.shape)} for "
                         f"K={K} cells a body (2K or 4K lanes a row)")
    _build.check_tensor("T", T, (T.shape[0], L), align=8)
    has_frac = frac is not None and L == 4 * K
    return _interp_launch(
        "tnt_interp_table", T, base, w,
        lambda out, b, is64: (T.data_ptr(), L, b, is64, w.data_ptr(), out,
                              n, K, int(has_frac),
                              ctypes.c_float(float(frac) if has_frac
                                             else 0.0)))


def _interp_packed_ref(fx, fy, base, w, nw, ny=None):
    """Plain version of :func:`_interp_packed`: the packed table, then one
    row gather per body."""
    order = {1: 1, 4: 2, 9: 3}[w.shape[1]]
    return _interp_rows_ref(_interp_table(fx, fy, nw, order, ny=ny), base, w)


def _interp_packed(fx, fy, base, w, nw, ny=None):
    """Force interpolation from the force-grid windows; mirrors
    :func:`_deposit_packed`'s assignment so the odd kernel's self-force
    cancels. CPU tensors take :func:`_interp_packed_ref`; CUDA tensors
    launch ``csrc/interp.cu``, which reads each body's cells straight from
    the windows (no table), the same bits."""
    if fx.device.type == "cpu":
        return _interp_packed_ref(fx, fy, base, w, nw, ny=ny)
    n, K = w.shape
    if K not in INTERP_TAPS:
        raise ValueError(f"_interp_packed: {K} weights a body, expected "
                         f"1, 4 or 9")
    ny = nw if ny is None else ny
    reach = INTERP_TAPS[K]
    rows, ld = fx.shape
    if rows < ny + reach or ld < nw + reach:
        raise ValueError(f"_interp_packed: windows {tuple(fx.shape)} too "
                         f"small for a ({ny}, {nw}) mesh at K={K}")
    _build.check_tensor("fx", fx, (rows, ld))
    _build.check_tensor("fy", fy, (rows, ld), device=fx.device)
    return _interp_launch(
        "tnt_interp_windows", fx, base, w,
        lambda out, b, is64: (fx.data_ptr(), fy.data_ptr(), b, is64,
                              w.data_ptr(), out, n, K, nw, ld))


def interp_work(base, K: int, nw: int, ld: int) -> dict:
    """Flops and bytes of one interpolation of the bodies with base cells
    ``base`` and ``K`` taps from force-grid windows of row stride ``ld``,
    counted for what the data needs: fx and fy read once at each distinct
    window cell the taps touch (``cells``, counted here with a device
    sort; the kernel reads no other cell), the base cells and weights read
    once, the (n, 2) accelerations written once."""
    n = base.shape[0]
    reach = INTERP_TAPS[K]
    b = base.to(torch.int64)
    c0 = (b // nw) * ld + b % nw
    offs = torch.tensor([oy * ld + ox for oy in range(reach + 1)
                         for ox in range(reach + 1)], device=base.device)
    cells = int(torch.unique(c0[:, None] + offs[None, :]).numel())
    return dict(cells=cells, flops=2 * (2 * K - 1) * n,
                bytes=2 * 4 * cells + n * (base.element_size() + 4 * K)
                + n * 2 * 4)


def _interp_launch(fn, grid, base, w, args):
    """Check the bodies' arguments, launch ``fn`` of the kernel library
    with ``args(out, base, is64)`` and the stream; count the launch."""
    global INTERP_LAUNCHES
    n, K = w.shape
    dev = grid.device
    if base.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"base: expected int32 or int64, got {base.dtype}")
    _build.check_tensor("w", w, (n, K), device=dev)
    _build.check_tensor("base", base, (n,), device=dev, dtype=base.dtype)
    out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    rc = getattr(_build.library(), fn)(
        *args(out.data_ptr(), base.data_ptr(), int(base.dtype == torch.int64)),
        _build.stream(dev))
    _build.check_launch(fn, rc)
    with band_ops._COUNT_LOCK:
        INTERP_LAUNCHES += 1
    return out


def _conv_potential(rho, phi_hat, ny, grid, grid_y, extra=0):
    """Trimmed FFT convolution: deposited grid -> potential FD window.

    Only rows 0..ny+1+extra of the padded grid hold mass, so the forward
    row transforms run on those; only potential rows -3..ny+3+extra feed
    the FD stencil, so the inverse row transforms run on ny+7+extra rows
    (the three negative rows wrap to the far padded edge, ``sp[-3:]``). The
    column transforms stay full. ``extra`` is 1 for TSC's longer reach.
    ``rho`` holds at least those :func:`occ_rows` (the block of
    :func:`deposit_cells`, or the whole grid). Returns the
    (ny+7+extra, grid) rows -3..ny+3+extra.
    """
    occ = occ_rows(ny, 3 if extra else 2)
    if rho.shape[0] < occ:
        raise ValueError(f"_conv_potential: {rho.shape[0]} density rows, "
                         f"the FFT reads {occ}")
    rh = torch.fft.rfft(rho[:occ], dim=1)
    rh = F.pad(rh, (0, 0, 0, grid_y - occ))
    sp = torch.fft.ifft(torch.fft.fft(rh, dim=0) * phi_hat, dim=0)
    rows = torch.cat([sp[-3:], sp[:ny + 4 + extra]])
    return torch.fft.irfft(rows, n=grid, dim=1)


def _mesh_grids_one(spos, smass, origin, h, nw, grid, order, kernel,
                    ny=None):
    """Deposit -> FFT convolution -> 6th-order FD gradient.

    Returns the force-grid windows ``(fx, fy)`` of shape (ny+1+reach,
    nw+1+reach), reach 1 for TSC and 0 otherwise: the long-range field at
    world cell corners. The stencil's three negative taps per axis wrap to
    the far padded edge (the ``sp[-3:]`` rows and the column roll), as in
    the JAX version.
    """
    return _mesh_grids_cells(spos, smass, origin, h, nw, grid, order,
                             kernel, ny=ny)[:2]


def _mesh_grids_cells(spos, smass, origin, h, nw, grid, order, kernel,
                      ny=None):
    """:func:`_mesh_grids_one` that also returns the cells of its
    deposit: ``(fx, fy, base, w)``, so a fresh pass computes them once
    (:func:`deposit_cells`)."""
    ny = nw if ny is None else ny
    grid_y = grid if ny == nw else 2 * ny
    reach = 1 if order == 3 else 0  # TSC reads one more row/col of (fx, fy)
    rho, base, w = deposit_cells(spos, smass, origin, h, nw, grid, order,
                                 ny=ny, grid_y=grid_y)
    _, _, phi_hat = kernel
    pw = _conv_potential(rho, phi_hat, ny, grid, grid_y, extra=reach)
    fx, fy = _fd_gradient(pw, h, nw, ny, reach)
    return fx, fy, base, w


def _fd_coefficients(h):
    """(c1, c2, c3) of the 6th-order central difference, Python floats
    that torch rounds to float32 as it multiplies."""
    return 45.0 / (60.0 * h), 9.0 / (60.0 * h), 1.0 / (60.0 * h)


def _fd_gradient(pw, h, nw, ny, reach):
    """6th-order finite-difference gradient of the potential rows
    :func:`_conv_potential` returns: the force-grid windows ``(fx, fy)``
    of :func:`_mesh_grids_one`, :func:`fd_window` at its (ny + 1 + reach,
    nw + 1 + reach) windows."""
    return fd_window(pw, h, ny + 1 + reach, nw + 1 + reach)


def fd_window(src, h, rows, cols):
    """The 6th-order FD gradient of potential rows ``src`` (R, W), R >=
    rows + 6: ``(fx, fy)`` of shape (rows, cols), output row i from
    source row i + 3 and its three neighbours each side, output column j
    from source columns j ± 1..3 taken mod W (the negative taps wrap to
    the far padded edge). :func:`_fd_gradient` is this at rows ny + 1 +
    reach, cols nw + 1 + reach; the sharded P3M runs it on a rank's
    halo-extended slab; cols + 3 <= W, so no tap wraps twice. CPU tensors
    take :func:`_fd_window_ref`; CUDA tensors launch ``csrc/fd.cu``."""
    if src.device.type == "cpu":
        return _fd_window_ref(src, h, rows, cols)
    global FD_LAUNCHES
    R, W = src.shape
    if R < rows + 6 or not 1 <= cols <= W - 3:
        raise ValueError(f"fd_window: ({rows}, {cols}) windows from "
                         f"{tuple(src.shape)} potential rows (needs rows + "
                         f"6 rows and 1 <= cols <= W - 3)")
    _build.check_tensor("src", src, (R, W))
    fx = torch.empty((rows, cols), dtype=src.dtype, device=src.device)
    fy = torch.empty_like(fx)
    c1, c2, c3 = _fd_coefficients(h)
    rc = _build.library().tnt_fd_gradient(
        src.data_ptr(), R, W, rows, cols, ctypes.c_float(c1),
        ctypes.c_float(c2), ctypes.c_float(c3), fx.data_ptr(), fy.data_ptr(),
        _build.stream(src.device))
    _build.check_launch("fd_gradient", rc)
    with band_ops._COUNT_LOCK:
        FD_LAUNCHES += 1
    return fx, fy


def _fd_window_ref(src, h, rows, cols):
    """The plain version of :func:`fd_window`: the wrapped columns -3 ..
    cols + 2 of the rows, then the stencil on slices, each difference,
    product and sum in the JAX version's order."""
    c1, c2, c3 = _fd_coefficients(h)
    core = src[3:3 + rows]
    cw = torch.cat([core[:, -3:], core[:, :cols + 3]], dim=1)

    def sh(k):
        return cw[:, 3 + k:3 + k + cols]

    def dy(k):
        return src[3 + k:3 + k + rows, :cols]

    fx = (c1 * (sh(1) - sh(-1)) - c2 * (sh(2) - sh(-2))
          + c3 * (sh(3) - sh(-3)))
    fy = (c1 * (dy(1) - dy(-1)) - c2 * (dy(2) - dy(-2))
          + c3 * (dy(3) - dy(-3)))
    return fx, fy


def _mesh_force(spos, smass, origin, h, nw, grid, soft2, a, order, kernel,
                ny=None):
    """Deposit -> FFT convolution -> interpolate, one grid registration.
    Deposit and interpolation use the same assignment, so a body's own
    image exerts no force on it; the interpolation reuses the deposit's
    cells."""
    fx, fy, base, w = _mesh_grids_cells(spos, smass, origin, h, nw, grid,
                                        order, kernel, ny=ny)
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


def _interlaced(morigin, h):
    """The second mesh's origin, half a cell below and left of ``morigin``
    (float32 values, as the JAX version computes ``morigin - 0.5 * h``)."""
    return (f32(morigin[0] - 0.5 * h), f32(morigin[1] - 0.5 * h))


def pm_mesh_state(spos, smass, salive, soft2, origin, root_side, *,
                  mesh_level: int, split_cells: float, order: int = 2,
                  interlace: bool = False, mesh_ny: int = 0,
                  heavy_cap: int = 0, deconvolve: bool = True, kernel=None,
                  prev=None, switch: str = "exp4"):
    """Build the carried long-range mesh state for F_long subcycling.

    Returns ``(grids, dep_pos, dep_wmass, heavy_mask)``:

    * ``grids``: one (two with ``interlace``) packed interpolation tables
      (:func:`_interp_table` of the :func:`_mesh_grids_one` windows). With
      ``prev`` the previous refresh's ``grids``, each table carries
      ``[T | ΔT]`` in 4K lanes, ΔT = T − T_prev, for per-step
      extrapolation; ``prev="zero"`` gives ΔT = 0 in that layout (the seed
      state); ``prev=None`` a plain 2K-lane table;
    * ``dep_pos``: the positions the deposit saw (for :func:`_self_term`);
    * ``dep_wmass``: the mass deposited per body (dead and heavy zeroed);
    * ``heavy_mask``: the ``heavy_cap`` heaviest alive bodies (ties to the
      lower index, as ``jax.lax.top_k``), kept off the mesh; their F_long
      comes from :func:`_heavy_direct` every step instead.
    """
    dtype, dev = spos.dtype, spos.device
    nw, ny, grid, _, h, a, morigin = _pm_geometry(
        origin, root_side, mesh_level, mesh_ny, split_cells)
    smass_w = torch.where(salive, smass, 0.0)
    cap = spos.shape[0]
    heavy_mask = torch.zeros((cap,), dtype=torch.bool, device=dev)
    if heavy_cap:
        key = torch.where(salive, smass_w, -1.0)
        kv, hidx = _topk_lowest_index(key, heavy_cap)
        heavy_mask[hidx] = kv > -0.5
    dep_wmass = torch.where(heavy_mask, 0.0, smass_w)
    if kernel is None:
        kernel = _kernel_hats(grid, h, soft2, a, dtype, dev, grid_y=2 * ny,
                              deconv_order=order if deconvolve else 0,
                              switch=switch)

    def table(origin_, prev_tab):
        fx, fy = _mesh_grids_one(spos, dep_wmass, origin_, h, nw, grid,
                                 order, kernel, ny=ny)
        t = _interp_table(fx, fy, nw, order, ny=ny)
        if prev_tab is None:
            return t
        if isinstance(prev_tab, str):        # "zero": seed, ΔT = 0
            return torch.cat([t, torch.zeros_like(t)], dim=1)
        return torch.cat([t, t - prev_tab[:, :t.shape[1]]], dim=1)

    def prev_of(i):
        return prev if prev is None or isinstance(prev, str) else prev[i]

    grids = (table(morigin, prev_of(0)),)
    if interlace:
        grids = grids + (table(_interlaced(morigin, h), prev_of(1)),)
    return grids, spos, dep_wmass, heavy_mask


def _self_term(spos, dep_pos, dep_wmass, soft2, a, switch="exp4"):
    """Analytic stale-grid self-force cancellation (per body, O(n)):
    +m_dep·δ·(1 − w(δ))·(|δ|²+ε²)^{-3/2} with δ = x_now − x_dep, the
    opposite of a body's pull towards its own deposited image. Zero at a
    refresh (δ = 0)."""
    d = spos - dep_pos
    r2 = torch.sum(d * d, dim=1)
    inv = torch.rsqrt(r2 + soft2)
    w = dep_wmass * (inv * inv * inv)
    w = w * (1.0 - _short_weight(r2, a, switch))
    return w[:, None] * d


def _heavy_direct(spos, smass, salive, heavy_mask, soft2, a, heavy_cap,
                  switch="exp4"):
    """Exact F_long on every body from the ``heavy_cap`` masked heavy
    bodies at their current positions: dense (n x heavy_cap) pair math.
    Self pairs vanish (K_long(0) = 0)."""
    key = torch.where(heavy_mask, smass, -1.0)
    kv, hidx = _topk_lowest_index(key, heavy_cap)
    valid = (kv > -0.5) & salive[hidx]
    hp = spos[hidx]
    hm = torch.where(valid, smass[hidx], 0.0)
    dx = spos[:, 0:1] - hp[None, :, 0]          # (n, H)
    dy = spos[:, 1:2] - hp[None, :, 1]
    r2 = dx * dx + dy * dy
    inv = torch.rsqrt(r2 + soft2)
    w = hm[None, :] * (inv * inv * inv)
    w = w * (1.0 - _short_weight(r2, a, switch))
    return -torch.stack([torch.sum(w * dx, dim=1),
                         torch.sum(w * dy, dim=1)], dim=-1)


def pm_accel_sorted(spos, smass, salive, G, soft2, origin, root_side, *,
                    mesh_level: int, split_cells: float, band: int,
                    chunk: int, order: int = 2, interlace: bool = False,
                    rescue_k: int = 0, rescue_k_hot: int = 0,
                    rescue_hot_cap: int = 128, mesh_ny: int = 0,
                    deconvolve: bool = True, kernel=None, mesh_state=None,
                    heavy_cap: int = 0, self_correct: bool = True,
                    stale_frac=None, switch: str = "exp4"):
    """P3M acceleration in the Hilbert-SORTED frame: (n, 2) -> (n, 2).

    The body arrays must already be in Hilbert order over the root quad
    (:func:`_hilbert_sort`); the result is in the same order. Returns
    ``(acc_sorted, (rescue_need, hot_count, mesh_oob))``, the stats as
    0-dim int32 tensors on the bodies' device. ``mesh_oob`` counts alive
    bodies outside a rectangular mesh's row window (they clamp to the edge
    rows). The band pass runs the hand-written kernel for a CUDA tensor.

    ``mesh_state`` (a :func:`pm_mesh_state` result, possibly stale) skips
    the deposit and FFT: the carried tables are interpolated at the current
    positions (extrapolated by ``stale_frac`` when they carry ΔT), the
    stale self-term is cancelled (``self_correct``) and the heavy bodies'
    F_long is summed directly. ``heavy_cap > 0`` without a state builds a
    fresh one. ``heavy_cap`` must match the state's.
    """
    _check_switch(switch)
    dtype, dev = spos.dtype, spos.device
    nw, ny, grid, _, h, a, morigin = _pm_geometry(
        origin, root_side, mesh_level, mesh_ny, split_cells)
    smass = torch.where(salive, smass, 0.0)
    mesh_oob = torch.zeros((), dtype=torch.int32, device=dev)
    if ny != nw:
        sy = (spos[:, 1] - morigin[1]) / h
        mesh_oob = (salive & ((sy < 0.0) | (sy >= ny))).sum(dtype=torch.int32)

    if mesh_state is None and heavy_cap == 0:
        # Fresh full pass, everyone on the mesh.
        if kernel is None:
            kernel = _kernel_hats(grid, h, soft2, a, dtype, dev,
                                  grid_y=2 * ny,
                                  deconv_order=order if deconvolve else 0,
                                  switch=switch)
        acc_mesh = _mesh_force(spos, smass, morigin, h, nw, grid, soft2, a,
                               order, kernel, ny=ny)
        if interlace:
            acc_mesh = 0.5 * (acc_mesh + _mesh_force(
                spos, smass, _interlaced(morigin, h), h, nw, grid, soft2, a,
                order, kernel, ny=ny))
    else:
        # Carried (or freshly built) grids + fresh heavy sum + stale
        # self-term cancellation.
        if mesh_state is None:
            mesh_state = pm_mesh_state(
                spos, smass, salive, soft2, origin, root_side,
                mesh_level=mesh_level, split_cells=split_cells, order=order,
                interlace=interlace, mesh_ny=mesh_ny, heavy_cap=heavy_cap,
                deconvolve=deconvolve, kernel=kernel, switch=switch)
        grids, dep_pos, dep_wmass, heavy_mask = mesh_state
        base, w = _cic_cells(spos, morigin, h, nw, order, ny=ny)
        acc_mesh = _interp_rows(grids[0], base, w, frac=stale_frac)
        if interlace:
            base2, w2 = _cic_cells(spos, _interlaced(morigin, h), h, nw,
                                   order, ny=ny)
            acc_mesh = 0.5 * (acc_mesh + _interp_rows(grids[1], base2, w2,
                                                      frac=stale_frac))
        if self_correct:
            acc_mesh = acc_mesh + _self_term(spos, dep_pos, dep_wmass,
                                             soft2, a, switch=switch)
        if heavy_cap:
            acc_mesh = acc_mesh + _heavy_direct(spos, smass, salive,
                                                heavy_mask, soft2, a,
                                                heavy_cap, switch=switch)

    acc_short = band_ops.band_short_range(spos, smass, soft2, a, band=band,
                                          chunk=chunk, switch=switch)
    rescue_need = torch.zeros((), dtype=torch.int32, device=dev)
    hot_count = torch.zeros((), dtype=torch.int32, device=dev)
    if rescue_k:
        acc_r, rescue_need, hot_count = _block_rescue(
            spos, smass, salive, soft2, a, band=band, k=rescue_k,
            chunk=chunk, k_hot=rescue_k_hot, hot_cap=rescue_hot_cap,
            switch=switch)
        acc_short = acc_short + acc_r

    acc = (acc_mesh + acc_short) * salive[:, None].to(dtype)
    return G * acc, (rescue_need, hot_count, mesh_oob)


def pm_accel(pos, mass, alive, G, soft2, origin, root_side, *,
             mesh_level: int, split_cells: float, band: int, chunk: int,
             order: int = 2, interlace: bool = False, rescue_k: int = 0,
             rescue_k_hot: int = 0, rescue_hot_cap: int = 128,
             mesh_ny: int = 0, deconvolve: bool = True,
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
        rescue_k_hot=rescue_k_hot, rescue_hot_cap=rescue_hot_cap,
        mesh_ny=mesh_ny, deconvolve=deconvolve, kernel=kernel,
        heavy_cap=heavy_cap, switch=switch)
    out = acc[unsort]
    if return_stats:
        return out, {"rescue_need": rescue_need, "rescue_hot": hot_count,
                     "mesh_oob": mesh_oob}
    return out
