"""P3M short-range pair sums: the hand-written CUDA kernels and their plain
versions (port of tpu_nbody.ops.band_pallas, mesh._band_short_range and the
pair sums of the block rescues).

Bodies in Hilbert order are cut into blocks of ``band`` consecutive slots;
each body sums the switched pair force m·d·(r²+ε²)^{-3/2}·w(r²) from every
body of its own block and both neighbour blocks. Partners past either end
of the array carry mass 0, so there are no wrap-around pairs. The rescues
(``mesh._block_rescue``, ``sharded_pm._cross_shard_rescue``) sum the same
pair force from listed partner blocks further away.

:func:`band_short_range` launches ``csrc/band.cu`` for a CUDA tensor and runs
:func:`band_short_range_ref` for a CPU tensor; :func:`rescue_pair_sum` launches
``csrc/rescue.cu`` or runs :func:`rescue_pair_sum_ref` alike; any other device
raises. ``_build.LAUNCHES`` counts the two kernels' launches as ``"band"`` and
``"rescue"``. :func:`_band_plan` and :func:`_rescue_plan` choose the launch
shapes; :func:`pair_work` and :func:`rescue_pair_work` count the work of one
call, :func:`band_cutoff_pairs` and :func:`rescue_cutoff_pairs` the pairs
within the poly4 cutoff that it needs, and :func:`rescue_near_tiles` the
sub-tiles the rescue kernel walks.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from tpu_nbody_torch.config import f32
from tpu_nbody_torch.kernels import _build

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
_TILE = 32                # partner bodies a rescue sub-tile (csrc TILE)
RESCUE_T = 4              # target rows a lane (partner phases) of a warp
_BOX_BIG = 2.0 ** 126     # a rescue sub-box past this never skips
_INDEX_BYTES = 9          # a partner's int64 index and bool flag


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


def _pair_sum(ctr, part, pm, soft2, a, switch):
    """Switched short-range pair sum of targets ``ctr`` (m, S, 3) over the
    partner rows ``part`` (m, P, 3) with masses ``pm`` (m, P): (m, S, 2)."""
    dx = part[:, None, :, 0] - ctr[:, :, None, 0]           # (m, S, P)
    dy = part[:, None, :, 1] - ctr[:, :, None, 1]
    r2 = dx * dx + dy * dy
    inv = torch.rsqrt(r2 + soft2)
    w = pm[:, None, :] * (inv * inv * inv)
    w = w * _short_weight(r2, a, switch)
    return torch.stack([torch.sum(w * dx, dim=2),
                        torch.sum(w * dy, dim=2)], dim=-1)


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


def band_cutoff_pairs(spos, smass, a, *, band: int, chunk: int) -> int:
    """The pairs of one band pass that poly4 weighs: each of the ``cap``
    bodies against each body of mass > 0 in its own and both neighbour
    S-blocks within the cutoff, r² = dx² + dy² < (2a)² in float32 (self
    pairs included); :func:`pair_work` counts every window pair. Chunked
    as :func:`band_short_range_ref`."""
    cap = spos.shape[0]
    S = band
    nb, cb, n_chunks = _block_bounds(cap, S, chunk)
    fields = torch.cat([spos, smass[:, None]], dim=1)
    X = F.pad(fields, (0, 0, 0, nb * S - cap)).reshape(nb, S, 3)
    Xp = F.pad(X, (0, 0, 0, 0, 1, 1 + n_chunks * cb - nb))
    live = torch.arange(n_chunks * cb * S, device=spos.device) < cap
    rcut2 = _rcut2_f32(a)
    total = torch.zeros((), dtype=torch.int64, device=spos.device)
    for c in range(n_chunks):
        b0 = c * cb
        ctr = Xp[b0 + 1:b0 + 1 + cb]
        part = torch.cat([Xp[b0:b0 + cb], ctr, Xp[b0 + 2:b0 + 2 + cb]], dim=1)
        dx = part[:, None, :, 0] - ctr[:, :, None, 0]
        dy = part[:, None, :, 1] - ctr[:, :, None, 1]
        near = (dx * dx + dy * dy < rcut2) & (part[:, None, :, 2] > 0)
        rows = live[b0 * S:(b0 + cb) * S].reshape(cb, S, 1)
        total += (near & rows).sum()
    return int(total)


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
    out = torch.empty_like(spos)
    cap = spos.shape[0]
    if cap == 0:
        return out
    inv_scale = 1.0 / (4.0 * a * a) if switch == "poly4" else 1.0 / (a * a)
    rc = _build.library().tnt_band_short_range(
        spos.data_ptr(), smass.data_ptr(), out.data_ptr(), cap, band,
        ctypes.c_float(float(soft2)), ctypes.c_float(inv_scale),
        _SWITCH_IDS[switch], plan.T, plan.B,
        _build.stream(spos.device))
    _build.check_launch("band", rc)
    return out


class RescuePlan(NamedTuple):
    """Launch shape of ``csrc/rescue.cu``: one CTA an output block, ``G``
    warps, a run of 32 target rows each (``T`` rows a lane, in T partner
    phases), ``R`` partner blocks staged a round."""
    T: int
    G: int
    R: int
    threads: int
    smem: int


def _rescue_plan(S: int, k: int, T: int = RESCUE_T,
                 R: int | None = None) -> RescuePlan:
    """The rescue kernel's launch shape for blocks of ``S`` and ``k``
    partner blocks (k >= 1). A warp holds a run of 32 target rows, ``T``
    (1, 2 or 4) a lane, and walks every T-th partner of a sub-tile in each
    of its T phases, so G = ceil(S / 32) warps cover the block; ``R``
    (default: as many as fit) is cut to ``k`` and to the shared memory
    that stages R blocks, padded to whole sub-tiles, and their sub-tile
    boxes. T = 4 was the fastest measured at S = 128, k = 8 on an H100
    (``PERF.md``)."""
    if not 1 <= S <= MAX_BAND:
        raise ValueError(f"band {S} outside [1, {MAX_BAND}]")
    if T not in (1, 2, 4):
        raise ValueError(f"T must be 1, 2 or 4, got {T}")
    if k < 1:
        raise ValueError(f"a rescue launch needs k >= 1 partners, got {k}")
    G = -(-S // _TILE)
    per_block = 16 * G * (_TILE + 1)    # its sub-tiles padded, their boxes
    R = min(k, _SMEM_LIMIT // per_block, k if R is None else max(1, R))
    return RescuePlan(T=T, G=G, R=R, threads=32 * G, smem=R * per_block)


def rescue_pair_work(m: int, k: int, S: int, valid: int, row_blocks: int,
                     switch: str = "poly4", *, near_pairs: int | None = None,
                     walked_pairs: int | None = None) -> dict:
    """Pairs, flops and bytes of one rescue pair sum: ``m`` output blocks,
    ``k`` partner slots each, of which ``valid`` are set (the kernel skips
    the rest), over ``row_blocks`` distinct blocks of input rows. The pairs
    the data needs: under exp4 every target against every body of its
    valid partner blocks; under poly4 ``near_pairs``, those within the
    cutoff whose partner has mass (:func:`rescue_cutoff_pairs`; None
    counts every valid pair). ``walked`` is ``walked_pairs``, the pairs of
    the sub-tiles the kernel evaluated (:func:`rescue_near_tiles`; None:
    every valid pair)."""
    _check_switch(switch)
    every = valid * S * S
    pairs = every if switch == "exp4" or near_pairs is None else near_pairs
    return dict(pairs=pairs, flops=pairs * _PAIR_FLOPS[switch],
                walked=every if walked_pairs is None else walked_pairs,
                bytes=(row_blocks * S * 3 * 4 + m * (8 + k * _INDEX_BYTES)
                       + m * S * 2 * 4))


def _rcut2_f32(a) -> float:
    """The rescue's squared cutoff (2a)² as the float32 torch compares
    (``mesh._rcut2`` rounded once)."""
    return f32((2.0 * a) * (2.0 * a))


def _cull_cut(soft2, a, switch: str) -> float:
    """The kernel's skip threshold: a sub-tile pair whose squared box gap
    is at least rcut2·(1 + 2⁻¹⁰) (a float32) holds only pairs of weight
    exactly 0. NaN, which skips nothing, under exp4 (its weight is never
    0) and where ε² is so far above (2a)² (ε²/(2a)² > 2¹⁰) that the margin
    no longer covers the kernel's rounding of 1 + ε²c − r²c."""
    if switch != "poly4":
        return math.nan
    if soft2 > 1024.0 * (4.0 * a * a):
        return math.nan
    return f32(_rcut2_f32(a) * f32(1.0 + 2.0 ** -10))


def _sub_boxes(rows, masses: bool):
    """(B, ceil(S / 32), 4) boxes [minx, maxx, miny, maxy] of each run of 32
    consecutive slots of the block rows (B, 3S), as the rescue kernel
    builds them: every slot of the run; NaN where a coordinate is not
    finite or above 2^126 in magnitude or (``masses``) a mass is not
    finite."""
    B, S = rows.shape[0], rows.shape[1] // 3
    n = -(-S // _TILE)
    pad = n * _TILE - S
    X = rows.reshape(B, S, 3)
    x, y = X[..., 0], X[..., 1]

    def runs(v, fill):
        return F.pad(v, (0, pad), value=fill).reshape(B, n, _TILE)

    bad = ~((x.abs() <= _BOX_BIG) & (y.abs() <= _BOX_BIG))
    if masses:
        bad = bad | ~(X[..., 2].abs() <= torch.finfo(rows.dtype).max)
    box = torch.stack([runs(x, math.inf).amin(-1), runs(x, -math.inf).amax(-1),
                       runs(y, math.inf).amin(-1), runs(y, -math.inf).amax(-1)],
                      dim=-1)
    return torch.where(runs(bad, False).any(-1)[..., None], math.nan, box)


class NearTiles(NamedTuple):
    """What :func:`rescue_near_tiles` returns."""
    mask: torch.Tensor   # (m, G, k, G) bool, G = ceil(S/32): walked
    tiles: int           # (target run, partner sub-tile) pairs walked
    pairs: int           # body pairs of those sub-tile pairs


def rescue_near_tiles(trows, tid, prows, pidx, pvalid, soft2, a,
                      switch: str = "exp4") -> NearTiles:
    """The (target run of 32 rows, partner sub-tile of 32 bodies) pairs of
    the valid partner blocks that the rescue kernel evaluates, on any
    device: under poly4 those whose squared box gap (``mesh._box_gaps``'s
    rounding) is not at least :func:`_cull_cut`, under exp4 all. What the
    kernel's walked counter counts."""
    _check_switch(switch)
    m, k, S = _rescue_args(trows, tid, prows, pidx, pvalid)
    G = -(-S // _TILE)
    mask = pvalid[:, None, :, None].expand(m, G, k, G)
    cut = _cull_cut(soft2, a, switch)
    if m and k and not math.isnan(cut):
        tb = _sub_boxes(trows, False)[tid][:, :, None, None]
        pb = _sub_boxes(prows, True)[pidx][:, None]
        gx = torch.clamp(torch.maximum(tb[..., 0] - pb[..., 1],
                                       pb[..., 0] - tb[..., 1]), min=0.0)
        gy = torch.clamp(torch.maximum(tb[..., 2] - pb[..., 3],
                                       pb[..., 2] - tb[..., 3]), min=0.0)
        mask = mask & ~(gx * gx + gy * gy >= cut)
    width = torch.tensor([min(_TILE, S - _TILE * t) for t in range(G)],
                         device=trows.device)
    per = width[:, None, None] * width
    return NearTiles(mask=mask.contiguous(), tiles=int(mask.sum()),
                     pairs=int((mask * per).sum()))


def rescue_cutoff_pairs(trows, tid, prows, pidx, pvalid, a,
                        switch: str = "poly4", *, chunk: int = 256) -> int:
    """The pairs of a rescue pair sum that the data needs: under poly4 each
    target slot against each body of its valid partner blocks with mass >
    0 within the cutoff, r² = dx² + dy² < (2a)² in float32 (the weight is
    0 past it); under exp4 every valid pair. ``chunk`` output blocks at a
    time bound the (chunk, S, kS) temporaries."""
    _check_switch(switch)
    m, k, S = _rescue_args(trows, tid, prows, pidx, pvalid)
    if switch == "exp4":
        return int(pvalid.sum()) * S * S
    rcut2 = _rcut2_f32(a)
    total = torch.zeros((), dtype=torch.int64, device=trows.device)
    for o0 in range(0, m, chunk):
        o = slice(o0, o0 + chunk)
        n = pidx[o].shape[0]
        ctr = trows[tid[o]].reshape(n, S, 3)
        part = prows[pidx[o]].reshape(n, k * S, 3)
        live = (part[..., 2] > 0).reshape(n, k, S) & pvalid[o, :, None]
        dx = part[:, None, :, 0] - ctr[:, :, None, 0]
        dy = part[:, None, :, 1] - ctr[:, :, None, 1]
        near = (dx * dx + dy * dy < rcut2) & live.reshape(n, 1, k * S)
        total += near.sum()
    return int(total)


def _rescue_args(trows, tid, prows, pidx, pvalid):
    """Shapes (m, k, S) of a rescue call; raises on mismatched ones."""
    m, k = pidx.shape
    if trows.dim() != 2 or prows.dim() != 2 or trows.shape[1] % 3:
        raise ValueError(f"rows must be (blocks, 3 S): {tuple(trows.shape)}, "
                         f"{tuple(prows.shape)}")
    S = trows.shape[1] // 3
    if (prows.shape[1] != 3 * S or tuple(tid.shape) != (m,)
            or tuple(pvalid.shape) != (m, k)):
        raise ValueError(
            f"rescue shapes disagree: trows {tuple(trows.shape)}, tid "
            f"{tuple(tid.shape)}, prows {tuple(prows.shape)}, pidx "
            f"{tuple(pidx.shape)}, pvalid {tuple(pvalid.shape)}")
    return m, k, S


def rescue_pair_sum_ref(trows, tid, prows, pidx, pvalid, soft2, a,
                        switch: str = "exp4", *, chunk: int | None = None):
    """Plain torch rescue pair sum: the rows of block ``tid[o]`` of
    ``trows`` (Bt, 3S) as targets and the blocks ``pidx[o]`` of ``prows``
    (Bp, 3S) as partners, those whose ``pvalid`` is false at mass 0;
    (m, S, 2). ``chunk`` output blocks at a time (default all) bound the
    (chunk, S, kS) temporaries; the rows are independent, so it changes no
    bit."""
    m, k, S = _rescue_args(trows, tid, prows, pidx, pvalid)
    dtype = trows.dtype
    chunk = chunk or max(m, 1)
    out = []
    for o0 in range(0, m, chunk):
        o = slice(o0, o0 + chunk)
        n = pidx[o].shape[0]
        part = prows[pidx[o]].reshape(n, k * S, 3)
        pm = (part[..., 2].reshape(n, k, S)
              * pvalid[o].to(dtype)[:, :, None]).reshape(n, k * S)
        out.append(_pair_sum(trows[tid[o]].reshape(n, S, 3), part, pm, soft2,
                             a, switch))
    if not out:
        return torch.zeros((0, S, 2), dtype=dtype, device=trows.device)
    return torch.cat(out)


def rescue_pair_sum(trows, tid, prows, pidx, pvalid, soft2, a,
                    switch: str = "exp4", *, chunk: int | None = None,
                    walked: torch.Tensor | None = None):
    """Rescue pair sum (:func:`rescue_pair_sum_ref`): (m, S, 2) in the
    order of ``tid``. CPU tensors take the plain version, chunked by
    ``chunk``; CUDA tensors launch ``csrc/rescue.cu`` once, which reads the
    partner blocks through ``pidx``, needs no chunks and, under poly4,
    skips the sub-tiles past the cutoff. ``tid`` and ``pidx`` hold int64
    block indices, ``pvalid`` bools. ``walked`` (a 0-dim int64 tensor on
    the tensors' device) gets the (target run, partner sub-tile) pairs
    evaluated added: the kernel's counter, or :func:`rescue_near_tiles`'s
    count with the plain version."""
    tensors = (trows, tid, prows, pidx, pvalid)
    if all(t.device.type == "cpu" for t in tensors):
        if walked is not None:
            walked += rescue_near_tiles(*tensors, soft2, a, switch).tiles
        return rescue_pair_sum_ref(trows, tid, prows, pidx, pvalid, soft2, a,
                                   switch, chunk=chunk)
    _check_switch(switch)
    m, k, S = _rescue_args(*tensors)
    dev = trows.device
    _build.check_tensor("trows", trows, tuple(trows.shape))
    _build.check_tensor("prows", prows, tuple(prows.shape), device=dev)
    tid, pidx, pvalid = (t.contiguous() for t in (tid, pidx, pvalid))
    _build.check_tensor("tid", tid, (m,), device=dev, dtype=torch.int64)
    _build.check_tensor("pidx", pidx, (m, k), device=dev, dtype=torch.int64)
    _build.check_tensor("pvalid", pvalid, (m, k), device=dev,
                        dtype=torch.bool)
    if walked is not None:
        _build.check_tensor("walked", walked, (), device=dev,
                            dtype=torch.int64, align=8)
    if m == 0 or k == 0:
        return torch.zeros((m, S, 2), dtype=trows.dtype, device=dev)
    return _rescue_launch(trows, tid, prows, pidx, pvalid, soft2, a, switch,
                          _rescue_plan(S, k), walked=walked)


def _rescue_launch(trows, tid, prows, pidx, pvalid, soft2, a, switch: str,
                   plan: RescuePlan, *, walked=None, cull: bool = True):
    """Launch the rescue kernel with ``plan`` on checked arguments;
    ``cull=False`` skips no sub-tile (the same bits, walked in full)."""
    m, k = pidx.shape
    S = trows.shape[1] // 3
    out = torch.empty((m, S, 2), dtype=trows.dtype, device=trows.device)
    inv_scale = 1.0 / (4.0 * a * a) if switch == "poly4" else 1.0 / (a * a)
    cut = _cull_cut(soft2, a, switch) if cull else math.nan
    rc = _build.library().tnt_rescue_pairs(
        trows.data_ptr(), tid.data_ptr(), prows.data_ptr(), pidx.data_ptr(),
        pvalid.data_ptr(), out.data_ptr(),
        None if walked is None else walked.data_ptr(), m, k, S,
        ctypes.c_float(float(soft2)), ctypes.c_float(inv_scale),
        ctypes.c_float(cut), _SWITCH_IDS[switch], plan.T, plan.R,
        _build.stream(trows.device))
    _build.check_launch("rescue", rc)
    return out
