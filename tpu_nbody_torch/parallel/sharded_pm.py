"""Sharded P3M: per-rank deposit, slab-decomposed FFT, halo-exchanged band
(port of tpu_nbody.parallel.sharded_pm).

* Bodies are domain-decomposed: :func:`reshard_by_hilbert` (host path) or
  :func:`make_device_reshard` (odd-even merge-split, nothing gathered)
  orders them along the Hilbert curve, so rank r owns the r-th contiguous
  curve segment, a compact region of the world. Within a step each rank
  re-sorts its own bodies.
* Deposit: each rank deposits its bodies into a local density grid
  (:func:`mesh_ops.deposit_cells`, ``csrc/deposit.cu`` on the card), whose
  cells its interpolation reuses.
* Potential: a slab-decomposed FFT convolution (:func:`_slab_fft_phi`):
  ``psum_scatter`` of the occupied density rows, row FFTs, an
  ``all_to_all`` transpose, column FFTs against the rank's column slice of
  the kernel, and back on the rows the FD stencil reads. The 6th-order FD
  gradient (:func:`_fd_force_window`) runs on the row slabs with a 3-row
  ``ppermute`` halo; the force window is ``all_gather``-ed for the local
  interpolation.
* Short range: each rank's sorted bodies plus a ``band``-row halo from
  both ring neighbours (zeroed at the two ends of the curve) go through the
  band pass, on the card the hand-written band kernel, once a force pass a
  rank. The shard-local block rescue and a cross-shard rescue
  (:func:`_cross_shard_rescue`) recover near pairs the curve puts far
  apart.

Knobs the JAX step does not read (``pm_mesh_every > 1``, ``pm_heavy_cap >
0``, ``mesh_rescue_hot > 0``) and TSC raise when the step is built.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from tpu_nbody_torch.config import Params, SimConfig
from tpu_nbody_torch.engine import _root
from tpu_nbody_torch.ops import band as band_ops
from tpu_nbody_torch.ops import mesh as mesh_ops
from tpu_nbody_torch.ops import morton
from tpu_nbody_torch.parallel.collectives import Group, run_spmd
from tpu_nbody_torch.parallel.mesh import shard_state
from tpu_nbody_torch.parallel.sharded import _merge_sharded
from tpu_nbody_torch.state import SimState

INTEGRATORS = ("kdk", "kdk_reuse", "euler")


class PmShardStats(NamedTuple):
    """Needs of a sharded P3M ``step_n``, max over its force passes and the
    ranks (0-dim int32 device tensors, the same on every rank).

    Coverage is exact (up to each pass's cutoff) iff ``heavy_need <=
    heavy_cap_local``, ``rescue_need <= cfg.mesh_rescue`` (informational:
    the closest-first ranking drops only the farthest boxes), ``xport_need
    <= xrescue_export`` and ``ximport_need <= cfg.mesh_xrescue``.
    """
    heavy_need: torch.Tensor
    rescue_need: torch.Tensor
    xport_need: torch.Tensor
    ximport_need: torch.Tensor
    mesh_oob: torch.Tensor


def _win_rows(ny: int, n_shards: int) -> int:
    """Padded row count of the distributed φ FD window (rows -3..ny+3)."""
    return -(-(ny + 7) // n_shards) * n_shards


def _occ_rows_p(ny: int, n_shards: int, grid_y: int) -> int:
    """Density rows the slab FFT reduce-scatters: the CIC rows
    (:func:`mesh_ops.occ_rows`, rows 0..ny+1) padded to a multiple of the
    shards, at most the grid's. The rank's deposit fills and zeroes just
    these rows."""
    return min(-(-mesh_ops.occ_rows(ny, 2) // n_shards) * n_shards, grid_y)


def _slab_fft_phi(rho_local, phi_hat, *, group: Group, grid, grid_y, ny):
    """Distributed potential solve, a trimmed slab-decomposed FFT
    convolution (inside :func:`run_spmd`).

    ``rho_local`` is this rank's partial density, at least the leading
    ``occ_p`` (:func:`_occ_rows_p`) rows of the (grid_y, grid) grid; the
    ranks' sum is the global grid. Only rows 0..ny+1 hold mass, so only those
    (padded to ``occ_p``, a multiple of P) are reduce-scattered and
    row-transformed; only φ rows -3..ny+3 feed the FD stencil, so only
    those return. Returns this rank's (win_p/P, grid) slab of the φ window
    (:func:`_win_rows`): global window row r is padded-grid row r - 3.
    """
    P = group.size
    hw = grid // 2 + 1
    hwp = -(-hw // P) * P
    occ_p = _occ_rows_p(ny, P, grid_y)
    win = ny + 7
    win_p = _win_rows(ny, P)
    slab = group.psum_scatter(rho_local[:occ_p], scatter_dimension=0)
    rh = F.pad(torch.fft.rfft(slab, dim=1), (0, hwp - hw))   # (occ_p/P, hwp)
    cols = group.all_to_all(rh, split_axis=1, concat_axis=0)  # (occ_p, hwp/P)
    cols = F.pad(cols, (0, 0, 0, grid_y - occ_p))
    ch = torch.fft.fft(cols, dim=0)
    w = hwp // P
    ph = F.pad(phi_hat, (0, hwp - hw))[:, group.rank * w:(group.rank + 1) * w]
    ch = torch.fft.ifft(ch * ph, dim=0)
    rows = F.pad(torch.cat([ch[-3:], ch[:ny + 4]]), (0, 0, 0, win_p - win))
    back = group.all_to_all(rows, split_axis=0, concat_axis=1)  # (win_p/P, hwp)
    return torch.fft.irfft(back[:, :hw], n=grid, dim=1)


def _fd_force_window(phi_slab, h, *, group: Group, nw, ny):
    """6th-order FD gradient of the distributed φ window, gathered on the
    world window (ny+1, nw+1) each rank's interpolation reads.

    Column taps wrap as the padded grid does (the single-device trimmed
    path's roll); the ±3 row taps come from the ring neighbours' slabs.
    Ring-wrap and padding rows reach only outputs that the final world
    slice drops. Needs at least 3 window rows a rank (one-hop halos). The
    stencil is :func:`mesh_ops.fd_window` on the halo-extended slab
    (``csrc/fd.cu`` on the card).
    """
    rows_local = phi_slab.shape[0]
    if rows_local < 3:
        raise ValueError(f"_fd_force_window needs >= 3 window rows a rank, "
                         f"got {rows_local} ({group.size} ranks)")
    P = group.size
    halo_up = group.ppermute(phi_slab[-3:], [(i, (i + 1) % P)
                                             for i in range(P)])
    halo_dn = group.ppermute(phi_slab[:3], [(i, (i - 1) % P)
                                            for i in range(P)])
    ext = torch.cat([halo_up, phi_slab, halo_dn])            # (rows+6, grid)
    fx, fy = mesh_ops.fd_window(ext, h, rows_local, nw + 1)
    fx_full = group.all_gather(fx, tiled=True)               # (win_p, m)
    fy_full = group.all_gather(fy, tiled=True)
    return fx_full[3:4 + ny], fy_full[3:4 + ny]              # (ny+1, m)


def _cross_shard_rescue(spos, smass, salive, soft2, a, *, band, k,
                        export_cap, chunk, group: Group, switch="exp4"):
    """Short-range rescue for block pairs on different ranks.

    :func:`mesh_ops._block_rescue` recovers pairs split by Hilbert-curve
    discontinuities inside a rank's segment; this pass covers the pairs
    whose blocks land on two ranks, with a locally-essential export:

    1. ``all_gather`` every rank's (B, 4) block-box table;
    2. each rank exports up to ``export_cap`` of its blocks that a remote
       block needs (box gap < 2a and more than one block apart in global
       block order: the band's halo covers adjacent blocks), all-gathered;
       a block's export score is the closest remote block's, the rank-0
       score of :func:`mesh_ops.rescue_select` against the remote boxes;
    3. each local block sums the switched pair forces of its ``k`` closest
       imported partner blocks (a second :func:`mesh_ops.rescue_select`,
       closest-first as the local rescue ranks), in one
       :func:`band_ops.rescue_pair_sum` (the rescue kernel on the card).

    Both selections are the selection kernel on the card (one launch each)
    and the plain version, ``chunk`` // ``band`` blocks at a time, on the
    CPU. Returns (acc_sorted (cap, 2), export_need, import_need): coverage
    is exact up to the 2a cutoff iff export_need <= export_cap and
    import_need <= k on every rank.
    """
    cap = spos.shape[0]
    S = band
    dtype, dev = spos.dtype, spos.device
    P = group.size
    me = group.rank
    X, bbox = mesh_ops._block_boxes(spos, smass, salive, band)
    B = X.shape[0]
    cb = max(1, min(B, chunk // S))
    rcut2 = mesh_ops._rcut2(a)
    gid = me * B + torch.arange(B, device=dev)               # global block ids

    bbox_all = group.all_gather(bbox).reshape(P * B, 4)
    remote = (torch.arange(P * B, device=dev) // B) != me
    # export score of each local block: the closest remote block needing it
    exp = mesh_ops.rescue_select(bbox, bbox_all, rcut2, 1, k=0, tgid0=me * B,
                                 cvalid=remote, chunk=cb)
    export_need = exp.hot                                    # #(score > 0)
    E = min(export_cap, B)
    val, eidx = mesh_ops._topk_lowest_index(exp.mval[:, 0], E)  # (E,)
    evalid = val > 0
    erows = X.reshape(B, S * 3)[eidx] * evalid[:, None].to(dtype)
    big = torch.finfo(dtype).max
    ebbox = torch.where(evalid[:, None], bbox[eidx],
                        torch.tensor([big, -big, big, -big], dtype=dtype,
                                     device=dev))
    egid = torch.where(evalid, gid[eidx], -10)               # -10: never adj

    imp_rows = group.all_gather(erows).reshape(P * E, S * 3)
    imp_bbox = group.all_gather(ebbox).reshape(P * E, 4)
    imp_gid = group.all_gather(egid).reshape(P * E)
    imp_shard = torch.arange(P, device=dev).repeat_interleave(E)

    kk = min(k, P * E)
    imp = mesh_ops.rescue_select(bbox, imp_bbox, rcut2, kk, tgid0=me * B,
                                 cgid=imp_gid,
                                 cvalid=(imp_shard != me) & (imp_gid >= 0),
                                 chunk=cb)
    acc = band_ops.rescue_pair_sum(
        X.reshape(B, S * 3), torch.arange(B, device=dev), imp_rows, imp.midx,
        imp.mval > 0, soft2, a, switch, chunk=cb)
    acc = acc.reshape(B * S, 2)[:cap]
    return acc, export_need, imp.need


def _pm_accel_local_sorted(spos, smass, salive, G, soft2, origin, root_side,
                           *, mesh_level, split_cells, band, chunk, rescue_k,
                           group: Group, order=2, interlace=False,
                           mesh_ny=0, xrescue_k=0, xrescue_export=0,
                           deconvolve=True, kernel=None, switch="exp4",
                           probe=None):
    """P3M acceleration of a locally Hilbert-sorted rank (inside
    :func:`run_spmd`), in the same order: the sharded
    :func:`mesh_ops.pm_accel_sorted` with rectangular mesh, assignment
    ``order`` (1 or 2), interlace and trimmed slab FFTs.

    Returns ``(acc, (rescue_need, xport_need, ximport_need, mesh_oob))``
    for this rank. ``probe(name)``, when given, is called after each phase:
    "deposit", "fft", "fd", "interp", "band", "rescue", "xrescue".
    """
    if order == 3:
        raise ValueError("TSC (mesh_order=3) runs on one device only: the "
                         "sharded FD window and tables are sized for the "
                         "CIC reach; use order 1 or 2 on the sharded path")
    dtype, dev = spos.dtype, spos.device
    P = group.size
    nw, ny, grid, grid_y, h, a, morigin = mesh_ops._pm_geometry(
        origin, root_side, mesh_level, mesh_ny, split_cells)
    smass = torch.where(salive, smass, 0.0)
    mesh_oob = torch.zeros((), dtype=torch.int32, device=dev)
    if ny != nw:
        sy = (spos[:, 1] - morigin[1]) / h
        mesh_oob = (salive & ((sy < 0.0) | (sy >= ny))).sum(dtype=torch.int32)
    if kernel is None:
        kernel = mesh_ops._kernel_hats(
            grid, h, soft2, a, dtype, dev, grid_y=grid_y,
            deconv_order=order if deconvolve else 0, switch=switch)

    def mesh_pass(mo):
        rho_local, base, w = mesh_ops.deposit_cells(
            spos, smass, mo, h, nw, grid, order, ny=ny, grid_y=grid_y,
            rows=_occ_rows_p(ny, P, grid_y))
        if probe is not None:
            probe("deposit")
        phi_slab = _slab_fft_phi(rho_local, kernel[2], group=group,
                                 grid=grid, grid_y=grid_y, ny=ny)
        if probe is not None:
            probe("fft")
        fx, fy = _fd_force_window(phi_slab, h, group=group, nw=nw, ny=ny)
        if probe is not None:
            probe("fd")
        out = mesh_ops._interp_packed(fx, fy, base, w, nw, ny=ny)
        if probe is not None:
            probe("interp")
        return out

    acc_mesh = mesh_pass(morigin)
    if interlace:
        acc_mesh = 0.5 * (acc_mesh + mesh_pass(
            mesh_ops._interlaced(morigin, h)))

    # short range: the band pass over this rank's rows and a band-row halo
    # of each ring neighbour; the ring does not wrap (rank 0's left halo
    # and rank P-1's right halo are zero)
    S = band
    n = spos.shape[0]
    fields = torch.cat([spos, smass[:, None]], dim=1)
    halo_left = group.ppermute(fields[-S:], [(i, (i + 1) % P)
                                             for i in range(P)])
    halo_right = group.ppermute(fields[:S], [(i, (i - 1) % P)
                                             for i in range(P)])
    if group.rank == 0:
        halo_left = torch.zeros_like(halo_left)
    if group.rank == P - 1:
        halo_right = torch.zeros_like(halo_right)
    ext = torch.cat([halo_left, fields, halo_right])
    acc_short = band_ops.band_short_range(
        ext[:, :2].contiguous(), ext[:, 2].contiguous(), soft2, a, band=S,
        chunk=chunk, switch=switch)[S:S + n]
    if probe is not None:
        probe("band")
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    rescue_need, xport_need, ximp_need = zero, zero, zero
    if rescue_k:
        acc_r, rescue_need, _ = mesh_ops._block_rescue(
            spos, smass, salive, soft2, a, band=band, k=rescue_k,
            chunk=chunk, switch=switch)
        acc_short = acc_short + acc_r
    if probe is not None:
        probe("rescue")
    if xrescue_k and P > 1:
        acc_x, xport_need, ximp_need = _cross_shard_rescue(
            spos, smass, salive, soft2, a, band=band, k=xrescue_k,
            export_cap=xrescue_export, chunk=chunk, group=group,
            switch=switch)
        acc_short = acc_short + acc_x
    if probe is not None:
        probe("xrescue")
    acc = (acc_mesh + acc_short) * salive[:, None].to(dtype)
    return G * acc, (rescue_need, xport_need, ximp_need, mesh_oob)


def _sort_order(state: SimState, cfg: SimConfig):
    origin, side = _root(cfg)
    codes = morton.hilbert_codes(state.pos, origin, side, state.alive)
    return torch.argsort(codes, stable=True)


def reshard_by_hilbert(state: SimState, group: Group,
                       cfg: SimConfig) -> list:
    """Order a global state along the Hilbert curve and shard it: rank r
    then holds the r-th contiguous curve segment, which the sharded P3M's
    halo exchange relies on. Dead slots sort to the end (the last rank).
    The host path: it sorts the whole state on one device."""
    o = _sort_order(state, cfg)
    alive = state.alive[o]
    state = state._replace(pos=state.pos[o], vel=state.vel[o],
                           mass=torch.where(alive, state.mass[o], 0.0),
                           alive=alive)
    return shard_state(state, group)


def make_device_reshard(group: Group, cfg: SimConfig):
    """reshard(states) -> states: the global Hilbert reshard without a
    gather, for the periodic reshard inside a run.

    Block-level odd-even transposition merge-split over the ranks: each
    rank sorts its bodies by Hilbert code (dead bodies carry the sort-last
    code), then P rounds of a full-shard ``ppermute`` with the round's
    partner and a merge, the lower rank keeping the lower half. P rounds
    sort P sorted blocks; every rank keeps its ``cap/P`` slots throughout,
    so there is no splitter search and no overflow. Equal codes may order
    differently than the host path's single stable sort (both are valid
    total orders). Both partners of a round merge with the lower rank's
    rows first, so equal codes that straddle the split are split once;
    the JAX version, which puts each rank's own rows first, duplicates
    bodies there and drops others (dead bodies all share one code).
    """
    P = group.size
    origin, side = _root(cfg)

    def local(state: SimState):
        dtype = state.pos.dtype
        mass = torch.where(state.alive, state.mass, 0.0)
        rows = torch.cat([state.pos, state.vel, mass[:, None],
                          state.alive.to(dtype)[:, None]], dim=1)  # (c, 6)
        codes = morton.hilbert_codes(state.pos, origin, side, state.alive)
        o = torch.argsort(codes, stable=True)
        rows, codes = rows[o], codes[o]
        c = rows.shape[0]
        me = group.rank
        low_take = torch.arange(c, device=rows.device)
        for r in range(P):
            # odd-even pairing; unpaired end ranks map to themselves
            partner_of = []
            for i in range(P):
                p = i + 1 if (i + r) % 2 == 0 else i - 1
                partner_of.append(p if 0 <= p < P else i)
            perm = [(i, partner_of[i]) for i in range(P)]
            prow = group.ppermute(rows, perm)
            pcod = group.ppermute(codes, perm)
            partner = partner_of[me]
            if me != partner:
                # both partners merge in the same order, the lower rank's
                # rows first, so a run of equal codes across the split is
                # cut once (the JAX step puts its own rows first on both
                # sides and then duplicates or drops bodies of such a run)
                low = me < partner
                allc = torch.cat([codes, pcod] if low else [pcod, codes])
                allr = torch.cat([rows, prow] if low else [prow, rows])
                o2 = torch.argsort(allc, stable=True)
                take = o2[low_take if low else low_take + c]
                rows, codes = allr[take], allc[take]
        return state._replace(pos=rows[:, 0:2], vel=rows[:, 2:4],
                              mass=rows[:, 4], alive=rows[:, 5] > 0.5)

    def reshard(states: list) -> list:
        return run_spmd(group, local, states)

    return reshard


def _check_pm_config(cfg: SimConfig, integrator: str):
    """Raise ``ValueError`` for what the sharded P3M step does not run:
    an integrator other than kdk, kdk_reuse and euler, TSC, and the three
    knobs the JAX step ignores without a word (``pm_mesh_every > 1``,
    ``pm_heavy_cap > 0``, ``mesh_rescue_hot > 0``)."""
    mesh_ops._check_switch(cfg.mesh_switch)
    mesh_ops._check_order(cfg.mesh_order)
    if integrator not in INTEGRATORS:
        raise ValueError(f"the sharded P3M step runs {INTEGRATORS}, got "
                         f"{integrator!r}")
    if cfg.mesh_order == 3:
        raise ValueError("TSC (mesh_order=3) runs on one device only")
    for name, bad in (("pm_mesh_every", max(1, cfg.pm_mesh_every) > 1),
                      ("pm_heavy_cap", cfg.pm_heavy_cap > 0),
                      ("mesh_rescue_hot", cfg.mesh_rescue_hot > 0)):
        if bad:
            raise ValueError(f"{name}={getattr(cfg, name)}: the sharded P3M "
                             f"step does not run this knob (the JAX step "
                             f"ignores it); use the one-device Engine")


def make_sharded_pm_step(group: Group, cfg: SimConfig, *,
                         integrator: str = "kdk", heavy_cap_local: int = 16,
                         xrescue_export: int | None = None, probe=None):
    """step_n(states, params, n_steps=1) -> (states, PmShardStats) on
    ``group``, and ``step_n.accel(states, params)``, one force pass.

    Each rank steps its bodies in local Hilbert order: every step
    re-sorts them (kdk, euler), or, with ``kdk_reuse``, one force pass a
    step and a re-sort every ``cfg.pm_resort_every`` steps (the step
    index, counted from 0 each call). A composed local permutation is
    carried and undone at the end, so slot identity is unchanged by one
    call. ``xrescue_export`` overrides ``cfg.mesh_xrescue_export`` (the
    engine grows it on ``xport_need`` overflow). The kernel hats are built
    once a call on the group's device and shared by its ranks. ``probe``
    is passed to every force pass.
    """
    _check_pm_config(cfg, integrator)
    P = group.size
    if xrescue_export is None:
        xrescue_export = cfg.mesh_xrescue_export
    origin, side = _root(cfg)
    K = max(1, cfg.pm_resort_every)

    def accel_sorted(pos, mass, alive, params, kernel):
        acc, rsc = _pm_accel_local_sorted(
            pos, mass, alive, params.G, params.soft2, origin, side,
            mesh_level=cfg.mesh_level, split_cells=cfg.mesh_split,
            band=cfg.mesh_band, chunk=min(cfg.mesh_chunk, cfg.capacity // P),
            rescue_k=cfg.mesh_rescue, group=group, order=cfg.mesh_order,
            interlace=cfg.mesh_interlace, mesh_ny=cfg.mesh_ny,
            xrescue_k=cfg.mesh_xrescue, xrescue_export=xrescue_export,
            deconvolve=cfg.mesh_deconvolve, kernel=kernel,
            switch=cfg.mesh_switch, probe=probe)
        return acc, group.pmax(torch.stack(rsc))    # max over the ranks

    def sort_local(state, perm, zero_dead=True):
        o = _sort_order(state, cfg)
        mass = state.mass[o]
        if zero_dead:
            mass = torch.where(state.alive[o], mass, 0.0)
        return state._replace(pos=state.pos[o], vel=state.vel[o], mass=mass,
                              alive=state.alive[o]), perm[o], o

    def body(state: SimState, params: Params, n_steps: int, kernel):
        perm = torch.arange(state.capacity, device=state.pos.device)
        half = params.dt * 0.5
        heavy = torch.zeros((), dtype=torch.int32, device=state.pos.device)
        rsc = None
        if integrator == "kdk_reuse":
            state, perm, _ = sort_local(state, perm)
            acc, rsc = accel_sorted(state.pos, state.mass, state.alive,
                                    params, kernel)
        for i in range(n_steps):
            if integrator != "kdk_reuse":
                state, perm, _ = sort_local(state, perm)
                acc, r = accel_sorted(state.pos, state.mass, state.alive,
                                      params, kernel)
                rsc = r if rsc is None else torch.maximum(rsc, r)
            if integrator == "euler":
                vel = state.vel + acc * params.dt
                pos = state.pos + vel * params.dt
            else:
                # the 2nd pass keeps the step-start order (bodies move by
                # v dt, far less than a band block's extent)
                vel = state.vel + acc * half
                pos = state.pos + vel * params.dt
                acc, r = accel_sorted(pos, state.mass, state.alive, params,
                                      kernel)
                rsc = torch.maximum(rsc, r)
                vel = vel + acc * half
            state = state._replace(pos=pos, vel=vel, step=state.step + 1)
            state, hv = _merge_sharded(state, params, group=group,
                                       heavy_cap_local=heavy_cap_local)
            heavy = torch.maximum(heavy, hv)
            if integrator == "kdk_reuse" and (i + 1) % K == 0:
                state, perm, o = sort_local(state, perm, zero_dead=False)
                acc = acc[o]
        unsort = torch.empty_like(perm)
        unsort[perm] = torch.arange(perm.shape[0], device=perm.device)
        state = state._replace(pos=state.pos[unsort], vel=state.vel[unsort],
                               mass=state.mass[unsort],
                               alive=state.alive[unsort])
        return state, PmShardStats(heavy, *rsc.to(torch.int32).unbind())

    def make_kernel(params):
        return mesh_ops.kernel_hats_for(
            side, params.soft2, mesh_level=cfg.mesh_level,
            split_cells=cfg.mesh_split, mesh_ny=cfg.mesh_ny,
            dtype=cfg.tdtype, order=cfg.mesh_order,
            deconvolve=cfg.mesh_deconvolve, switch=cfg.mesh_switch,
            device=group.device)

    def step_n(states, params: Params, n_steps: int = 1):
        kernel = make_kernel(params)
        out = run_spmd(group, lambda s: body(s, params, n_steps, kernel),
                       states)
        return [s for s, _ in out], out[0][1]

    def accel(states, params: Params):
        """One force pass of a sharded state whose ranks are in local
        Hilbert order: each local rank's (acc, needs (4,) max over ranks)."""
        kernel = make_kernel(params)
        return run_spmd(group, lambda s: accel_sorted(
            s.pos, s.mass, s.alive, params, kernel), states)

    step_n.accel = accel
    return step_n
