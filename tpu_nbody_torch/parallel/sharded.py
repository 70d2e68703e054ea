"""Sharded exact step: ring all-pairs and the sharded merge rule (port of
tpu_nbody.parallel.sharded).

Bodies are data-parallel over a :class:`~tpu_nbody_torch.parallel.
collectives.Group` (rank r owns the r-th ``capacity / P`` slots). The exact
force pass is a ring: each rank sums its bodies against a visiting (pos,
mass) tile that moves one rank on with ``ppermute`` each round, so after P
rounds every rank has met every tile. On the card each round's tile sum is
the hand-written all-pairs kernel with the rank's bodies as separate
targets (P² launches a force pass over the group). The merge rule gathers
the few heavy absorber candidates of every rank with ``all_gather``,
resolves victims locally and sums the mass gains with ``psum``: the
semantics of :mod:`tpu_nbody_torch.ops.merge`.
"""

from __future__ import annotations

import torch

from tpu_nbody_torch.config import Params
from tpu_nbody_torch.ops import forces
from tpu_nbody_torch.ops import merge as merge_ops
from tpu_nbody_torch.parallel.collectives import Group, run_spmd
from tpu_nbody_torch.state import SimState

INTEGRATORS = ("kdk", "euler")


def _accel_vs_tile(pos, tile_pos, tile_mass, soft2, chunk=1024):
    """Partial acceleration (no G) of the local bodies ``pos`` from one
    visiting tile: the plain version of a ring round's kernel launch."""
    return forces.accel_allpairs_ref(tile_pos, tile_mass, 1.0, soft2,
                                     targets=pos, chunk=chunk)


def ring_allpairs_accel(pos, mass, G, soft2, *, group: Group):
    """Exact all-pairs acceleration of this rank's bodies (inside
    :func:`run_spmd`): P rounds of a tile sum and a ring ``ppermute``. The
    tile sum is :func:`forces.accel_allpairs` (the kernel on a CUDA tensor,
    :func:`_accel_vs_tile`'s math on a CPU one)."""
    P = group.size
    perm = [(i, (i + 1) % P) for i in range(P)]
    pos = pos.contiguous()
    tile_pos, tile_mass = pos, mass.contiguous()
    acc = torch.zeros_like(pos)
    for k in range(P):
        acc = acc + forces.accel_allpairs(tile_pos, tile_mass, 1.0, soft2,
                                          targets=pos)
        if k + 1 < P:
            tile_pos = group.ppermute(tile_pos, perm)
            tile_mass = group.ppermute(tile_mass, perm)
    return G * acc


def _merge_sharded(state: SimState, params: Params, *, group: Group,
                   heavy_cap_local: int):
    """Sharded absorb rule (semantics: :mod:`tpu_nbody_torch.ops.merge`).

    Each rank builds its heavy table (:func:`merge.heavy_table`, global ids
    ``rank * nl + index``), the tables are gathered into one, and each rank
    resolves its own bodies against it (:func:`merge.absorb`, round 2 from
    the table alone); the gains, summed by table slot over the ranks, land
    on the heavies their owners hold. On the card both halves are
    ``csrc/merge.cu``.

    Returns ``(state, heavy_need)``: the largest count of qualifying heavies
    on any rank (the same on every rank). Above ``heavy_cap_local`` the
    lightest local heavies were left out as absorbers; the caller grows the
    cap and redoes the step.
    """
    nl, dim = state.pos.shape
    shard = group.rank
    need, hpos, hgidx, hvalid = merge_ops.heavy_table(
        state.pos, state.mass, state.alive, params.merge_max_mass,
        min(heavy_cap_local, nl), gid0=shard * nl)
    heavy_need = group.pmax(need)
    if params.merge_min_dist <= 0:        # disabled (BarnesHutAlg.kt:465)
        return state, torch.zeros_like(heavy_need)
    md2 = params.merge_min_dist * params.merge_min_dist

    # the global heavy table: (P * heavy_cap_local, ...)
    all_hpos = group.all_gather(hpos).reshape(-1, dim)
    all_hgidx = group.all_gather(hgidx).reshape(-1)
    all_hvalid = group.all_gather(hvalid).reshape(-1)
    mass, alive, gained = merge_ops.absorb(
        state.pos, state.mass, state.alive, all_hpos, all_hgidx, all_hvalid,
        md2, gid0=shard * nl)
    gained = group.psum(gained)

    # gains land on the heavies this rank owns; the rest go to a dump slot
    mine = all_hvalid & ((all_hgidx // nl) == shard)
    local_slot = torch.where(mine, all_hgidx % nl, nl)
    mass = torch.cat([mass, mass.new_zeros(1)])
    mass.index_add_(0, local_slot, torch.where(mine, gained, 0.0))
    return state._replace(mass=mass[:nl], alive=alive), heavy_need


def make_sharded_step(group: Group, *, integrator: str = "kdk",
                      heavy_cap_local: int = 16):
    """step_n(states, params, n_steps=1) -> (states, heavy_need) on
    ``group``: ring all-pairs forces, ``integrator`` ("kdk" or "euler",
    anything else raises here) and the sharded merge every step.
    ``states`` is a sharded state (one :class:`SimState` per local rank,
    :func:`~tpu_nbody_torch.parallel.mesh.shard_state`); ``heavy_need`` is
    the largest over the steps, a 0-dim device tensor."""
    if integrator not in INTEGRATORS:
        raise ValueError(f"the sharded all-pairs step runs {INTEGRATORS}, "
                         f"got {integrator!r}")

    def accel(pos, mass, alive, params):
        m = torch.where(alive, mass, 0.0)
        return ring_allpairs_accel(pos, m, params.G, params.soft2,
                                   group=group)

    def local_step(state: SimState, params: Params):
        a = accel(state.pos, state.mass, state.alive, params)
        if integrator == "kdk":
            half = params.dt * 0.5
            vel = state.vel + a * half
            pos = state.pos + vel * params.dt
            vel = vel + accel(pos, state.mass, state.alive, params) * half
        else:
            vel = state.vel + a * params.dt
            pos = state.pos + vel * params.dt
        state = state._replace(pos=pos, vel=vel, step=state.step + 1)
        return _merge_sharded(state, params, group=group,
                              heavy_cap_local=heavy_cap_local)

    def body(state, params, n_steps):
        state, heavy = local_step(state, params)
        for _ in range(n_steps - 1):
            state, h = local_step(state, params)
            heavy = torch.maximum(heavy, h)
        return state, heavy

    def step_n(states, params: Params, n_steps: int = 1):
        out = run_spmd(group, lambda s: body(s, params, n_steps), states)
        return [s for s, _ in out], out[0][1]

    return step_n
