"""Sharded Barnes–Hut: a tree a rank and a locally-essential export
(port of tpu_nbody.parallel.sharded_bh).

* Bodies are domain-decomposed along the Hilbert curve
  (:func:`~tpu_nbody_torch.parallel.sharded_pm.reshard_by_hilbert`).
* Each rank builds its own quadtree of its bodies
  (:func:`tpu_nbody_torch.ops.tree.build_tree`) over the global root quad,
  so cells agree between ranks, and runs the one-device traversal on it.
* Cross-rank forces ride a locally-essential export: each rank runs the
  group-MAC wave traversal (:func:`traverse._traverse_all`) over its tree
  once, with the P ranks' alive bounding boxes standing in as the groups.
  Accepted nodes export (COM, mass); opened leaves export their bodies.
  Every remote body lies in its domain box and every COM in its cell, so an
  accepted export meets the reference's per-body MAC for every body of the
  destination (``BarnesHutAlg.kt:225-228``).
* Exports are fixed-size ``(P, E, 3)`` rows [x, y, m], exchanged with one
  ``all_to_all``; the imported rows are summed densely against the local
  bodies, on the card by the hand-written all-pairs kernel with the local
  bodies as targets. Each pool's need is reported (``let_approx_need``,
  ``let_body_need``) and the engine grows the cap it overflows, as it
  does the tree caps.

Total force = local Barnes–Hut + the import sum; every pair is counted once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_nbody_torch.config import Params, SimConfig
from tpu_nbody_torch.engine import BH_DENSE_MAX_CAP, _root
from tpu_nbody_torch.ops import forces, traverse
from tpu_nbody_torch.ops import tree as tree_lib
from tpu_nbody_torch.parallel.collectives import Group, run_spmd
from tpu_nbody_torch.parallel.sharded import _merge_sharded
from tpu_nbody_torch.state import SimState

INTEGRATORS = ("kdk", "kdk_reuse")


class ShardedBHStats(NamedTuple):
    """Needs of a sharded BH ``step_n`` for cap tuning: max over its force
    passes and the ranks (0-dim device tensors, the same on every rank)."""
    trav: traverse.TraversalStats   # local-tree traversal needs
    export_need: torch.Tensor       # most rows any (src, dst) export wanted
    let_approx_need: torch.Tensor   # most accepted nodes for a destination
    let_body_need: torch.Tensor     # most opened-leaf bodies for a
                                    # destination (the JAX stats lack it: a
                                    # body pool that overflows while the
                                    # node pool has room goes unseen there)
    let_leaf_need: torch.Tensor     # most opened leaves for a destination
    let_frontier_need: torch.Tensor  # largest BFS frontier of the export
                                    # traversal (a cut frontier drops
                                    # cross-rank interactions)
    heavy_need: torch.Tensor


def _max_stats(a: ShardedBHStats, b: ShardedBHStats) -> ShardedBHStats:
    return ShardedBHStats(traverse.max_stats(a.trav, b.trav),
                          *(torch.maximum(x, y) for x, y in zip(a[1:], b[1:])))


def _let_exports(tree, boxes_min, boxes_max, box_valid, me, theta2, soft2, *,
                 max_depth, frontier_cap, approx_cap, leaf_list_cap,
                 body_cap):
    """The (P, E, 3) export rows [x, y, m] of this rank for every rank.

    Row j holds what this rank contributes to rank j's forces: MAC-accepted
    local nodes as (COM, mass), then the bodies of opened leaves;
    E = approx_cap + body_cap, and unused rows carry mass 0. Returns
    (exports, export_need, approx_need, leaf_need, frontier_need,
    body_need): the largest sum, node count, leaf count, BFS frontier and
    body count over the destinations. Rows past either pool's cap are
    dropped, so coverage is exact iff approx_need <= approx_cap and
    body_need <= body_cap.
    """
    nP = boxes_min.shape[0]
    dev = boxes_min.device
    gvalid = box_valid & (torch.arange(nP, device=dev) != me)
    approx, a_len, leaves, l_len, f_need = traverse._traverse_all(
        tree, boxes_min, boxes_max, gvalid, theta2, soft2,
        max_depth=max_depth, frontier_cap=frontier_cap,
        approx_cap=approx_cap, leaf_list_cap=leaf_list_cap)
    slots, svalid, s_total = traverse._direct_partners_all(
        tree, leaves, l_len, direct_body_cap=body_cap)

    avalid = (torch.arange(approx_cap, device=dev)[None, :]
              < a_len[:, None])
    arows = tree.node_rows[torch.where(avalid, approx, 0).long()]
    a_part = torch.stack([arows[..., 1], arows[..., 2],
                          torch.where(avalid, arows[..., 0], 0.0)], dim=-1)
    brows = tree.body_rows[slots.long()]                      # (P, DB, 4)
    b_part = torch.stack([brows[..., 0], brows[..., 1],
                          torch.where(svalid, brows[..., 2], 0.0)], dim=-1)
    exports = torch.cat([a_part, b_part], dim=1)              # (P, E, 3)
    return (exports, (a_len + s_total).max(), a_len.max(), l_len.max(),
            f_need.max(), s_total.max())


def _import_accel(pos, imports, soft2, chunk=1024):
    """Acceleration (no G) of the local bodies from every imported point
    mass: the plain version of the import sum's kernel launch."""
    rows = imports.reshape(-1, 3)
    return forces.accel_allpairs_ref(rows[:, :2], rows[:, 2], 1.0, soft2,
                                     targets=pos, chunk=chunk)


def _import_sum(pos, imports, G, soft2):
    """G times the import sum: :func:`forces.accel_allpairs` of the
    imported rows (split into contiguous pos and mass, as the kernel reads
    them) on the local bodies as targets."""
    rows = imports.reshape(-1, 3)
    return forces.accel_allpairs(rows[:, :2].contiguous(),
                                 rows[:, 2].contiguous(), G, soft2,
                                 targets=pos.contiguous())


def make_sharded_bh_step(group: Group, cfg: SimConfig, caps, *,
                         heavy_cap_local: int = 16,
                         let_approx_cap: int = 2048,
                         let_body_cap: int = 2048,
                         let_leaf_cap: int = 512,
                         let_frontier_cap: int = 4096,
                         integrator: str = "kdk_reuse"):
    """step_n(states, params, n_steps=1) -> (states, ShardedBHStats), and
    ``step_n.accel(states, params)``, one force pass.

    ``caps`` (:class:`tpu_nbody_torch.engine.Caps`) sizes each rank's tree
    and traversal. The step is kick-drift-kick reusing the closing force (a
    seed pass, then one tree build, traversal and export a step) for
    ``integrator`` "kdk" and "kdk_reuse" alike, as the JAX step always is;
    "euler" raises here. The local traversal is ``cfg.bh_traversal``, or
    for "auto" dense up to ``BH_DENSE_MAX_CAP`` slots a rank and bfs
    above, as in the JAX step.
    """
    if integrator not in INTEGRATORS:
        raise ValueError(f"the sharded BH step runs kick-drift-kick with "
                         f"force reuse ({INTEGRATORS}), got {integrator!r}")
    P = group.size
    local_cap = cfg.capacity // P
    tree_lib.check_id_range(local_cap, caps.num_nodes)
    origin, side = _root(cfg)
    local_trav = (cfg.bh_traversal if cfg.bh_traversal != "auto"
                  else ("dense" if local_cap <= BH_DENSE_MAX_CAP else "bfs"))

    def local_accel(pos, mass, alive, params: Params):
        me = group.rank
        t = tree_lib.build_tree(pos, torch.where(alive, mass, 0.0), alive,
                                origin, side, num_nodes=caps.num_nodes,
                                leaf_size=cfg.leaf_size,
                                max_depth=cfg.max_depth)
        acc, tstats = traverse.bh_accel_from_tree(
            t, params.theta, params.soft2, params.G,
            group_size=caps.group_size, group_cap=caps.group_cap,
            max_depth=cfg.max_depth, frontier_cap=caps.frontier_cap,
            approx_cap=caps.approx_cap, leaf_list_cap=caps.leaf_list_cap,
            direct_body_cap=caps.direct_body_cap,
            group_chunk=cfg.group_chunk, traversal=local_trav,
            hier_sizes=tuple(cfg.bh_hier_sizes), cand_caps=caps.cand_caps,
            hier_batch=cfg.bh_hier_batch)

        # the alive bounding box of every rank's domain
        big = torch.finfo(pos.dtype).max
        box = torch.cat([torch.where(alive[:, None], pos, big).amin(dim=0),
                         torch.where(alive[:, None], pos, -big).amax(dim=0)])
        boxes = group.all_gather(box)                          # (P, 4)
        box_valid = group.all_gather(alive.sum(dtype=torch.int32)) > 0

        theta2 = float(np.float32(params.theta) * np.float32(params.theta))
        exports, e_need, a_need, l_need, f_need, b_need = _let_exports(
            t, boxes[:, :2], boxes[:, 2:], box_valid, me, theta2,
            params.soft2, max_depth=cfg.max_depth,
            frontier_cap=let_frontier_cap, approx_cap=let_approx_cap,
            leaf_list_cap=let_leaf_cap, body_cap=let_body_cap)
        imports = group.all_to_all(exports, split_axis=0, concat_axis=0)
        acc = acc + _import_sum(pos, imports, params.G, params.soft2)
        acc = acc * alive[:, None].to(acc.dtype)

        # one pmax for every need
        let = [e_need, a_need, b_need, l_need, f_need]
        flat = group.pmax(torch.cat([tstats.flat(),
                                     torch.stack(let).to(torch.int64)]))
        trav = traverse.TraversalStats(
            *flat[:7], None if tstats.cand_need is None
            else flat[7:-len(let)])
        zero = torch.zeros((), dtype=torch.int64, device=pos.device)
        return acc, ShardedBHStats(trav, *flat[-len(let):], heavy_need=zero)

    def body(state: SimState, params: Params, n_steps: int):
        acc, stats = local_accel(state.pos, state.mass, state.alive, params)
        half = params.dt * 0.5
        for _ in range(n_steps):
            vel = state.vel + acc * half
            pos = state.pos + vel * params.dt
            acc, st = local_accel(pos, state.mass, state.alive, params)
            vel = vel + acc * half
            state = state._replace(pos=pos, vel=vel, step=state.step + 1)
            state, heavy = _merge_sharded(state, params, group=group,
                                          heavy_cap_local=heavy_cap_local)
            stats = _max_stats(stats, st._replace(
                heavy_need=heavy.to(torch.int64)))
        return state, stats

    def step_n(states, params: Params, n_steps: int = 1):
        out = run_spmd(group, lambda s: body(s, params, n_steps), states)
        return [s for s, _ in out], out[0][1]

    def accel(states, params: Params):
        """One force pass of a sharded state: each local rank's (acc,
        ShardedBHStats)."""
        return run_spmd(group, lambda s: local_accel(s.pos, s.mass, s.alive,
                                                     params), states)

    step_n.accel = accel
    return step_n
