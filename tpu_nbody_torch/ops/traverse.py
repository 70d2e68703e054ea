"""Vectorised Barnes–Hut MAC traversal + blocked force evaluation (port of
tpu_nbody.ops.traverse).

Replaces the reference's per-body recursive traversal
(``BHTree.accumulateForce``, ``src/main/kotlin/BarnesHutAlg.kt:215-239``):

* Bodies are grouped by tree node: a group is a maximal node holding at
  most ``group_size`` bodies (its parent holds more). Groups partition the
  Hilbert-sorted body array into contiguous ranges and are spatially compact
  squares by construction. The group MAC box is the tight AABB of the
  group's members.

* Every node is tested against a group box with the conservative group MAC

      accept node  <=>  s^2 < theta^2 * (d_box^2 + eps^2)  and  d_box > 0

  where s is the node cell side and d_box the least distance from the
  node's cell box to the group box. Every body of the group is inside the
  group box and the node's centre of mass inside its cell, so d_box <=
  d_com: every accepted interaction also satisfies the reference's per-body
  criterion (``BarnesHutAlg.kt:225-228``, softening inside the criterion
  distance). ``d_box > 0`` keeps a group's own and touching cells opened,
  so self-interaction is excluded exactly.

* Three traversals give the same interaction sets: ``"dense"`` (one
  (groups x nodes) classification, :func:`_classify_dense`), ``"bfs"`` (a
  lockstep wave traversal, the independently derived cross-check,
  :func:`_traverse_all`) and ``"hier"`` (chunk-hierarchical candidate
  refinement, :func:`_hier_accel`, the large-N path). All lists have fixed
  capacity; the sizes a scene needs are returned (:class:`TraversalStats`)
  so the engine can regrow the caps instead of silently dropping
  interactions.

* The point-mass kernel is the reference's: a += m_src * d * r^-3, r^2 =
  |d|^2 + eps^2 (``BarnesHutAlg.kt:250-259``). Self-pairs and padding
  contribute exactly zero (d = 0 or mass = 0). The dense and bfs
  evaluations are dense and blocked, (group_size x list) pair blocks
  through :func:`point_accel`: the hand-written kernel
  ``csrc/bh_pairs.cu`` for CUDA tensors (launches counted in
  :data:`LAUNCHES`), its plain version :func:`_point_accel` for CPU
  tensors. The hier evaluation goes through :func:`hier_accel`: on the
  card ``csrc/bh_hier.cu`` (:data:`HIER_LAUNCHES`), one launch a pass, a
  CTA a group that tests its chunk's candidates and walks the accepted
  nodes and the opened leaves' body ranges itself; on the CPU the
  masked-dense :func:`hier_accel_ref` (per-group weights on padded pair
  blocks, direct partners flattened to slots).

What differs from the JAX package, whose results it reproduces:

* XLA fuses a pair block's arithmetic; eager PyTorch materialises every
  temporary. So each ``lax.map`` over chunks is a Python loop (no host sync
  inside) whose batch comes from a budget of :data:`PAIR_BUDGET` elements a
  temporary, and ``group_chunk`` and ``hier_batch`` are upper bounds. The
  kernels need no pair temporary, so on the card the budget counts the
  lists alone, and the hier kernel runs once a pass.
* List compaction (:func:`_compact_rows`) is a cumsum and one scatter into
  a buffer one slot wider than the list, every refused write aimed at the
  extra slot, in place of ``top_k``: the same ascending ids.
* The partner flatten inverts the leaf-count cumsum with an integer
  ``searchsorted`` in place of the dense membership mask and its matmul, so
  the slot offsets are exact whatever the matmul precision flags are.
* The JAX package's ``debug_stage`` timing probes are gone; ``probe``
  (a callable taking a phase name, called where that phase's work has been
  enqueued) serves a caller that times phases with device events.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from tpu_nbody_torch.kernels import _build
from tpu_nbody_torch.ops.tree import Tree

# Elements of one pair-block temporary (512 MiB of float32); about six are
# live at once in :func:`_point_accel`.
PAIR_BUDGET = 1 << 27
TRAVERSALS = ("dense", "bfs", "hier")

LAUNCHES = 0    # csrc/bh_pairs.cu
HIER_LAUNCHES = 0   # csrc/bh_hier.cu
# sharded ranks run as threads of one process and launch concurrently
_COUNT_LOCK = threading.Lock()
_PAIRS_THREADS = 256     # threads a CTA of csrc/bh_pairs.cu aims at
_PAIRS_TILE = 256        # TILE in csrc/bh_pairs.cu
_PAIR_FLOPS = 13         # ops/forces.py::_PAIR_FLOPS[2], the same formula
_PAIRS_UNIT = 32         # UNIT in csrc/bh_pairs.cu: sources dealt at once
_PAIRS_MAX_SPLITS = 8    # CTAs a set: its last CTA adds that many sums
_PAIRS_SCRATCH = 32 << 20   # bytes of a call's partial sums, at most
_HIER_MAX_GS = 2048      # targets a group csrc/bh_hier.cu holds
_HIER_STAGE = 2048       # STAGE in csrc/bh_hier.cu: leaf bodies staged


# the cap each need of :class:`TraversalStats` is held to, in field order
NEED_CAPS = ("approx_cap", "leaf_list_cap", "direct_body_cap", "frontier_cap",
             "group_cap", "num_nodes", "group_size")


class TraversalStats(NamedTuple):
    """Max per-group list sizes actually needed (for cap auto-tuning):
    0-dim device tensors out of a force pass, Python ints once the engine
    has read them to the host."""
    approx_need: torch.Tensor | int
    leaf_need: torch.Tensor | int
    direct_need: torch.Tensor | int
    frontier_need: torch.Tensor | int
    group_need: torch.Tensor | int       # number of groups actually formed
    node_need: torch.Tensor | int        # tree nodes the scene requires
                                         # (> num_nodes: deep levels truncated)
    group_size_need: torch.Tensor | int  # max bodies in any leaf: a childless
                                         # node bigger than group_size joins
                                         # no group and its bodies would get
                                         # zero force
    # hier traversal only: (n_levels,) max per-chunk candidate-set size at
    # each refinement level (a tensor, or a tuple of ints on the host);
    # None for the dense and bfs traversals.
    cand_need: torch.Tensor | tuple | None = None

    def overflows(self, caps) -> list:
        """(cap name, cap, need) of every cap in the mapping ``caps`` that
        its need exceeds; one host sync a need on device tensors."""
        out = [(cap, caps[cap], need) for cap, need in zip(NEED_CAPS, self)
               if need > caps[cap]]
        cc = caps.get("cand_caps")
        if cc is not None and self.cand_need is not None and any(
                need > c for need, c in zip(self.cand_need, cc)):
            out.append(("cand_caps", cc, self.cand_need))
        return out

    def overflowed(self, caps) -> bool:
        """Whether any need exceeds its cap in the mapping ``caps``."""
        return bool(self.overflows(caps))

    def flat(self):
        """Every need in one 1-D int64 tensor (field order, ``cand_need``
        last), so a caller reads them all with one transfer."""
        return torch.cat([x.reshape(-1).to(torch.int64) for x in self
                          if x is not None])

    def on_host(self, vals):
        """These stats as Python ints, from ``flat().tolist()``."""
        return TraversalStats(
            *vals[:7], None if self.cand_need is None else tuple(vals[7:]))


def max_stats(a, b):
    """None-tolerant elementwise max of two :class:`TraversalStats` of
    device tensors."""
    if a is None or b is None:
        return a if b is None else b
    return TraversalStats(*[x if y is None else torch.maximum(x, y)
                            for x, y in zip(a, b)])


def _arange(n, dev):
    return torch.arange(n, dtype=torch.int32, device=dev)


def _pair_elems(GS: int, device) -> int:
    """Elements a (target, source) slot costs in a pair temporary: ``GS``
    targets a group in the plain version (CPU), none in the kernel."""
    return GS if device.type == "cpu" else 1


def _batch_rows(per_row: int, most: int) -> int:
    """Rows a batch may hold so one temporary of ``per_row`` elements a row
    stays inside :data:`PAIR_BUDGET`; at least 1, at most ``most``."""
    return max(1, min(most, PAIR_BUDGET // max(per_row, 1)))


def make_groups(tree: Tree, group_size: int, group_cap: int):
    """Traversal groups = maximal small tree nodes (<= group_size bodies,
    parent bigger; the root qualifies when small). Returns group body ranges
    sorted by start, so groups tile the sorted body array in order."""
    NC = tree.code.shape[0]
    cap = tree.spos.shape[0]
    ids = _arange(NC, tree.code.device)
    valid = ids < tree.n_nodes
    pcnt = torch.where(tree.parent >= 0,
                       tree.count[torch.clamp(tree.parent, min=0).long()],
                       torch.iinfo(torch.int32).max)
    is_group = valid & (tree.count > 0) & (tree.count <= group_size) \
        & (pcnt > group_size)
    n_groups = is_group.sum(dtype=torch.int32)

    start_key = torch.where(is_group, tree.start, cap + 1)
    order = torch.argsort(start_key, stable=True)[:group_cap]
    gvalid = is_group[order]
    gstart = torch.where(gvalid, tree.start[order], cap)
    gcount = torch.where(gvalid, tree.count[order], 0)
    return gvalid, gstart, gcount, n_groups


def _group_bodies(spos, gstart, GS: int):
    """(G, GS, 2) positions of each group's GS-slot window and the window's
    first slot (G,): the slice the JAX package takes per group."""
    cap = spos.shape[0]
    sl0 = torch.clamp(gstart, 0, cap - GS)
    rows = sl0[:, None] + _arange(GS, spos.device)[None, :]
    return spos[rows.long()], sl0


def _group_aabb(spos, gstart, gcount, gvalid, GS: int):
    """Tight AABB of every group's members (gather; no segment scatter)."""
    bpos, sl0 = _group_bodies(spos, gstart, GS)
    row_slot = sl0[:, None] + _arange(GS, spos.device)[None, :]
    rv = gvalid[:, None] & (row_slot >= gstart[:, None]) \
        & (row_slot < (gstart + gcount)[:, None])
    big = torch.finfo(spos.dtype).max
    mn = torch.where(rv[..., None], bpos, big).amin(dim=1)
    mx = torch.where(rv[..., None], bpos, -big).amax(dim=1)
    return mn, mx


def _scatter_compact(buf, pos, take, values, cap_):
    """Write ``values`` where ``take`` at columns ``pos`` of ``buf``
    (G, cap_ + 1). Every refused write (not taken, or past the cap) goes to
    column ``cap_``, which the caller slices off; the kept targets are
    distinct, so the kept part is deterministic."""
    tgt = torch.where(take & (pos < cap_), pos, cap_)
    return buf.scatter_(1, tgt.long(), values)


def _traverse_all(tree: Tree, gmin, gmax, gvalid, theta2, soft2, *,
                  max_depth, frontier_cap, approx_cap, leaf_list_cap):
    """Lockstep BFS over all groups. gmin/gmax: (G, 2). Returns per-group
    approx/leaf index lists + needed sizes. One wave per tree level."""
    G = gvalid.shape[0]
    dev = gvalid.device
    F, A, L = frontier_cap, approx_cap, leaf_list_cap
    i32 = torch.int32
    slot = _arange(F, dev)[None, :]                          # (1, F)

    frontier = torch.zeros((G, F), dtype=i32, device=dev)
    f_len = gvalid.to(i32)                                   # (G,)
    approx = torch.zeros((G, A + 1), dtype=i32, device=dev)
    a_len = torch.zeros((G,), dtype=i32, device=dev)
    leaves = torch.zeros((G, L + 1), dtype=i32, device=dev)
    l_len = torch.zeros((G,), dtype=i32, device=dev)
    f_need = f_len

    def append(buf, length, take, values, cap_):
        # (G, F) take/values -> compacted append at per-group offsets
        pos = length[:, None] + torch.cumsum(take, dim=1, dtype=i32) - 1
        buf = _scatter_compact(buf, pos, take, values, cap_)
        return buf, length + take.sum(dim=1, dtype=i32)

    for _ in range(max_depth + 1):
        active = slot < f_len[:, None]                       # (G, F)
        nid = torch.where(active, frontier, 0)
        rows = tree.node_rows[nid.long()]                    # (G, F, 14)
        nonempty = active & (rows[..., 0] > 0)
        cx, cy, side = rows[..., 3], rows[..., 4], rows[..., 5]
        half = 0.5 * side
        gapx = torch.clamp(torch.maximum((cx - half) - gmax[:, None, 0],
                                         gmin[:, None, 0] - (cx + half)),
                           min=0.0)
        gapy = torch.clamp(torch.maximum((cy - half) - gmax[:, None, 1],
                                         gmin[:, None, 1] - (cy + half)),
                           min=0.0)
        d2 = gapx * gapx + gapy * gapy
        accept = (side * side < theta2 * (d2 + soft2)) & (d2 > 0)
        is_leaf = rows[..., 6] < 0

        take_a = nonempty & accept
        take_l = nonempty & ~accept & is_leaf
        take_o = nonempty & ~accept & ~is_leaf

        approx, a_len = append(approx, a_len, take_a, nid, A)
        leaves, l_len = append(leaves, l_len, take_l, nid, L)

        # Frontier expansion: opened nodes contribute their 1-4 occupied
        # children, compacted at exclusive-cumsum positions with 4 bounded
        # scatters. Child ids come from the already-gathered rows.
        nc = torch.where(take_o, rows[..., 7].to(i32), 0)
        cum = torch.cumsum(nc, dim=1, dtype=i32)
        total = cum[:, -1]
        o_pos = cum - nc                                     # exclusive cumsum
        child0 = rows[..., 6].to(i32)
        nxt = torch.zeros((G, F + 1), dtype=i32, device=dev)
        for c in range(4):
            nxt = _scatter_compact(nxt, o_pos + c, take_o & (c < nc),
                                   child0 + c, F)
        f_need = torch.maximum(f_need, total)
        f_len = torch.clamp(total, max=F)
        frontier = torch.where(slot < f_len[:, None], nxt[:, :F], 0)

    return approx[:, :A], a_len, leaves[:, :L], l_len, f_need


def _box_pass(gmin, gmax, cx, cy, half, side2, theta2, soft2):
    """Group-MAC pass mask for (G,) group boxes x (NC,) node cells.

    pass <=> s^2 < theta^2 * (gap^2 + eps^2)  and  gap > 0, with gap the
    least distance between the group AABB and the node's cell box: the same
    conservative form the wave traversal uses.
    """
    gapx = torch.clamp(torch.maximum((cx - half)[None, :] - gmax[:, 0:1],
                                     gmin[:, 0:1] - (cx + half)[None, :]),
                       min=0.0)
    gapy = torch.clamp(torch.maximum((cy - half)[None, :] - gmax[:, 1:2],
                                     gmin[:, 1:2] - (cy + half)[None, :]),
                       min=0.0)
    d2 = gapx * gapx + gapy * gapy
    return (side2[None, :] < theta2 * (d2 + soft2)) & (d2 > 0)


def _compact_rows(mask, cap_):
    """Per-row indices of set bits, compacted left and padded with 0.

    mask (G, NC) -> (idx (G, cap_) int32 ascending, len (G,) clipped,
    total (G,) exact).
    """
    G, NC = mask.shape
    dev = mask.device
    rank = torch.cumsum(mask, dim=1, dtype=torch.int32)
    total = rank[:, -1].clone()
    buf = torch.zeros((G, cap_ + 1), dtype=torch.int32, device=dev)
    ids = _arange(NC, dev)[None, :].expand(G, NC)
    idx = _scatter_compact(buf, rank - 1, mask, ids, cap_)[:, :cap_]
    return idx, torch.clamp(total, max=cap_), total


def _classify_dense(tree: Tree, gmin, gmax, gvalid, theta2, soft2, *,
                    approx_cap, leaf_list_cap):
    """Dense local MAC classification: the BFS-free traversal.

    The conservative group MAC is monotone down the tree: a node's children
    have half its cell side and at least its box gap, so ``pass(parent)``
    implies ``pass(child)``. A wave traversal therefore carries no
    information a local test cannot reconstruct:

        accepted multipole  <=>  pass(n) and not pass(parent(n))
        direct leaf         <=>  leaf(n) and not pass(n)

    which turns the traversal into one dense (groups x nodes) mask
    computation followed by one compaction per list. Returns the same
    (approx, a_len, leaves, l_len, needs) as the wave traversal, with exact
    needs (the wave version can only lower-bound them past a truncated
    frontier).
    """
    rows = tree.node_rows
    NC = rows.shape[0]
    node_valid = _arange(NC, rows.device) < tree.n_nodes
    occupied = node_valid & (rows[:, 0] > 0)
    cx, cy, side = rows[:, 3], rows[:, 4], rows[:, 5]
    is_leaf = rows[:, 6] < 0
    par = tree.parent
    has_parent = par >= 0
    psafe = torch.clamp(par, min=0).long()
    pcx, pcy, pside = cx[psafe], cy[psafe], side[psafe]

    pass_n = _box_pass(gmin, gmax, cx, cy, 0.5 * side, side * side,
                       theta2, soft2)
    pass_p = _box_pass(gmin, gmax, pcx, pcy, 0.5 * pside, pside * pside,
                       theta2, soft2) & has_parent[None, :]
    live = occupied[None, :] & gvalid[:, None]
    accept = live & pass_n & ~pass_p
    direct = live & is_leaf[None, :] & ~pass_n

    approx, a_len, a_tot = _compact_rows(accept, approx_cap)
    leaves, l_len, l_tot = _compact_rows(direct, leaf_list_cap)
    return approx, a_len, leaves, l_len, a_tot, l_tot


def _flatten_ranges(lstart, counts, DB: int):
    """Partner slots of padded leaf lists. ``lstart``/``counts`` (G, L) are
    the leaves' first bodies and sizes (0 for padding). Slot j of row g
    belongs to the leaf whose cumulative-count interval [offs_excl, offs)
    contains j and maps to body ``lstart + (j - offs_excl)``: the interval
    is found by an integer ``searchsorted`` over the cumsum, so the slots
    are exact. Returns (slots (G, DB) int32, 0 where unused; the leaf index
    of every slot (G, DB); valid (G, DB); total (G,) unclipped)."""
    G, L = lstart.shape
    dev = lstart.device
    offs = torch.cumsum(counts, dim=1, dtype=torch.int32)
    total = offs[:, -1]
    jj = _arange(DB, dev)[None, :].expand(G, DB).contiguous()
    leaf = torch.clamp(torch.searchsorted(offs, jj, right=True), max=L - 1)
    delta = lstart - (offs - counts)                          # (G, L)
    slots = torch.gather(delta, 1, leaf) + jj
    valid = jj < torch.clamp(total, max=DB)[:, None]
    return torch.where(valid, slots, 0), leaf, valid, total


def _direct_partners_all(tree: Tree, leaves, l_len, *, direct_body_cap):
    """Flatten per-group leaf body ranges into padded partner-slot arrays
    (G, direct_body_cap): slots, their validity, and the unclipped need."""
    G, L = leaves.shape
    lvalid = _arange(L, leaves.device)[None, :] < l_len[:, None]
    lidx = torch.where(lvalid, leaves, 0)
    lrows = tree.node_rows[lidx.long()]                       # (G, L, 14)
    lstart = lrows[..., 8].to(torch.int32)
    counts = torch.where(lvalid, lrows[..., 9].to(torch.int32), 0)
    slots, _, valid, total = _flatten_ranges(lstart, counts, direct_body_cap)
    return slots, valid, total


def _box_pass_cols(bmn, bmx, cx, cy, side, theta2, soft2):
    """Conservative group-MAC pass, broadcast form.

    ``bmn``/``bmx`` are (..., 2) box corners; ``cx``/``cy``/``side`` are
    (..., K) cell geometry with broadcast-compatible leading dims. Same
    criterion as :func:`_box_pass`.
    """
    half = 0.5 * side
    gapx = torch.clamp(torch.maximum((cx - half) - bmx[..., 0:1],
                                     bmn[..., 0:1] - (cx + half)), min=0.0)
    gapy = torch.clamp(torch.maximum((cy - half) - bmx[..., 1:2],
                                     bmn[..., 1:2] - (cy + half)), min=0.0)
    d2 = gapx * gapx + gapy * gapy
    return (side * side < theta2 * (d2 + soft2)) & (d2 > 0)


def _hier_lists(tree: Tree, gmin, gmax, theta2, soft2, *, g_pad: int,
                sizes, kcaps):
    """Multi-level chunk candidate refinement (the hier traversal's core).

    The conservative group MAC is monotone in the box as well as down the
    tree: shrinking the query box can only grow the box-to-cell gap, so
    ``pass(chunk) => pass(any sub-box)``. Contrapositively, a node can be
    accepted by some group g (``pass_g(n) & ~pass_g(parent)``) or taken
    direct (``~pass_g(n)``) only if ``~pass_c(parent(n))`` for every
    enclosing chunk box c, i.e. only candidates

        cand_c = { n occupied : n is root  or  ~pass_c(parent(n)) }

    can matter to any group inside c. The refinement runs this rule at a
    cascade of chunk granularities (``sizes`` groups per chunk, descending,
    each dividing the previous), compacting the per-chunk candidate set at
    each level, so no compaction ever runs over the full node table times
    the full group count. A level's list is never wider than the list it
    refines (its candidates are a subset), whatever its cap says. Returns
    the final level's candidate ids (C, K) and validity, the chunk count,
    and the exact need of every level.
    """
    rows_all = tree.node_rows
    NC = rows_all.shape[0]
    dev = rows_all.device
    node_occ = (_arange(NC, dev) < tree.n_nodes) & (rows_all[:, 0] > 0)
    is_root = rows_all[:, 13] == 0.0

    ids = valid = None
    C_prev = 1
    needs = []
    for sz, kcap in zip(sizes, kcaps):
        C = g_pad // sz
        bmn = gmin.reshape(C, sz, 2).amin(dim=1)
        bmx = gmax.reshape(C, sz, 2).amax(dim=1)
        parts = []
        if ids is None:
            # against the full node table; row-chunked to bound the mask
            batch = max(1, min(C, (1 << 25) // NC))
            for c0 in range(0, C, batch):
                pp = _box_pass_cols(bmn[c0:c0 + batch], bmx[c0:c0 + batch],
                                    rows_all[None, :, 10],
                                    rows_all[None, :, 11],
                                    rows_all[None, :, 12], theta2, soft2)
                m = node_occ[None, :] & (is_root[None, :] | ~pp)
                parts.append(_compact_rows(m, kcap))
        else:
            r = C // C_prev
            Kp = ids.shape[1]
            kcap = min(kcap, Kp)
            batch = _batch_rows(r * Kp, C_prev)
            for c0 in range(0, C_prev, batch):
                c = slice(c0, c0 + batch)
                pid = torch.where(valid[c], ids[c], 0)
                crows = rows_all[pid.long()]                  # (b, Kp, 14)
                n = crows.shape[0]
                occ = valid[c] & (crows[..., 0] > 0)
                pp = _box_pass_cols(
                    bmn[c0 * r:(c0 + n) * r].reshape(n, r, 2),
                    bmx[c0 * r:(c0 + n) * r].reshape(n, r, 2),
                    crows[..., 10][:, None, :], crows[..., 11][:, None, :],
                    crows[..., 12][:, None, :], theta2, soft2)
                m = occ[:, None, :] & ((crows[..., 13] == 0.0)[:, None, :]
                                       | ~pp)                 # (b, r, Kp)
                idx, length, total = _compact_rows(m.reshape(n * r, Kp),
                                                   kcap)
                parts.append((torch.gather(
                    pid.repeat_interleave(r, dim=0), 1, idx.long()),
                    length, total))
        ids, length, total = (torch.cat(x) for x in zip(*parts))
        valid = _arange(kcap, dev)[None, :] < length[:, None]
        needs.append(total.max())
        C_prev = C
    return ids, valid, C_prev, needs


def _hier_levels(G: int, NC: int, hier_sizes, cand_caps):
    """Effective refinement levels: strictly descending sizes below G, each
    dividing the one before, with per-level candidate caps clipped to the
    node table. ``lvl_map`` keeps the configured index of each effective
    level so the reported needs line up with the configured cand_caps."""
    sizes, kcaps, lvl_map = [], [], []
    for i, (s, c) in enumerate(zip(hier_sizes, cand_caps)):
        if s < G and (not sizes or (s < sizes[-1] and sizes[-1] % s == 0)):
            sizes.append(int(s))
            kcaps.append(min(int(c), NC))
            lvl_map.append(i)
    if not sizes:
        sizes = [G]
        kcaps = [min(int(cand_caps[-1]), NC)]
        lvl_map = [len(hier_sizes) - 1]
    return sizes, kcaps, lvl_map


def _hier_needs(rows_all, ids, cvalid, bmn, bmx, theta2, soft2, *, LC: int,
                batch: int):
    """leaf_need and direct_need of the hier lists: per final chunk, the
    direct leaves of the chunk box (``occ & leaf & ~pass_chunk``, a
    superset of every member group's, since ``pass_chunk => pass_g``)
    counted, and the bodies of the first ``LC`` of them in candidate order
    summed, as the masked-dense form compacts and flattens them. ``bmn`` /
    ``bmx`` (C, 2) are the chunk boxes; ``batch`` chunks at a time."""
    C = ids.shape[0]
    l_tots, d_tots = [], []
    for c0 in range(0, C, batch):
        c = slice(c0, c0 + batch)
        crows = rows_all[torch.where(cvalid[c], ids[c], 0).long()]
        occ = cvalid[c] & (crows[..., 0] > 0)                  # (n, K)
        pcn = _box_pass_cols(bmn[c], bmx[c], crows[..., 3], crows[..., 4],
                             crows[..., 5], theta2, soft2)
        dleaf = occ & (crows[..., 6] < 0) & ~pcn
        rank = torch.cumsum(dleaf, dim=1, dtype=torch.int32)
        kept = dleaf & (rank <= LC)
        l_tots.append(rank[:, -1])
        d_tots.append(torch.where(kept, crows[..., 9].to(torch.int32),
                                  0).sum(dim=1, dtype=torch.int32))
    return torch.cat(l_tots).max(), torch.cat(d_tots).max()


def _hier_accel(tree: Tree, gstart, gvalid, gmin, gmax, theta2, soft2, *,
                group_size: int, hier_sizes, cand_caps, leaf_list_cap: int,
                direct_body_cap: int, hier_batch: int, gcount,
                evaluate: bool = True, probe=None):
    """BH force evaluation over hierarchical chunk candidates.

    Per final-level chunk (``hier_sizes[-1]`` adjacent groups) the member
    groups share one candidate list (:func:`_hier_lists`); each group
    accepts ``pass_g(n) & ~pass_g(parent)`` and takes the leaves with
    ``~pass_g(n)`` direct, the local monotone-MAC tests of
    :func:`_classify_dense`, so the interaction sets are the dense
    traversal's. :func:`hier_accel` evaluates them: ``csrc/bh_hier.cu`` on
    the card, which tests and walks the lists itself, and the masked-dense
    :func:`hier_accel_ref` on the CPU. The needs are measured here
    (:func:`_hier_needs`), ``hier_batch`` chunks at a time, whichever
    evaluates. With ``evaluate`` false no pair is summed and the
    accelerations are zeros: a pass that only measures the needs.

    Returns (acc_rows (G, group_size, 2), needs dict).
    """
    cap, _ = tree.spos.shape
    G = gvalid.shape[0]
    rows_all = tree.node_rows
    NC = rows_all.shape[0]
    dev = gvalid.device
    GS = group_size
    tally = getattr(probe, "pairs", None)
    probe = probe or (lambda name: None)

    sizes, kcaps, lvl_map = _hier_levels(G, NC, hier_sizes, cand_caps)
    CH = sizes[-1]
    g_pad = -(-G // sizes[0]) * sizes[0]

    def padg(x, fill):
        if g_pad == G:
            return x
        return torch.cat([x, torch.full((g_pad - G,) + x.shape[1:], fill,
                                        dtype=x.dtype, device=dev)])

    big = torch.finfo(gmin.dtype).max
    gminp = padg(gmin, big)
    gmaxp = padg(gmax, -big)

    ids, cvalid, C, lvl_needs = _hier_lists(
        tree, gminp, gmaxp, theta2, soft2, g_pad=g_pad, sizes=sizes,
        kcaps=kcaps)
    LC = min(leaf_list_cap, ids.shape[1])  # a chunk's leaves are candidates
    leaf_need, direct_need = _hier_needs(
        rows_all, ids, cvalid, gminp.reshape(C, CH, 2).amin(dim=1),
        gmaxp.reshape(C, CH, 2).amax(dim=1), theta2, soft2, LC=LC,
        batch=min(hier_batch, C))
    probe("lists")

    if evaluate:
        gcp = padg(gcount, 0)
        out = hier_accel(
            rows_all, tree.body_rows, tree.spos, ids, cvalid,
            padg(gstart, cap), gcp, padg(gvalid, False), gminp, gmaxp,
            theta2, soft2, group_size=GS, leaf_list_cap=LC,
            direct_body_cap=direct_body_cap, hier_batch=hier_batch,
            counts=tally is not None)
        if tally is not None:
            acc, counts, walked = out
            tally(walked, (gcp.to(torch.int64) * counts.sum(dim=1)).sum())
        else:
            acc = out
        acc_rows = acc[:G]
    else:
        acc_rows = torch.zeros((G, GS, 2), dtype=tree.spos.dtype, device=dev)
    probe("evaluate")

    cand_need = torch.zeros((len(hier_sizes),), dtype=torch.int32, device=dev)
    for li, n in zip(lvl_map, lvl_needs):
        cand_need[li] = n
    needs = {"leaf_need": leaf_need, "direct_need": direct_need,
             "cand_need": cand_need}
    return acc_rows, needs


def hier_accel_ref(node_rows, body_rows, spos, ids, cvalid, gstart, gcount,
                   gvalid, gmin, gmax, theta2, soft2, *, group_size: int,
                   leaf_list_cap: int, direct_body_cap: int,
                   hier_batch: int = 32, counts: bool = False,
                   pair_sum=None):
    """Plain version of :func:`hier_accel`: the masked-dense evaluation.

    Per chunk of ``hier_batch`` final chunks (fewer where the pair budget
    says so), the per-group accept masks over the shared candidates become
    per-group weights on dense (group_size x K) pair blocks; the chunk's
    direct leaves (chunk-box MAC) are compacted, at most ``leaf_list_cap``
    of them, their body ranges flatten through :func:`_flatten_ranges` into
    ``direct_body_cap`` partner slots, and the per-(group, slot) weights
    are the per-group leaf masks gathered at each slot's leaf. The pair
    blocks go through ``pair_sum`` (default :func:`point_accel`: the
    ``bh_pairs`` kernel for CUDA tensors). Rows outside a group's members
    are zero. With ``counts``, also returns each group's accepted nodes and
    direct partner slots (groups, 2) int32 and the pair slots the blocks
    compute (a Python int, padding included)."""
    C, K = ids.shape
    Gp = gstart.shape[0]
    CH = Gp // C
    GS = group_size
    dev = ids.device
    LC, DB = min(leaf_list_cap, K), direct_body_cap
    pair = point_accel if pair_sum is None else pair_sum
    elems = GS if pair_sum is not None else _pair_elems(GS, dev)

    bmn_all = gmin.reshape(C, CH, 2)
    bmx_all = gmax.reshape(C, CH, 2)
    gv_all = gvalid.reshape(C, CH)
    bpos_all, sl0 = _group_bodies(spos, gstart, GS)
    bpos_all = bpos_all.reshape(C, CH, GS, 2)
    slot = sl0[:, None] + _arange(GS, dev)[None, :]
    member = (gvalid[:, None] & (slot >= gstart[:, None])
              & (slot < (gstart + gcount)[:, None])).reshape(C, CH, GS)

    Cb = _batch_rows(CH * max(K, DB), min(hier_batch, C))
    eb = _batch_rows(CH * elems * max(K, DB), Cb)
    acc = torch.zeros((C, CH, GS, 2), dtype=spos.dtype, device=dev)
    cnt = torch.zeros((C, CH, 2), dtype=torch.int32, device=dev)
    walked = 0
    for c0 in range(0, C, Cb):
        c = slice(c0, min(c0 + Cb, C))
        bmn, bmx, gv = bmn_all[c], bmx_all[c], gv_all[c]
        crows = node_rows[torch.where(cvalid[c], ids[c], 0).long()]
        n = crows.shape[0]                                    # (n, K, 14)
        occ = cvalid[c] & (crows[..., 0] > 0)

        # ---- per-group accept weights over the shared candidates ----
        pn = _box_pass_cols(bmn, bmx, crows[..., 3][:, None, :],
                            crows[..., 4][:, None, :],
                            crows[..., 5][:, None, :], theta2, soft2)
        pp = _box_pass_cols(bmn, bmx, crows[..., 10][:, None, :],
                            crows[..., 11][:, None, :],
                            crows[..., 12][:, None, :], theta2, soft2) \
            & (crows[..., 13] != 0.0)[:, None, :]
        accept = occ[:, None, :] & gv[..., None] & pn & ~pp   # (n, CH, K)
        wapx = torch.where(accept, crows[..., 0][:, None, :], 0.0)
        del pn, pp, accept

        # ---- chunk-level direct leaf list ----
        pcn = _box_pass_cols(bmn.amin(dim=1), bmx.amax(dim=1), crows[..., 3],
                             crows[..., 4], crows[..., 5], theta2, soft2)
        dleaf = occ & (crows[..., 6] < 0) & ~pcn              # (n, K)
        lidx, llen, _ = _compact_rows(dleaf, LC)
        lrows = torch.gather(crows, 1,
                             lidx.long()[..., None].expand(n, LC, 14))
        lvalid = _arange(LC, dev)[None, :] < llen[:, None]
        lstart = lrows[..., 8].to(torch.int32)
        lcount = torch.where(lvalid, lrows[..., 9].to(torch.int32), 0)
        # per-(group, leaf) direct mask, recomputed on the compacted rows
        pnl = _box_pass_cols(bmn, bmx, lrows[..., 3][:, None, :],
                             lrows[..., 4][:, None, :],
                             lrows[..., 5][:, None, :], theta2, soft2)
        dmask = (lvalid & (lrows[..., 0] > 0))[:, None, :] & gv[..., None] \
            & ~pnl                                            # (n, CH, LC)

        # ---- partner flatten ----
        slots, leaf, svalid, _ = _flatten_ranges(lstart, lcount, DB)
        wdir = torch.gather(dmask, 2, leaf[:, None, :].expand(n, CH, DB))
        wdir = wdir & svalid[:, None, :]                      # (n, CH, DB)
        prow = body_rows[slots.long()]                        # (n, DB, 4)
        ppos = prow[..., 0:2].contiguous()                    # (n, DB, 2)
        com = crows[..., 1:3].contiguous()                    # (n, K, 2)
        if counts:
            cnt[c] = torch.stack([(wapx != 0).sum(-1, dtype=torch.int32),
                                  wdir.sum(-1, dtype=torch.int32)], dim=-1)
            walked += (wapx.numel() + wdir.numel()) * GS

        # ---- masked-dense pair blocks ----
        bpos, acc_c, mem = bpos_all[c], acc[c], member[c]     # views
        for e0 in range(0, n, eb):
            e = slice(e0, e0 + eb)
            out = pair(bpos[e], com[e], wapx[e], soft2)
            out += pair(bpos[e], ppos[e], prow[e][:, None, :, 2] * wdir[e],
                        soft2)
            acc_c[e] = out * mem[e][..., None]
    acc = acc.reshape(Gp, GS, 2)
    return (acc, cnt.reshape(Gp, 2), walked) if counts else acc


def hier_accel(node_rows, body_rows, spos, ids, cvalid, gstart, gcount,
               gvalid, gmin, gmax, theta2, soft2, *, group_size: int,
               leaf_list_cap: int, direct_body_cap: int,
               hier_batch: int = 32, counts: bool = False):
    """Accelerations (groups, group_size, 2) without G of every group's
    member bodies, from its chunk's candidates (module docstring; the
    definitions are ``csrc/bh_hier.cu``'s header).

    ``node_rows`` (NC, 14) and ``body_rows`` (cap, 4) are the tree's
    tables, ``spos`` (cap, 2) the sorted positions, ``ids`` / ``cvalid``
    (C, K) int32 / bool each final chunk's candidates, ``gstart``,
    ``gcount`` (groups,) int32, ``gvalid`` (groups,) bool and ``gmin`` /
    ``gmax`` (groups, 2) the groups padded to groups = C x CH, as
    :func:`_hier_accel` pads them. Row ``gstart - sl0 + i`` of a group's
    window (``sl0`` = ``clamp(gstart, 0, cap - group_size)``) holds member
    i; every other row is zero. With ``counts``, also returns each group's
    accepted nodes and direct bodies (groups, 2) int32 and the pairs
    walked.

    CPU tensors take :func:`hier_accel_ref`; CUDA tensors launch
    ``csrc/bh_hier.cu`` (counted in :data:`HIER_LAUNCHES`; the walked
    pairs are then a 0-dim int64 device tensor: each group's sources times
    the target slots of its lanes). The kernel drops nothing at
    ``leaf_list_cap`` and ``direct_body_cap``, which the plain version
    does: the two agree wherever no cap overflows (ROADMAP section 3)."""
    tensors = (node_rows, body_rows, spos, ids, cvalid, gstart, gcount,
               gvalid, gmin, gmax)
    specs = _hier_specs(*tensors)
    for name, t, shape, dtype, _ in specs:
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
    if all(t.device.type == "cpu" for t in tensors):
        return hier_accel_ref(
            *tensors, theta2, soft2, group_size=group_size,
            leaf_list_cap=leaf_list_cap, direct_body_cap=direct_body_cap,
            hier_batch=hier_batch, counts=counts)
    cap = spos.shape[0]
    if not 1 <= group_size <= min(cap, _HIER_MAX_GS):
        raise ValueError(f"group_size {group_size}: the kernel holds 1 to "
                         f"{min(cap, _HIER_MAX_GS)} targets a group")
    for name, t, shape, dtype, align in specs:
        _build.check_tensor(name, t, shape, device=ids.device, align=align,
                            dtype=dtype)
    return _hier_launch(*tensors, theta2, soft2, group_size, counts)


def _hier_specs(node_rows, body_rows, spos, ids, cvalid, gstart, gcount,
                gvalid, gmin, gmax):
    """(name, tensor, shape, dtype, alignment) of every :func:`hier_accel`
    argument; shapes follow ``node_rows``, ``spos``, ``ids`` and
    ``gstart``."""
    if ids.dim() != 2 or gstart.dim() != 1:
        raise ValueError(f"ids must be (C, K) and gstart (groups,), got "
                         f"{tuple(ids.shape)} and {tuple(gstart.shape)}")
    C, K = ids.shape
    Gp = gstart.shape[0]
    if C < 1 or Gp % C:
        raise ValueError(f"{Gp} groups do not split into {C} chunks")
    f32, i32 = torch.float32, torch.int32
    return [("node_rows", node_rows, (node_rows.shape[0], 14), f32, 8),
            ("body_rows", body_rows, (spos.shape[0], 4), f32, 16),
            ("spos", spos, (spos.shape[0], 2), f32, 8),
            ("ids", ids, (C, K), i32, 4),
            ("cvalid", cvalid, (C, K), torch.bool, 1),
            ("gstart", gstart, (Gp,), i32, 4),
            ("gcount", gcount, (Gp,), i32, 4),
            ("gvalid", gvalid, (Gp,), torch.bool, 1),
            ("gmin", gmin, (Gp, 2), f32, 4),
            ("gmax", gmax, (Gp, 2), f32, 4)]


def _hier_launch(node_rows, body_rows, spos, ids, cvalid, gstart, gcount,
                 gvalid, gmin, gmax, theta2, soft2, GS: int, counts: bool,
                 stage: int = _HIER_STAGE):
    """Launch ``csrc/bh_hier.cu`` on checked arguments, staging ``stage``
    leaf bodies at once (at most :data:`_HIER_STAGE`)."""
    global HIER_LAUNCHES
    dev = ids.device
    Gp = gstart.shape[0]
    C, K = ids.shape
    out = torch.zeros((Gp, GS, 2), dtype=torch.float32, device=dev)
    cnt = walked = None
    if counts:
        cnt = torch.zeros((Gp, 2), dtype=torch.int32, device=dev)
        walked = torch.zeros((), dtype=torch.int64, device=dev)
    # each chunk's last valid candidate + 1: the lists are padded to the
    # widest chunk's, and the kernel stops there
    kend = (cvalid * _arange(K, dev).add_(1)).amax(dim=1).to(torch.int32) \
        if K else torch.zeros((C,), dtype=torch.int32, device=dev)
    ptr = (lambda t: None if t is None else t.data_ptr())   # noqa: E731
    rc = _build.library().tnt_bh_hier(
        node_rows.data_ptr(), body_rows.data_ptr(), spos.data_ptr(),
        ids.data_ptr(), cvalid.data_ptr(), kend.data_ptr(), gstart.data_ptr(),
        gcount.data_ptr(), gvalid.data_ptr(), gmin.data_ptr(),
        gmax.data_ptr(), out.data_ptr(), ptr(cnt), ptr(walked), Gp, K,
        Gp // C, GS, spos.shape[0], node_rows.shape[0], stage,
        ctypes.c_float(float(theta2)), ctypes.c_float(float(soft2)),
        _build.stream(dev))
    _build.check_launch("bh_hier", rc)
    with _COUNT_LOCK:
        HIER_LAUNCHES += 1
    return (out, cnt, walked) if counts else out


def hier_pair_work(counts, gcount, node_rows, body_rows, ids) -> dict:
    """Pairs, flops and bytes of one :func:`hier_accel` call: the pairs its
    groups need (members times accepted nodes and direct bodies, from
    ``counts`` (groups, 2)), the node table, body rows, positions and
    candidate lists read once and each member's acceleration written
    once."""
    pairs = int((gcount.to(torch.int64) * counts.sum(dim=1)).sum())
    n = int(gcount.sum())
    return dict(pairs=pairs, flops=pairs * _PAIR_FLOPS,
                bytes=(node_rows.numel() + body_rows.numel()) * 4
                + ids.numel() * 5 + gcount.numel() * 25 + n * (8 + 8))


def _point_accel(bpos, src_pos, src_mass, soft2):
    """Blocked point-mass kernel: sum_j m_j * d_ij * r_ij^-3 (no G), the
    plain version of :func:`point_accel`.

    ``bpos`` (..., B, 2) targets, ``src_pos`` (..., S, 2) sources and
    ``src_mass`` (..., S) with broadcast-compatible leading dims; returns
    (..., B, 2). Every pair temporary is (..., B, S).
    """
    dx = src_pos[..., None, :, 0] - bpos[..., :, None, 0]
    dy = src_pos[..., None, :, 1] - bpos[..., :, None, 1]
    r2 = dx * dx + dy * dy + soft2
    w = src_mass[..., None, :] * torch.rsqrt(r2) / r2
    return torch.stack([(w * dx).sum(dim=-1), (w * dy).sum(dim=-1)], dim=-1)


class PairsPlan(NamedTuple):
    """Launch shape of ``csrc/bh_pairs.cu``: a CTA a (target set, split),
    ``lanes`` lanes of ``tpg`` threads, each thread ``T`` targets; each
    set's sources dealt to its ``splits`` CTAs in units of
    :data:`_PAIRS_UNIT` slots, round robin."""
    T: int
    tpg: int
    lanes: int
    threads: int
    splits: int = 1


def _pairs_plan(NT: int, T: int = 8, *, S: int = 0, sets: int = 1,
                ctas: int = 0) -> PairsPlan:
    """The pair kernel's launch shape for ``sets`` sets of ``NT`` targets
    and ``S`` sources: ``T`` halved until it is at most NT, ``tpg`` =
    ⌈NT/T⌉ threads hold a set, and as many lanes of them as fit in about
    :data:`_PAIRS_THREADS` threads (the source tiles are shared out among
    the lanes). At the group size 512, tpg = 64: a lane is two whole warps.
    ``ctas``, the CTAs of that shape the card holds at once
    (:func:`_pairs_ctas`; 0: one split), sets ``splits``: the sets' CTAs
    fill half the card (a CTA's fixed costs, its targets, lane sums and
    partial, outweigh its share of the pairs past that on the card's
    dense traversal shapes), each CTA with a unit of :data:`_PAIRS_UNIT`
    sources at least, at most :data:`_PAIRS_MAX_SPLITS` a set and as many
    as keep the partial sums within :data:`_PAIRS_SCRATCH` bytes."""
    if T not in (1, 2, 4, 8):
        raise ValueError(f"T must be 1, 2, 4 or 8, got {T}")
    if NT < 1:
        raise ValueError(f"a pair launch needs targets, got {NT}")
    while T > NT:
        T //= 2
    tpg = -(-NT // T)
    if tpg > 1024:
        raise ValueError(f"{NT} targets a set need {tpg} threads of {T}; "
                         f"at most 1024")
    lanes = max(1, _PAIRS_THREADS // tpg)
    splits = 1
    if ctas > 0 and S > 0 and sets > 0:
        splits = max(1, min(-(-ctas // (2 * sets)),
                            _PAIRS_MAX_SPLITS, -(-S // _PAIRS_UNIT),
                            _PAIRS_SCRATCH // (sets * NT * 8)))
    return PairsPlan(T=T, tpg=tpg, lanes=lanes, threads=tpg * lanes,
                     splits=splits)


@functools.lru_cache(maxsize=None)
def _pairs_ctas(device_index: int, T: int, tpg: int, lanes: int) -> int:
    """CTAs of the pair kernel's shape the card holds at once (its SMs
    times the occupancy API's count), asked once a (device, shape)."""
    with torch.cuda.device(device_index):
        per_sm = _build.library().tnt_bh_pairs_blocks_per_sm(T, tpg, lanes)
        n_sm = torch.cuda.get_device_properties(
            device_index).multi_processor_count
    if per_sm < 1:
        raise RuntimeError(f"bh_pairs: no occupancy for T={T}, tpg={tpg}, "
                           f"lanes={lanes}")
    return n_sm * per_sm


def pair_work(masses, NT: int) -> dict:
    """Pairs, flops and bytes of one :func:`point_accel` call on
    ``masses`` (M, C, S) with ``NT`` targets a set: the pairs its nonzero
    masses need (what the kernel cannot skip is no more than the tiles
    holding them), the targets, sources and masses read once and the
    accelerations written once."""
    M, C, S = masses.shape
    pairs = int((masses != 0).sum()) * NT
    return dict(pairs=pairs, flops=pairs * _PAIR_FLOPS,
                bytes=4 * (M * C * NT * 2 * 2 + M * S * 2 + M * C * S))


def point_accel(targets, sources, masses, soft2):
    """Point-mass pair blocks: targets (M, C, NT, 2), sources (M, S, 2)
    shared by the C target sets of a row, masses (M, C, S) one set each;
    returns (M, C, NT, 2), sum_j m_j d_ij r_ij^-3 without G. CPU tensors
    take :func:`_point_accel`; CUDA tensors launch ``csrc/bh_pairs.cu``,
    which deals each set's sources to CTAs that fill the card
    (:func:`_pairs_plan`), adds their sums in a fixed order (the same
    bits from run to run) and skips every unit of sources whose masses
    are all 0 for a set (no change in the result)."""
    if all(t.device.type == "cpu" for t in (targets, sources, masses)):
        return point_accel_ref(targets, sources, masses, soft2)
    M, C, NT, _ = targets.shape
    S = sources.shape[1]
    dev = targets.device
    _build.check_tensor("targets", targets, (M, C, NT, 2), align=8)
    _build.check_tensor("sources", sources, (M, S, 2), device=dev, align=8)
    _build.check_tensor("masses", masses, (M, C, S), device=dev)
    if M * C * NT == 0:
        return torch.zeros_like(targets)
    plan = _pairs_plan(NT)
    plan = _pairs_plan(NT, S=S, sets=M * C, ctas=_pairs_ctas(
        dev.index, plan.T, plan.tpg, plan.lanes))
    return _pairs_launch(targets, sources, masses, soft2, plan)


def point_accel_ref(targets, sources, masses, soft2):
    """Plain version of :func:`point_accel`, same arguments: the sources
    broadcast over the C sets of a row into :func:`_point_accel`."""
    return _point_accel(targets, sources[:, None], masses, soft2)


def _pairs_launch(targets, sources, masses, soft2, plan: PairsPlan):
    """Launch the pair kernel with ``plan`` on checked arguments; a split
    plan whose partial sums pass :data:`_PAIRS_SCRATCH` bytes raises."""
    global LAUNCHES
    M, C, NT, _ = targets.shape
    S = sources.shape[1]
    dev = targets.device
    sets, splits = M * C, plan.splits
    out = torch.empty_like(targets)
    scratch = (None, None, None)
    if splits > 1:
        if sets * splits * NT * 8 > _PAIRS_SCRATCH:
            raise ValueError(f"bh_pairs: {splits} splits of {sets} sets of "
                             f"{NT} targets need more than "
                             f"{_PAIRS_SCRATCH} bytes of partial sums")
        # the partial sums, then the flags (int32), in one buffer that
        # lives past the launch
        part = torch.empty((sets * splits * (NT * 2 + 1),),
                           dtype=torch.float32, device=dev)
        scratch = (part.data_ptr(),
                   part.data_ptr() + 4 * sets * splits * NT * 2,
                   _build.stream_counters(dev, "bh_pairs", sets).data_ptr())
    rc = _build.library().tnt_bh_pairs(
        targets.data_ptr(), sources.data_ptr(), masses.data_ptr(),
        out.data_ptr(), *scratch,
        M, C, NT, S, ctypes.c_float(float(soft2)), plan.T, plan.tpg,
        plan.lanes, splits, _build.stream(dev))
    _build.check_launch("bh_pairs", rc)
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out


def bh_accel_from_tree(tree: Tree, theta, soft2, G, *, group_size: int,
                       group_cap: int, max_depth: int, frontier_cap: int,
                       approx_cap: int, leaf_list_cap: int,
                       direct_body_cap: int, group_chunk: int,
                       traversal: str = "dense",
                       hier_sizes: tuple = (1024, 64, 8),
                       cand_caps: tuple = (65536, 16384, 4096),
                       hier_batch: int = 32, evaluate: bool = True,
                       probe=None):
    """BH accelerations for all bodies; returns (acc, stats).

    ``acc`` is in original body order; ``stats`` is a
    :class:`TraversalStats` of 0-dim device tensors (nothing here reads the
    device). ``traversal`` selects how the lists are built: ``"dense"``,
    ``"hier"`` or ``"bfs"`` (module docstring). dense and bfs produce bit-identical
    lists and forces; hier agrees with dense to float32 summation order.
    ``theta``, ``soft2`` and ``G`` are Python floats, rounded to float32 as
    the JAX package's scalars are. With ``evaluate`` false the lists are
    built and measured but no pair block is evaluated: ``acc`` is zeros and
    ``stats`` is what the full pass would report.

    ``probe(name)``, where given, is called as each phase's work is
    enqueued: ``"groups"``, ``"lists"``, ``"evaluate"`` and
    ``"assemble"``. A probe with a ``pairs(padded, needed)`` method also
    gets, for each evaluation call, the pairs it computes (dense and the
    plain hier: a Python int, padding included; the hier kernel: the
    pairs its CTAs walk, a 0-dim device tensor) and the pairs its groups
    need (a 0-dim device tensor: each group's bodies times its accepted
    nodes and direct partners), hier and dense traversals.
    """
    if traversal not in TRAVERSALS:
        raise ValueError(f"unknown traversal {traversal!r}: expected one of "
                         f"{TRAVERSALS}")
    cap, _ = tree.spos.shape
    dev = tree.spos.device
    i32 = torch.int32
    GS = min(group_size, cap)
    # theta^2 as the JAX package forms it: a float32 product
    theta2 = float(np.float32(theta) * np.float32(theta))
    NC = tree.code.shape[0]
    group_cap = min(group_cap, NC)  # at most one group per node
    spos = tree.spos
    tally = getattr(probe, "pairs", None)
    probe = probe or (lambda name: None)

    gvalid, gstart, gcount, n_groups = make_groups(tree, GS, group_cap)
    gmin, gmax = _group_aabb(spos, gstart, gcount, gvalid, GS)

    # Coverage guard (see TraversalStats): the largest leaf population.
    # Only a max-depth leaf can exceed leaf_size, so this stays small unless
    # the scene collapses > group_size bodies into one max-depth cell.
    node_valid = _arange(NC, dev) < tree.n_nodes
    leaf_max = torch.where(node_valid & (tree.child < 0), tree.count,
                           0).max()
    zero = torch.zeros((), dtype=i32, device=dev)
    probe("groups")

    if traversal == "hier":
        acc_rows, needs = _hier_accel(
            tree, gstart, gvalid, gmin, gmax, theta2, soft2, group_size=GS,
            hier_sizes=hier_sizes, cand_caps=cand_caps,
            leaf_list_cap=leaf_list_cap, direct_body_cap=direct_body_cap,
            hier_batch=hier_batch, gcount=gcount, evaluate=evaluate,
            probe=probe)
        stats = TraversalStats(
            approx_need=zero, leaf_need=needs["leaf_need"],
            direct_need=needs["direct_need"], frontier_need=zero,
            group_need=n_groups, node_need=tree.node_need,
            group_size_need=leaf_max, cand_need=needs["cand_need"])
        out = G * _assemble(tree, acc_rows, gstart, GS, group_cap)
        probe("assemble")
        return out, stats

    # Chunk the traversal over groups: the BFS path's per-wave temporaries
    # are (groups x frontier_cap x 14-lane rows) and the dense path's masks
    # are (groups x num_nodes).
    if traversal == "dense":
        tchunk = max(64, (1 << 25) // max(NC, 1))
    else:
        tchunk = 4096
    tchunk = min(group_cap, tchunk)
    parts = []
    for g0 in range(0, group_cap, tchunk):
        gmn, gmx, gv = (x[g0:g0 + tchunk] for x in (gmin, gmax, gvalid))
        if traversal == "dense":
            apx, al, lv, ll, a_tot, l_tot = _classify_dense(
                tree, gmn, gmx, gv, theta2, soft2, approx_cap=approx_cap,
                leaf_list_cap=leaf_list_cap)
            fn = torch.zeros_like(a_tot)
        else:
            apx, al, lv, ll, fn = _traverse_all(
                tree, gmn, gmx, gv, theta2, soft2, max_depth=max_depth,
                frontier_cap=frontier_cap, approx_cap=approx_cap,
                leaf_list_cap=leaf_list_cap)
            a_tot, l_tot = al, ll  # wave lengths count every append (uncapped)
        psl, pv, dn = _direct_partners_all(
            tree, lv, ll, direct_body_cap=direct_body_cap)
        parts.append((apx, al, psl, pv, dn, fn, a_tot, l_tot))
    approx, a_len, pslots, pvalid, d_need, f_need, a_need, l_need = (
        torch.cat(x) for x in zip(*parts))
    del parts
    probe("lists")

    # ---- force evaluation, chunked over groups (pure gather + math) ----
    bpos, _ = _group_bodies(spos, gstart, GS)                 # (G, GS, 2)
    gchunk = _batch_rows(_pair_elems(GS, dev)
                         * max(approx_cap, direct_body_cap), group_chunk)
    acc_rows = torch.zeros((group_cap, GS, 2), dtype=spos.dtype, device=dev)
    slot_a = _arange(approx_cap, dev)[None, :]
    for g0 in range(0, group_cap if evaluate else 0, gchunk):
        g = slice(g0, g0 + gchunk)
        avalid = slot_a < a_len[g][:, None]
        arows = tree.node_rows[torch.where(avalid, approx[g], 0).long()]
        tgt = bpos[g][:, None]                                # (g, 1, GS, 2)
        acc = point_accel(tgt, arows[..., 1:3].contiguous(),
                          torch.where(avalid, arows[..., 0], 0.0)[:, None],
                          soft2)
        prow = tree.body_rows[pslots[g].long()]               # (g, DB, 4)
        acc += point_accel(tgt, prow[..., 0:2].contiguous(),
                           torch.where(pvalid[g], prow[..., 2],
                                       0.0)[:, None], soft2)
        acc_rows[g] = acc[:, 0] * gvalid[g][:, None, None]
        if tally is not None:
            tally(arows.shape[0] * GS * (approx_cap + direct_body_cap),
                  (gcount[g] * gvalid[g] * (a_len[g] + pvalid[g].sum(-1)))
                  .sum())
    probe("evaluate")

    stats = TraversalStats(
        approx_need=a_need.max(), leaf_need=l_need.max(),
        direct_need=d_need.max(), frontier_need=f_need.max(),
        group_need=n_groups, node_need=tree.node_need,
        group_size_need=leaf_max)
    out = G * _assemble(tree, acc_rows, gstart, GS, group_cap)
    probe("assemble")
    return out, stats


def _assemble(tree: Tree, acc_rows, gstart, GS: int, group_cap: int):
    """Scatter-free assembly: sorted slot -> (group, row) -> orig order."""
    cap = tree.spos.shape[0]
    s = _arange(cap, gstart.device)
    g_of_s = torch.clamp(torch.searchsorted(gstart, s, right=True) - 1,
                         0, group_cap - 1)
    sl0 = torch.clamp(gstart[g_of_s], 0, cap - GS)
    row = s - sl0
    in_range = (row >= 0) & (row < GS) & (s < tree.n_alive)
    acc_sorted = acc_rows[g_of_s, torch.clamp(row, 0, GS - 1).long()]
    acc_sorted = torch.where(in_range[:, None], acc_sorted, 0.0)
    return acc_sorted[tree.unsort.long()]
