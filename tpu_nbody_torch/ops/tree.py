"""Flat adaptive quadtree built on the device from Hilbert-sorted bodies
(port of tpu_nbody.ops.tree).

Replaces the reference's pointer-based recursive ``BHTree``
(``src/main/kotlin/BarnesHutAlg.kt:95-202``). After sorting bodies by
Hilbert code the whole adaptive tree is a pure function of the sorted code
array: every node is a contiguous body range delimited by code-prefix
boundaries. The build is branch-free and has no host sync:

1. Hilbert-encode and sort alive bodies (dead slots sort last).
2. Boundary analysis for all levels at once on ``(L, cap)`` arrays:
   boundary masks (``prefix[i] != prefix[i-1]``), per-body cell start and
   end by a running max and a reverse running min along the body axis
   (``torch.cummax``, and ``torch.cummin`` on the flipped array, where the
   JAX package uses ``associative_scan``), and a path-alive mask that
   descends only through internal (count > leaf_size) cells. A cell is a
   node iff every ancestor is internal; it is a leaf iff small enough or at
   max depth. Only occupied children exist (1-4 per internal node,
   contiguous ids).
3. The node table is materialised slot-wise: one flattened ``searchsorted``
   maps every node slot to (level, owner body), and each field is one
   gather from the pass-1 arrays. Cell geometry comes from the owner
   body's integer grid coordinates masked to the level.
4. Aggregates: every node is a contiguous range ``[start, end)`` of the
   sorted order, so mass and centre-of-mass numerators are prefix-sum
   differences. A plain float32 cumsum of 1M mass-weighted coordinates
   reaches ~1e8, and differencing it for a 4-body node would lose ~7
   absolute: percent-level centre-of-mass error. The JAX package carries a
   compensated (two-sum) float32 pair through its scan; PyTorch has no such
   scan, so the prefix here is a float64 ``cumsum`` of the float32 terms,
   differenced in float64 and rounded to the position dtype once. Its
   53-bit sums are at least as exact as the pair's ~2 x 24 bits.

Every integer field is int32 and bit-equal to the JAX package's for the
same float32 positions; ``mass`` and ``com`` agree to float32 rounding.

That plain form is :func:`build_tree_ref`, which CPU tensors take. On the
card :func:`build_tree` runs ``csrc/bh_tree.cu`` instead: the codes in one
kernel, the same stable ``torch.argsort``, then one cooperative launch that
finds each body's owned levels from its code and its neighbours' (no
``(L, cap)`` array), ranks the owners by warp ballots and writes the same
table, bit for bit in every integer field and the cell geometry, the
aggregates from float64 prefix sums summed in another order (float32
rounding apart).

The root quad matches the reference sizing: centred at (W/2, H/2) with
half-side max(W, H)/2 + 2 (``BarnesHutAlg.kt:359-362``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from tpu_nbody_torch.kernels import _build
from tpu_nbody_torch.ops import morton

_BIG = 2_000_000_000
# node_rows carries child, nchild, start and count as float32, exact only
# below 2^24
MAX_EXACT_ID = 1 << 24


def check_id_range(capacity: int, num_nodes: int):
    """Raise where a body slot or node id would not survive the float32
    columns of ``Tree.node_rows``."""
    if capacity > MAX_EXACT_ID or num_nodes > MAX_EXACT_ID:
        raise ValueError(
            f"capacity {capacity} or num_nodes {num_nodes} exceeds 2^24: "
            f"the packed node rows hold child, start and count as float32, "
            f"which is exact only below 2^24")


class Tree(NamedTuple):
    """Flat node table (capacity ``num_nodes``) + sorted body arrays.

    Nodes are grouped by level: all level-l nodes occupy one contiguous id
    block, children of one node are contiguous (``child .. child+n_children``).
    """

    # --- node table ---
    code: torch.Tensor        # (NC,) int32 Hilbert code of the range start
    level: torch.Tensor       # (NC,) int32 depth (root = 0)
    start: torch.Tensor       # (NC,) int32 first body (sorted order)
    count: torch.Tensor       # (NC,) int32 bodies in subtree
    child: torch.Tensor       # (NC,) int32 first child id, -1 for leaves
    n_children: torch.Tensor  # (NC,) int32 number of occupied children (0-4)
    parent: torch.Tensor      # (NC,) int32 parent node, -1 for root
    mass: torch.Tensor        # (NC,) float total subtree mass
    com: torch.Tensor         # (NC, 2) float subtree centre of mass
    n_nodes: torch.Tensor     # () int32 nodes in use (clipped to NC)
    node_need: torch.Tensor   # () int32 nodes the scene requires (unclipped;
                              # > NC means deep levels were truncated)
    # One packed row per node, so a traversal fetches a node with one row
    # gather: [mass, comx, comy, cx, cy, side, child, nchild, start, count,
    # pcx, pcy, pside, has_parent]. The parent cell's geometry rides along
    # so the local accept test ``pass(n) & ~pass(parent(n))`` needs no
    # second gather. The layout is the JAX package's.
    node_rows: torch.Tensor   # (NC, 14) float32
    body_rows: torch.Tensor   # (cap, 4) float32: [x, y, exerted mass, 0]
    # --- sorted bodies ---
    spos: torch.Tensor        # (cap, 2) positions in Hilbert order
    smass: torch.Tensor       # (cap,) exerted mass in Hilbert order (0 = dead)
    sidx: torch.Tensor        # (cap,) int32 original index per sorted slot
    unsort: torch.Tensor      # (cap,) int32 inverse: orig -> sorted slot
    n_alive: torch.Tensor     # () int32
    # --- geometry ---
    origin: torch.Tensor      # (2,) root low corner
    root_side: torch.Tensor   # () root full side length

    def cell_geometry(self, node_ids):
        """(centre (..., 2), side) of each node's cell, from code + level.

        The decoded point of a range-start Hilbert code is some corner of
        the cell; masking low bits by level gives the low corner.
        """
        node_ids = node_ids.long()
        code = self.code[node_ids]
        lvl = self.level[node_ids]
        ix, iy = morton.hilbert2d_inverse(code)
        shift = morton.COORD_BITS - lvl
        ix = (ix >> shift) << shift
        iy = (iy >> shift) << shift
        units = torch.ones_like(shift) << shift
        unit_len = self.root_side / (1 << morton.COORD_BITS)
        side = units.to(self.root_side.dtype) * unit_len
        low = self.origin + torch.stack([ix, iy], -1).to(side.dtype) * unit_len
        return low + 0.5 * side[..., None], side


def build_tree(pos, mass_exert, alive, origin, root_side, *, num_nodes: int,
               leaf_size: int, max_depth: int) -> Tree:
    """Build the flat quadtree on ``pos``'s device. ``mass_exert`` must be
    0 for dead bodies; ``origin`` is a pair of floats and ``root_side`` a
    float.

    CPU tensors take :func:`build_tree_ref`; CUDA tensors launch
    ``csrc/bh_tree.cu`` (:func:`_tree_launch`, counted once a build as
    ``"bh_tree"``), which gives the same tree (module docstring). Shapes,
    ``max_depth``, ``leaf_size`` and the id range are checked on any
    device; a tensor off the CPU sends the call to the kernel's checks, so
    a device the kernels do not run on raises."""
    if pos.dim() != 2 or pos.shape[1] != 2 or pos.shape[0] < 1:
        raise ValueError(f"pos: expected shape (cap, 2) with cap >= 1, got "
                         f"{tuple(pos.shape)}")
    cap = pos.shape[0]
    for name, t in (("mass_exert", mass_exert), ("alive", alive)):
        if tuple(t.shape) != (cap,):
            raise ValueError(f"{name}: expected shape ({cap},), got "
                             f"{tuple(t.shape)}")
    if not 0 <= max_depth <= morton.COORD_BITS:
        raise ValueError(f"max_depth {max_depth}: the codes resolve levels "
                         f"0 .. {morton.COORD_BITS}")
    if leaf_size < 0:
        raise ValueError(f"leaf_size {leaf_size}: expected >= 0")
    check_id_range(cap, num_nodes)
    if all(t.device.type == "cpu" for t in (pos, mass_exert, alive)):
        return build_tree_ref(pos, mass_exert, alive, origin, root_side,
                              num_nodes=num_nodes, leaf_size=leaf_size,
                              max_depth=max_depth)
    dev = pos.device
    _build.check_tensor("pos", pos, (cap, 2), device=dev, align=8)
    _build.check_tensor("mass_exert", mass_exert, (cap,), device=dev)
    _build.check_tensor("alive", alive, (cap,), device=dev, align=1,
                        dtype=torch.bool)
    return _tree_launch(pos, mass_exert, alive, origin, root_side,
                        num_nodes, leaf_size, max_depth)


# the levels the kernel's owned-level masks hold (csrc/bh_tree.cu LEVELS)
_LEVELS = morton.COORD_BITS + 1


def _tree_scratch(cap: int, grid: int) -> int:
    """Bytes of ``csrc/bh_tree.cu``'s scratch (its ``carve``): the float64
    prefix sums of the three mass terms, each CTA's sums and owner counts
    a level, the sorted codes and each body's owned-level mask."""
    return 8 * 3 * (cap + 1) + 8 * 3 * grid + 4 * cap + 4 * _LEVELS * grid \
        + 2 * cap


@functools.lru_cache(maxsize=None)
def _tree_grid(device_index: int) -> int:
    """CTAs of the build's cooperative launch the card holds at once (its
    SMs times the occupancy API's count), asked once a device: the most
    such a launch may have."""
    with torch.cuda.device(device_index):
        per_sm = _build.library().tnt_bh_tree_blocks_per_sm()
        n_sm = torch.cuda.get_device_properties(
            device_index).multi_processor_count
    if per_sm < 1:
        raise RuntimeError("bh_tree: no occupancy for the build kernel")
    return n_sm * per_sm


# threads a CTA of the build (csrc/bh_tree.cu THREADS)
_TREE_THREADS = 256


def _geometry(origin, root_side) -> tuple:
    """(ox, oy, scale, unit, side) as float32 values: the root's low
    corner, the multiply of ``morton.cell_coords`` (2^15 / side, as torch
    rounds the Python scalar to the tensor's float32), a finest cell's
    side and the root's side, as the plain build rounds them."""
    ox, oy = (float(np.float32(v)) for v in origin)
    side = np.float32(root_side)
    return (ox, oy, float(np.float32((1 << morton.COORD_BITS) / float(side))),
            float(side / np.float32(1 << morton.COORD_BITS)), float(side))


def _codes_launch(pos, alive, geo: tuple):
    """``csrc/bh_tree.cu``'s codes kernel on checked CUDA tensors: the
    (cap,) int32 codes of ``morton.hilbert_codes``, bit for bit, on the
    current stream. Not counted: a build counts once, at its last launch."""
    codes = torch.empty((pos.shape[0],), dtype=torch.int32,
                        device=pos.device)
    ox, oy, scale = (ctypes.c_float(v) for v in geo[:3])
    _build.raise_on_error("bh_tree", _build.library().tnt_bh_codes(
        pos.data_ptr(), alive.data_ptr(), pos.shape[0], ox, oy, scale,
        codes.data_ptr(), _build.stream(pos.device)))
    return codes


def _tree_launch(pos, mass_exert, alive, origin, root_side, NC: int,
                 leaf_size: int, max_depth: int) -> Tree:
    """Launch ``csrc/bh_tree.cu`` on checked arguments: the codes kernel,
    ``torch.argsort`` of the codes (stable), then the cooperative build
    kernel (:func:`_sorted_launch`), all on the current stream; no host
    sync."""
    geo = _geometry(origin, root_side)
    codes = _codes_launch(pos, alive, geo)
    order = torch.argsort(codes, stable=True)
    return _sorted_launch(pos, mass_exert, codes, order, geo, NC, leaf_size,
                          max_depth)


def _sorted_launch(pos, mass_exert, codes, order, geo: tuple, NC: int,
                   leaf_size: int, max_depth: int) -> Tree:
    """The cooperative build kernel on the bodies' codes and their stable
    sort's ``order`` (int64) with the root's :func:`_geometry`, counted as
    one ``"bh_tree"`` launch; outputs from ``torch.empty`` (the kernel
    writes every entry)."""
    cap = pos.shape[0]
    dev = pos.device
    i32, f32 = torch.int32, torch.float32
    ints = torch.empty((7, NC), dtype=i32, device=dev)
    mass = torch.empty((NC,), dtype=f32, device=dev)
    com = torch.empty((NC, 2), dtype=f32, device=dev)
    rows = torch.empty((NC, 14), dtype=f32, device=dev)
    body_rows = torch.empty((cap, 4), dtype=f32, device=dev)
    spos = torch.empty((cap, 2), dtype=f32, device=dev)
    smass = torch.empty((cap,), dtype=f32, device=dev)
    idx = torch.empty((2, cap), dtype=i32, device=dev)
    scalars = torch.empty((3,), dtype=i32, device=dev)
    root = torch.empty((3,), dtype=f32, device=dev)
    grid = min(_tree_grid(dev.index), -(-cap // _TREE_THREADS))
    nbytes = _tree_scratch(cap, grid)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    fields = ints.unbind(0)
    sidx, unsort = idx.unbind(0)
    outs = (ctypes.c_void_p * 17)(
        *(t.data_ptr() for t in fields + (mass, com, rows, body_rows, spos,
                                          smass, sidx, unsort, scalars,
                                          root)))
    rc = _build.library().tnt_bh_tree(
        pos.data_ptr(), mass_exert.data_ptr(), codes.data_ptr(),
        order.data_ptr(), cap, NC, leaf_size, max_depth,
        *(ctypes.c_float(v) for v in geo), grid, scratch.data_ptr(), nbytes,
        outs, _build.stream(dev))
    _build.check_launch("bh_tree", rc)
    code, level, start, count, child, n_children, parent = fields
    n_nodes, node_need, n_alive = scalars.unbind(0)
    return Tree(code=code, level=level, start=start, count=count,
                child=child, n_children=n_children, parent=parent,
                mass=mass, com=com, n_nodes=n_nodes, node_need=node_need,
                node_rows=rows, body_rows=body_rows, spos=spos, smass=smass,
                sidx=sidx, unsort=unsort, n_alive=n_alive, origin=root[:2],
                root_side=root[2])


def build_work(cap: int, num_nodes: int) -> dict:
    """Bytes ``csrc/bh_tree.cu`` must move for a build of ``cap`` slots
    into a table of ``num_nodes`` slots, each once (no flops count): each
    body's position, exerted mass and flag read (13 bytes), its code
    written and read again (8) and the sort's order read (8), its sorted
    position, mass, body row, index and inverse written (36); each table
    slot's seven int32 fields, mass, centre of mass and 14-float row
    written (96); the three counts and the root's geometry (24). The sort
    itself is not counted."""
    return dict(flops=0, bytes=cap * (13 + 8 + 8 + 36) + 96 * num_nodes + 24)


def build_tree_ref(pos, mass_exert, alive, origin, root_side, *,
                   num_nodes: int, leaf_size: int, max_depth: int) -> Tree:
    """Plain version of :func:`build_tree` (the module docstring's steps
    1-4), same arguments and result, on ``pos``'s device."""
    cap = pos.shape[0]
    NC = num_nodes
    L = max_depth + 1
    check_id_range(cap, NC)
    dtype, dev = pos.dtype, pos.device
    i32 = torch.int32
    side_f = float(np.float32(root_side)) if dtype == torch.float32 \
        else float(root_side)
    origin_t = torch.as_tensor(origin, dtype=dtype, device=dev)
    root_side_t = torch.tensor(side_f, dtype=dtype, device=dev)

    codes = morton.hilbert_codes(pos, origin, side_f, alive)
    order = torch.argsort(codes, stable=True)
    scodes = codes[order]
    spos = pos[order]
    alive_sorted = alive[order]
    smass = torch.where(alive_sorted, mass_exert[order], 0.0)
    body_idx = torch.arange(cap, dtype=i32, device=dev)
    unsort = torch.empty_like(body_idx)
    unsort[order] = body_idx
    n_alive = alive.sum(dtype=i32)
    body_alive = body_idx < n_alive

    # ---- pass 1: boundary analysis, all levels batched on (L, cap) ----
    shifts = torch.tensor([2 * (morton.COORD_BITS - l) for l in range(L)],
                          dtype=i32, device=dev)
    lvl_col = torch.arange(L, dtype=i32, device=dev)[:, None]
    prefix = scodes[None, :] >> shifts[:, None]                  # (L, cap)
    prev = torch.cat([torch.full((L, 1), -1, dtype=i32, device=dev),
                      prefix[:, :-1]], dim=1)
    first = body_alive[None, :] & ((body_idx == 0) | (prefix != prev))
    del prefix, prev
    zero = torch.zeros((), dtype=i32, device=dev)
    big = torch.full((), _BIG, dtype=i32, device=dev)
    start_lv = torch.cummax(torch.where(first, body_idx, zero), dim=1).values
    nxt = torch.cummin(torch.where(first, body_idx, big).flip(1),
                       dim=1).values.flip(1)
    end_lv = torch.minimum(
        torch.cat([nxt[:, 1:], torch.full((L, 1), _BIG, dtype=i32,
                                          device=dev)], dim=1), n_alive)
    del nxt
    count_lv = end_lv - start_lv
    internal = (count_lv > leaf_size) & (lvl_col < max_depth)
    # path-alive: every strict ancestor internal (exclusive cumulative AND
    # down the level axis, as a zero-count of non-internal ancestors)
    blocked = torch.cumsum(~internal[:-1], dim=0, dtype=i32)
    blocked = torch.cat([torch.zeros((1, cap), dtype=i32, device=dev),
                         blocked], dim=0)
    is_node = body_alive[None, :] & (blocked == 0)
    del blocked
    is_leaf = is_node & ~internal
    owner = first & is_node
    del first, is_node, internal
    k_lv = torch.cumsum(owner, dim=1, dtype=i32)                 # (L, cap)
    del owner
    n_per = k_lv[:, -1]                                          # (L,)
    cum = torch.cat([zero[None], torch.cumsum(n_per, dim=0, dtype=i32)])
    node_need = cum[-1]
    n_nodes = torch.clamp(node_need, max=NC)

    # ---- pass 2: slot-wise materialisation (one searchsorted + gathers) --
    s = torch.arange(NC, dtype=i32, device=dev)
    lvl = torch.clamp(torch.searchsorted(cum, s, right=True) - 1, 0, L - 1)
    slot_valid = s < n_nodes
    j = s - cum[lvl]
    # owner body: binary search the owner-rank cumsum of the slot's level.
    # Rows are made globally monotone by a per-level offset > max rank, so
    # one flattened searchsorted answers every slot at once. The offsets
    # reach L * (cap + 2), inside int32 for every capacity below 2^24.
    stride = cap + 2
    k_flat = (k_lv + (torch.arange(L, dtype=i32, device=dev)
                      * stride)[:, None]).reshape(L * cap)
    b = torch.clamp(torch.searchsorted(k_flat, (j + 1 + lvl * stride).to(i32))
                    - lvl * cap, 0, cap - 1)
    del k_flat
    fi = lvl * cap + b                                           # int64

    def gat(arr2d, idx=None):
        return arr2d.reshape(L * cap)[fi if idx is None else idx]

    blk_start = torch.where(slot_valid, gat(start_lv), 0)
    blk_count = torch.where(slot_valid, gat(count_lv), 0)
    blk_end = torch.where(slot_valid, gat(end_lv), 0)
    blk_leaf = gat(is_leaf) & slot_valid
    shift_s = (2 * (morton.COORD_BITS - lvl)).to(i32)
    blk_code = torch.where(slot_valid, (scodes[b] >> shift_s) << shift_s, 0)
    # parent: rank of the owner's level-(l-1) cell; -1 for the root
    lvl_p = torch.clamp(lvl - 1, min=0)
    blk_parent = torch.where(slot_valid & (lvl > 0),
                             cum[lvl_p] + gat(k_lv, lvl_p * cap + b) - 1, -1)
    # child: rank of the owner's level-(l+1) cell (the owner body is a
    # boundary at every deeper level); occupied-child count = child-level
    # owners within [start, end)
    lvl_c = torch.clamp(lvl + 1, max=L - 1)
    child_fi = lvl_c * cap + b
    end_m1_fi = lvl_c * cap + torch.clamp(blk_end - 1, 0, cap - 1)
    has_child = slot_valid & ~blk_leaf & (lvl < max_depth)
    blk_child = torch.where(has_child, cum[lvl_c] + gat(k_lv, child_fi) - 1,
                            -1)
    blk_nc = torch.where(has_child,
                         gat(k_lv, end_m1_fi) - gat(k_lv, child_fi) + 1, 0)
    del k_lv, start_lv, end_lv, count_lv, is_leaf
    # cell geometry from the owner body's integer grid coords masked to the
    # level (every body in the cell shares the cell's coordinate prefix)
    unit_len = root_side_t / (1 << morton.COORD_BITS)
    sij = morton.cell_coords(spos, origin, side_f)[b]            # (NC, 2)
    gshift = (morton.COORD_BITS - lvl).to(i32)

    def cell(shift, valid):
        gx = (sij[:, 0] >> shift) << shift
        gy = (sij[:, 1] >> shift) << shift
        units = (torch.ones_like(shift) << shift).to(dtype)
        side = torch.where(valid, units * unit_len, 0.0)
        cx = torch.where(valid, origin_t[0] + (gx.to(dtype) + 0.5 * units)
                         * unit_len, 0.0)
        cy = torch.where(valid, origin_t[1] + (gy.to(dtype) + 0.5 * units)
                         * unit_len, 0.0)
        return cx, cy, side

    blk_cx, blk_cy, blk_side = cell(gshift, slot_valid)
    # parent cell geometry: the same coords masked one level coarser
    has_par = slot_valid & (lvl > 0)
    blk_pcx, blk_pcy, blk_pside = cell(
        torch.clamp(gshift + 1, max=morton.COORD_BITS), has_par)
    level_t = torch.where(slot_valid, lvl, 0).to(i32)

    # ---- aggregates: float64 prefix-sum differences over [start, end) ----
    w = torch.where(body_alive, smass, 0.0)
    vals = torch.stack([w, w * spos[:, 0], w * spos[:, 1]])      # (3, cap)
    csum = torch.cat([torch.zeros((3, 1), dtype=torch.float64, device=dev),
                      torch.cumsum(vals.double(), dim=1)], dim=1)
    agg = (csum[:, blk_end.long()] - csum[:, blk_start.long()]).to(dtype)
    m_t, mx_t, my_t = agg[0], agg[1], agg[2]
    msafe = torch.clamp(m_t, min=1e-30)
    com = torch.stack([mx_t / msafe, my_t / msafe], dim=-1)

    f32 = torch.float32
    node_rows = torch.stack(
        [x.to(f32) for x in (m_t, com[:, 0], com[:, 1], blk_cx, blk_cy,
                             blk_side, blk_child, blk_nc, blk_start,
                             blk_count, blk_pcx, blk_pcy, blk_pside,
                             has_par)], dim=-1)
    body_rows = torch.cat(
        [spos.to(f32), smass.to(f32)[:, None],
         torch.zeros((cap, 1), dtype=f32, device=dev)], dim=-1)

    return Tree(code=blk_code, level=level_t, start=blk_start.to(i32),
                count=blk_count.to(i32), child=blk_child.to(i32),
                n_children=blk_nc.to(i32), parent=blk_parent.to(i32),
                mass=m_t, com=com, n_nodes=n_nodes, node_need=node_need,
                node_rows=node_rows, body_rows=body_rows, spos=spos,
                smass=smass, sidx=order.to(i32), unsort=unsort,
                n_alive=n_alive, origin=origin_t, root_side=root_side_t)


def strict_parity_nudge(pos, alive, origin, root_side, *, rounds: int = 3):
    """Reference coincident-body epsilon nudge, as a masked position update.

    The reference's recursive insert, once the recursion reaches a quad with
    half-size ``h < 1e-3`` (only possible when >= 2 bodies collide all the
    way down to that depth), displaces the body being inserted by +-1e-3 per
    axis, sign decided by the low mantissa bit of each coordinate, mutating
    simulation state during the tree build
    (``src/main/kotlin/BarnesHutAlg.kt:139-151``). Here bodies that share
    the first-``h < 1e-3``-level cell with another alive in-root body get
    the same deterministic displacement, applied as one masked vector update
    (the bit test uses the position dtype's own bit pattern: float32 here
    against the reference's ``Double.toBits``).

    ``rounds``: the reference re-nudges on every deeper level while bodies
    keep colliding; each round here recomputes coincidence and bits after
    the previous displacement. Bodies with exactly identical coordinates
    never separate (identical bits, identical nudges); in the reference that
    case recurses without bound, so there is no finite behaviour to match.

    Coincidence detection is sort-based (two stable argsorts give
    lexicographic (cellx, celly) order; equal adjacent cells mark both
    neighbours); dead and out-of-root bodies are excluded like the
    reference's out-of-root insert no-op (``BarnesHutAlg.kt:126``).
    ``root_side`` is a Python number.
    """
    dtype, dev = pos.dtype, pos.device
    # first depth d with quad half-size root_half / 2^d < 1e-3; the quad's
    # cell side there is root_side / 2^d (in (1e-3, 2e-3])
    side_f = float(root_side)
    d = max(0, math.ceil(math.log2(0.5 * side_f / 1e-3)))
    origin = torch.as_tensor(origin, dtype=dtype, device=dev)
    root_side = torch.tensor(side_f, dtype=dtype, device=dev)
    s = root_side / (1 << d)
    itype = torch.int32 if dtype == torch.float32 else torch.int64
    eps = torch.tensor(1e-3, dtype=dtype, device=dev)
    n = pos.shape[0]
    unique = -1 - torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    pad = torch.zeros((1,), dtype=torch.bool, device=dev)

    for _ in range(rounds):
        hi = origin + root_side
        inside = ((pos[:, 0] >= origin[0]) & (pos[:, 0] < hi[0])
                  & (pos[:, 1] >= origin[1]) & (pos[:, 1] < hi[1]))
        ok = alive & inside
        q = torch.floor((pos - origin) / s).to(torch.int32)
        q = torch.where(ok[:, None], q, unique)   # unique cells for the rest
        o1 = torch.argsort(q[:, 1], stable=True)
        o2 = torch.argsort(q[o1, 0], stable=True)
        order = o1[o2]
        qs = q[order]
        same = (qs[1:] == qs[:-1]).all(dim=1)
        coinc_sorted = torch.cat([same, pad]) | torch.cat([pad, same])
        coinc = torch.empty_like(coinc_sorted)
        coinc[order] = coinc_sorted
        coinc = coinc & ok
        bx = pos[:, 0].contiguous().view(itype)
        by = pos[:, 1].contiguous().view(itype)
        dx = torch.where((bx & 1) == 0, eps, -eps)
        dy = torch.where((by & 1) == 0, -eps, eps)
        pos = pos + torch.where(coinc[:, None],
                                torch.stack([dx, dy], dim=-1), 0.0)
    return pos


def debug_boxes(tree: Tree):
    """(centre (NC, 2), side (NC,), valid (NC,)) for the D-key tree overlay.

    Equivalent of ``BHTree.visitQuads`` (``BarnesHutAlg.kt:265-274``) feeding
    ``NBodyPanel.paintComponent``'s quad outlines (``NBodyPanel.kt:327-344``).
    """
    ids = torch.arange(tree.code.shape[0], dtype=torch.int32,
                       device=tree.code.device)
    center, side = tree.cell_geometry(ids)
    return center, side, ids < tree.n_nodes
