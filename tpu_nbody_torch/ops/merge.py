"""Mass-threshold merge ("absorb") rule on the device (port of
tpu_nbody.ops.merge).

Reference semantics (``BarnesHutAlg.kt:463-532``): after each step every
body with ``m > merge_max_mass`` absorbs all bodies within
``merge_min_dist`` (<= 0 disables); the absorber gains the victims' mass and
keeps its position and velocity. Heavy candidates are compressed to the
top ``heavy_cap`` by mass; a victim's absorber is the lowest-index heavy
near it, and a second round drops absorbers that are themselves victims of
a lower-index heavy. ``heavy_need`` counts the qualifying heavies so the
engine can grow ``heavy_cap`` when it overflows. Deviations from the
sequential reference are those documented in ``tpu_nbody/ops/merge.py``.

:func:`merge_bodies` launches the hand-written ``csrc/merge.cu`` for CUDA
tensors (one cooperative launch a call, the only device operation; no
host sync) and runs :func:`_merge_bodies_ref` for CPU tensors; the sharded
merge (``parallel/sharded.py``) goes through :func:`heavy_table` and
:func:`absorb`, the same file's two halves (a memset and two kernels
each; plain versions :func:`_heavy_table_ref`, :func:`_absorb_ref`). Any
other device raises. ``_build.LAUNCHES["merge"]`` counts the launch sets: one a
:func:`merge_bodies` call, one each a :func:`heavy_table` and an
:func:`absorb` call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_nbody_torch.kernels import _build
from tpu_nbody_torch.ops.mesh import _topk_lowest_index
from tpu_nbody_torch.state import SimState

BIG = torch.iinfo(torch.int32).max      # id of an empty heavy slot
FLOPS_PER_TEST = 6                      # a 2D distance test: 2 -, 2 *, +, <
MERGE_THREADS = 1024                    # a CTA of the one-launch merge, as
                                        # csrc/merge.cu's FUSED_THREADS


def _r2(a, b):
    """(len a, len b) squared distances a_i - b_j, each difference, square
    and sum rounded alone in index order (the kernel's order)."""
    out = None
    for k in range(a.shape[1]):
        d = a[:, k, None] - b[None, :, k]
        out = d * d if out is None else out + d * d
    return out


def _merge_bodies_ref(state: SimState, params,
                      heavy_cap: int = 64) -> tuple[SimState, torch.Tensor]:
    """The plain torch rule: the (capacity x H) form of the JAX package.

    Runs without a host sync: whether merging applies this step (at least
    two bodies alive) is decided on the device with ``torch.where``.
    """
    cap = state.capacity
    heavy_cap = min(heavy_cap, cap)
    heavy = state.alive & (state.mass > params.merge_max_mass)
    heavy_need = heavy.sum(dtype=torch.int32)
    if params.merge_min_dist <= 0:
        return state, torch.zeros_like(heavy_need)

    md2 = params.merge_min_dist * params.merge_min_dist
    # Compress heavies to heavy_cap slots, keeping the heaviest, ties to the
    # lower index (jax.lax.top_k's choice). Which slot a heavy lands in
    # does not matter: absorbers resolve by body index.
    key = torch.where(heavy, state.mass, float("-inf"))
    _, hidx = _topk_lowest_index(key, heavy_cap)
    hvalid = heavy[hidx]
    hidx = torch.where(hvalid, hidx, cap)    # park invalid at sentinel
    hpos = state.pos[torch.clamp(hidx, 0, cap - 1)]

    close = _r2(state.pos, hpos) < md2                    # (cap, H)
    body_idx = torch.arange(cap, device=state.pos.device)
    eligible = (close & hvalid[None, :] & state.alive[:, None]
                & (body_idx[:, None] != hidx[None, :]))

    def lowest_absorber(elig):
        return torch.where(elig, hidx[None, :], cap).amin(dim=1)

    # Round 1: absorber(j) = lowest-index heavy near j.
    absorber = lowest_absorber(eligible)
    is_victim = absorber < cap
    # Round 2: a heavy that is itself a victim of a LOWER-index heavy never
    # scans; drop it from the absorber set and re-resolve.
    absorbed_by_lower = is_victim & (absorber < body_idx)
    still_absorber = hvalid & ~absorbed_by_lower[torch.clamp(hidx, 0, cap - 1)]
    absorber = lowest_absorber(eligible & still_absorber[None, :])
    is_victim = absorber < cap

    gained = torch.zeros((cap + 1,), dtype=state.mass.dtype,
                         device=state.mass.device).index_add_(
        0, absorber, torch.where(is_victim, state.mass, 0.0))[:cap]
    merged = state._replace(mass=torch.where(is_victim, 0.0,
                                             state.mass + gained),
                            alive=state.alive & ~is_victim)
    enabled = state.n_alive() > 1
    out = state._replace(mass=torch.where(enabled, merged.mass, state.mass),
                         alive=torch.where(enabled, merged.alive,
                                           state.alive))
    return out, torch.where(enabled, heavy_need, 0)


def merge_bodies(state: SimState, params,
                 heavy_cap: int = 64) -> tuple[SimState, torch.Tensor]:
    """Apply the absorb rule. Returns (state, heavy_need), ``heavy_need`` a
    0-dim int32 tensor on the state's device (0 where the rule is off).

    CPU tensors take :func:`_merge_bodies_ref`; CUDA tensors launch
    ``csrc/merge.cu`` once (a cooperative grid of :func:`_merge_grid`
    CTAs): the same absorbers, alive flags and heavy_need, the gained
    masses summed with atomics (their last bits may differ). Neither syncs
    with the host.
    """
    if state.pos.device.type == "cpu":
        return _merge_bodies_ref(state, params, heavy_cap)
    cap, dim = state.pos.shape
    dev = state.pos.device
    H = min(heavy_cap, cap)
    if params.merge_min_dist <= 0 or cap == 0:
        return state, torch.zeros((), dtype=torch.int32, device=dev)
    _check_bodies(state.pos, state.mass, state.alive)
    md2 = params.merge_min_dist * params.merge_min_dist
    grid = min(_merge_grid(dev.index, dim), -(-cap // MERGE_THREADS))
    scratch = torch.empty((_scratch_bytes(cap, H, dim, grid),),
                          dtype=torch.uint8, device=dev)
    mass = torch.empty_like(state.mass)
    alive = torch.empty_like(state.alive)
    need = torch.empty((), dtype=torch.int32, device=dev)
    rc = _build.library().tnt_merge(
        state.pos.data_ptr(), state.mass.data_ptr(), state.alive.data_ptr(),
        cap, dim, ctypes.c_float(params.merge_max_mass), ctypes.c_float(md2),
        H, grid, scratch.data_ptr(), scratch.numel(),
        mass.data_ptr(), alive.data_ptr(), need.data_ptr(),
        _build.stream(dev))
    _build.check_launch("merge", rc)
    return state._replace(mass=mass, alive=alive), need


# -- the two halves, for the sharded merge ----------------------------------

def _heavy_table_ref(pos, mass, alive, max_mass, H, gid0=0):
    """Plain version of :func:`heavy_table`: the top ``H`` heavies by
    :func:`_topk_lowest_index`."""
    n = pos.shape[0]
    gid = gid0 + torch.arange(n, dtype=torch.int32, device=pos.device)
    heavy = alive & (mass > max_mass)
    need = heavy.sum(dtype=torch.int32)
    key = torch.where(heavy, mass, float("-inf"))
    _, hloc = _topk_lowest_index(key, H)
    hvalid = heavy[hloc]
    return need, pos[hloc], torch.where(hvalid, gid[hloc], BIG), hvalid


def heavy_table(pos, mass, alive, max_mass, H, gid0=0):
    """This rank's heavy table: ``(need, hpos (H, dim), hgid (H,) int32,
    hvalid (H,) bool)``, ``need`` the count of alive bodies with mass above
    ``max_mass`` (0-dim int32), the table the ``H`` heaviest of them (all
    of them when they fit; ties to the lower index), ids ``gid0 + index``
    and :data:`BIG` in empty slots. The slot order is free (CPU: by mass;
    the kernel: as collected). ``H`` is at most the body count."""
    if pos.device.type == "cpu":
        return _heavy_table_ref(pos, mass, alive, max_mass, H, gid0)
    n, dim = pos.shape
    dev = pos.device
    _check_bodies(pos, mass, alive)
    if not 0 <= H <= n:
        raise ValueError(f"heavy_table: {H} slots for {n} bodies")
    scratch = torch.empty((_scratch_bytes(n, H, dim),), dtype=torch.uint8,
                          device=dev)
    hpos = torch.empty((H, dim), dtype=pos.dtype, device=dev)
    hgid = torch.empty((H,), dtype=torch.int32, device=dev)
    hvalid = torch.empty((H,), dtype=torch.bool, device=dev)
    rc = _build.library().tnt_merge_heavies(
        pos.data_ptr(), mass.data_ptr(), alive.data_ptr(), n, dim,
        ctypes.c_float(max_mass), H, gid0, scratch.data_ptr(),
        scratch.numel(), hpos.data_ptr(), hgid.data_ptr(), hvalid.data_ptr(),
        _build.stream(dev))
    _build.check_launch("merge", rc)
    return scratch[:4].view(torch.int32)[0], hpos, hgid, hvalid


def _absorb_ref(pos, mass, alive, hpos, hgid, hvalid, md2, gid0=0):
    """Plain version of :func:`absorb`: the (n x nH) masks."""
    n = pos.shape[0]
    nH = hgid.shape[0]
    gid = gid0 + torch.arange(n, dtype=torch.int32, device=pos.device)
    # round 2 from the table alone: a heavy near a valid heavy of lower id
    # was absorbed by it and never scans
    lower = ((_r2(hpos, hpos) < md2) & hvalid[None, :]
             & (hgid[None, :] < hgid[:, None]))
    still = hvalid & ~lower.any(dim=1)
    eligible = ((_r2(pos, hpos) < md2) & still[None, :] & alive[:, None]
                & (gid[:, None] != hgid[None, :]))
    absorber, slot = torch.where(eligible, hgid[None, :], BIG).min(dim=1)
    is_victim = absorber < BIG
    gained = torch.zeros((nH + 1,), dtype=mass.dtype, device=mass.device)
    gained.index_add_(0, torch.where(is_victim, slot, nH),
                      torch.where(is_victim, mass, 0.0))
    return (torch.where(is_victim, 0.0, mass), alive & ~is_victim,
            gained[:nH])


def absorb(pos, mass, alive, hpos, hgid, hvalid, md2, gid0=0):
    """The rule for these bodies (ids ``gid0 + index``) against a heavy
    table of ``nH`` slots (:func:`heavy_table`'s, possibly gathered from
    every rank): ``(mass, alive, gained)``, victims at mass 0 and alive
    false, ``gained`` (nH,) the victims' masses summed by absorber slot
    (the kernel: with atomics). The absorbers' own masses are not raised
    here: their owners add the gains."""
    if pos.device.type == "cpu":
        return _absorb_ref(pos, mass, alive, hpos, hgid, hvalid, md2, gid0)
    n, dim = pos.shape
    dev = pos.device
    nH = hgid.shape[0]
    _check_bodies(pos, mass, alive)
    _build.check_tensor("hpos", hpos, (nH, dim), device=dev)
    _build.check_tensor("hgid", hgid, (nH,), device=dev, dtype=torch.int32)
    _build.check_tensor("hvalid", hvalid, (nH,), device=dev, align=1,
                        dtype=torch.bool)
    scratch = torch.empty((_scratch_bytes(0, nH, dim),), dtype=torch.uint8,
                          device=dev)
    mass_out = torch.empty_like(mass)
    alive_out = torch.empty_like(alive)
    gained = torch.zeros((nH,), dtype=mass.dtype, device=dev)
    rc = _build.library().tnt_merge_apply(
        pos.data_ptr(), mass.data_ptr(), alive.data_ptr(), n, dim, gid0,
        ctypes.c_float(md2), hpos.data_ptr(), hgid.data_ptr(),
        hvalid.data_ptr(), nH, scratch.data_ptr(), scratch.numel(),
        mass_out.data_ptr(), alive_out.data_ptr(), gained.data_ptr(),
        _build.stream(dev))
    _build.check_launch("merge", rc)
    return mass_out, alive_out, gained


# -- launch helpers ----------------------------------------------------------

def _scratch_bytes(n_list: int, nT: int, dim: int, ctas: int = 0) -> int:
    """Bytes of the kernel's scratch buffer (``carve`` in csrc/merge.cu,
    part for part, each rounded up to 16): the counters, two counts a CTA
    of the one-launch merge (``ctas`` of them; 0 for the sharded halves),
    the gains, the heavy list and, with CTAs, its compacted copy, the
    table and the compacted absorbers."""
    parts = (16, 8 * ctas, 4 * nT, 4 * n_list, 4 * n_list if ctas else 0,
             4 * nT * dim, 4 * nT, nT, 4 * nT * dim, 4 * nT, 4 * nT)
    return sum((p + 15) & ~15 for p in parts)


def merge_work(n: int, heavy_need: int, heavy_cap: int, dim: int = 2):
    """Flops and bytes of one merge of ``n`` alive bodies: the distance
    tests the data needs (each body against min(heavy_need, heavy_cap)
    heavies) and the bodies read once (positions, masses, flags) and
    written once (masses, flags)."""
    tests = n * min(heavy_need, heavy_cap)
    return dict(tests=tests, flops=(FLOPS_PER_TEST + 3 * (dim - 2)) * tests,
                bytes=n * (4 * dim + 4 + 1) + n * (4 + 1))


@functools.lru_cache(maxsize=None)
def _merge_grid(device_index: int, dim: int) -> int:
    """CTAs of the one-launch merge the card holds at once (its SMs times
    the occupancy API's count), asked once a (device, dim): the most a
    cooperative launch may have."""
    with torch.cuda.device(device_index):
        per_sm = _build.library().tnt_merge_blocks_per_sm(dim)
        n_sm = torch.cuda.get_device_properties(
            device_index).multi_processor_count
    if per_sm < 1:
        raise RuntimeError(f"merge: no occupancy for dim={dim}")
    return n_sm * per_sm


def _check_bodies(pos, mass, alive):
    n, dim = pos.shape
    if dim not in (2, 3):
        raise ValueError(f"merge: dim {dim}, expected 2 or 3")
    _build.check_tensor("pos", pos, (n, dim))
    _build.check_tensor("mass", mass, (n,), device=pos.device)
    _build.check_tensor("alive", alive, (n,), device=pos.device, align=1,
                        dtype=torch.bool)
