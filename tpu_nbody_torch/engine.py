"""High-level simulation engine (port of tpu_nbody.engine).

Host-side orchestration of device work. Solvers: ``"bh"`` (flat-quadtree
Barnes–Hut, the default), ``"pm"`` (P3M, every knob of the JAX engine) and
``"allpairs"`` (exact O(N²), the hand-written all-pairs kernel on the
card). Integrators: ``"kdk"`` (two force passes a step, the default),
``"kdk_reuse"`` (one) and ``"euler"``. ``SimConfig(dim=3)`` runs with
``solver="allpairs"`` and any integrator (the reference GPU demo's
workload); the tree and the mesh are 2D, so ``dim=3`` with ``"bh"`` or
``"pm"`` raises ``ValueError``, as do the 2D scene methods on a 3D engine
(``set_bodies`` and ``add_bodies`` carry ``(n, 3)`` arrays).

The BH traversal uses fixed list caps (:class:`Caps`); when a ``step(n)``
reports that a list overflowed, the engine grows the caps, rebuilds its
step function and redoes the call from the state it started with.

Every solver and integrator runs the one step loop of
:func:`make_step_fn`; pm with kdk_reuse and ``pm_persistent_sort`` runs it
with the sorted carry (:class:`_SortedCarry`), which keeps the state
Hilbert-sorted and carries the long-range grids of F_long subcycling. A
``step(n)`` call runs its seed force pass (kdk_reuse) and ``n`` steps as a
Python loop of eager device work with no host sync inside; the stats are
max-reduced on the device and read to the host once per call, as the JAX
engine does after its jitted scan.
"""

from __future__ import annotations

import dataclasses
import functools
import time
import warnings
from typing import Callable

import torch

from tpu_nbody_torch import profiling
from tpu_nbody_torch import state as state_lib
from tpu_nbody_torch.config import CENTRAL_MASS, Params, SimConfig, f32
from tpu_nbody_torch.models import scenes
from tpu_nbody_torch.ops import forces, integrate
from tpu_nbody_torch.ops import mesh as mesh_lib
from tpu_nbody_torch.ops import morton, traverse
from tpu_nbody_torch.ops import tree as tree_lib
from tpu_nbody_torch.ops.merge import merge_bodies
from tpu_nbody_torch.state import SimState

STAT_KEYS = ("heavy_need", "rescue_need", "rescue_hot", "mesh_oob")
SOLVERS = ("pm", "allpairs", "bh")
ALLPAIRS_IMPLS = ("auto", "pallas")

_INTEGRATORS = {
    "kdk": integrate.kdk_step,
    "euler": integrate.euler_step,
}


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 1).bit_length()


@dataclasses.dataclass
class Caps:
    """Runtime-tunable caps for the BH tree build + traversal lists.

    ``num_nodes`` (the flat node table size) and ``group_size`` (max bodies
    per traversal group) live here rather than only in SimConfig so the
    engine can grow them on overflow: a saturated node table silently
    truncates deep tree levels, and a max-depth leaf bigger than group_size
    would fall outside every traversal group (zero force). Both are
    reported by TraversalStats and retuned exactly like the list caps.
    """
    approx_cap: int
    leaf_list_cap: int
    direct_body_cap: int
    frontier_cap: int
    group_cap: int
    num_nodes: int
    group_size: int
    # hier traversal: per-chunk candidate caps per refinement level
    # (ops/traverse.py _hier_lists); retuned elementwise like the others.
    cand_caps: tuple = (131072, 32768, 4096)

    @classmethod
    def from_config(cls, cfg: SimConfig) -> "Caps":
        return cls(cfg.approx_cap, cfg.leaf_list_cap, cfg.direct_body_cap,
                   cfg.frontier_cap, cfg.num_groups, cfg.num_nodes,
                   cfg.group_size, tuple(cfg.bh_hier_cand_caps))

    def as_dict(self):
        return dataclasses.asdict(self)

    def grown(self, stats: traverse.TraversalStats) -> "Caps":
        """Next caps after an overflow: 2x headroom over observed need."""
        def bump(cap, need):
            need = int(need)
            return max(cap, _next_pow2(2 * need)) if need > cap else cap
        gs_need = int(stats.group_size_need)
        cand = self.cand_caps
        if stats.cand_need is not None:
            need = [int(x) for x in stats.cand_need]
            cand = tuple(bump(c, need[i]) if i < len(need) else c
                         for i, c in enumerate(cand))
        return Caps(
            approx_cap=bump(self.approx_cap, stats.approx_need),
            leaf_list_cap=bump(self.leaf_list_cap, stats.leaf_need),
            direct_body_cap=bump(self.direct_body_cap, stats.direct_need),
            frontier_cap=bump(self.frontier_cap, stats.frontier_need),
            group_cap=bump(self.group_cap, stats.group_need),
            num_nodes=bump(self.num_nodes, stats.node_need),
            # exact bound, no doubling: need = largest leaf population
            group_size=(max(self.group_size, _next_pow2(gs_need))
                        if gs_need > self.group_size else self.group_size),
            cand_caps=cand)

    def tightened(self, stats: traverse.TraversalStats) -> "Caps":
        """Caps shrunk toward observed need (~1.5x headroom, multiples of
        64).

        Every force chunk evaluates (group_size x approx/direct cap) pair
        blocks however much of them is padding, so oversized caps are pure
        waste. A cap only shrinks when that wins >= 2x (hysteresis, so a
        later ``grown`` cannot ping-pong); ``group_size`` is a tuning
        choice, not a need bound, and is left alone.
        """
        def shrink(cap, need, floor=64):
            need = int(need)
            if need <= 0:
                return cap
            tgt = max(floor, -(-int(need * 1.5) // 64) * 64)
            return tgt if 2 * tgt <= cap else cap
        cand = self.cand_caps
        if stats.cand_need is not None:
            need = [int(x) for x in stats.cand_need]
            cand = tuple(shrink(c, need[i], floor=256) if i < len(need)
                         else c for i, c in enumerate(cand))
        return Caps(
            approx_cap=shrink(self.approx_cap, stats.approx_need),
            leaf_list_cap=shrink(self.leaf_list_cap, stats.leaf_need),
            direct_body_cap=shrink(self.direct_body_cap, stats.direct_need),
            frontier_cap=shrink(self.frontier_cap, stats.frontier_need),
            group_cap=shrink(self.group_cap, stats.group_need),
            num_nodes=shrink(self.num_nodes, stats.node_need, floor=1024),
            group_size=self.group_size, cand_caps=cand)


# bh_traversal="auto" switchover: the dense classification is O(groups x
# nodes), both of which scale with capacity (the JAX package's threshold).
BH_DENSE_MAX_CAP = 1 << 18


def _resolve_traversal(cfg: SimConfig) -> str:
    if cfg.bh_traversal == "auto":
        return "dense" if cfg.capacity <= BH_DENSE_MAX_CAP else "hier"
    if cfg.bh_traversal not in traverse.TRAVERSALS:
        raise ValueError(f"unknown bh_traversal {cfg.bh_traversal!r}: "
                         f"expected 'auto' or one of {traverse.TRAVERSALS}")
    return cfg.bh_traversal


def check_ported(cfg: SimConfig, solver: str, integrator: str,
                 strict_parity: bool = False, allpairs_impl: str = "auto"):
    """Raise ``ValueError`` for an unknown name, for a ``dim`` other than 2
    or 3, for ``dim=3`` with a solver other than all-pairs (the JAX engine
    dies there in a broadcast error inside its first step), and for a
    switch the port does not honour: ``strict_parity`` outside bh, which
    the JAX engine ignores there, and ``allpairs_impl="xla"``."""
    mesh_lib._check_switch(cfg.mesh_switch)
    mesh_lib._check_order(cfg.mesh_order)
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}")
    if integrator not in (*_INTEGRATORS, "kdk_reuse"):
        raise ValueError(f"unknown integrator {integrator!r}")
    if cfg.dim not in (2, 3):
        raise ValueError(f"dim={cfg.dim}: expected 2 or 3")
    if cfg.dim == 3 and solver != "allpairs":
        raise ValueError(f"dim=3 runs with solver='allpairs' only: the "
                         f"quadtree and the mesh of solver={solver!r} are "
                         f"2D")
    if solver == "bh":
        _resolve_traversal(cfg)
    elif strict_parity:
        raise ValueError(f"strict_parity=True applies to solver='bh' only; "
                         f"solver={solver!r} has no reference quirk to "
                         f"reproduce")
    if allpairs_impl not in ALLPAIRS_IMPLS:
        raise ValueError(
            f"allpairs_impl={allpairs_impl!r}: the port has one all-pairs "
            f"implementation, the hand-written kernel ('auto' or 'pallas'); "
            f"its plain version serves CPU tensors and the tests")


def _root(cfg: SimConfig):
    ox, oy = cfg.root_center
    return (ox - cfg.root_half, oy - cfg.root_half), 2.0 * cfg.root_half


def _kernel_hats(cfg: SimConfig, params: Params, device):
    _, side = _root(cfg)
    return mesh_lib.kernel_hats_for(
        side, params.soft2, mesh_level=cfg.mesh_level,
        split_cells=cfg.mesh_split, mesh_ny=cfg.mesh_ny, dtype=cfg.tdtype,
        order=cfg.mesh_order, deconvolve=cfg.mesh_deconvolve,
        switch=cfg.mesh_switch, device=device)


def _pm_knobs(cfg: SimConfig) -> dict:
    """The ``pm_accel`` / ``pm_accel_sorted`` keyword arguments of ``cfg``
    (all but the carried-mesh ones)."""
    return dict(mesh_level=cfg.mesh_level, split_cells=cfg.mesh_split,
                band=cfg.mesh_band, chunk=min(cfg.mesh_chunk, cfg.capacity),
                order=cfg.mesh_order, interlace=cfg.mesh_interlace,
                rescue_k=cfg.mesh_rescue, rescue_k_hot=cfg.mesh_rescue_hot,
                rescue_hot_cap=cfg.mesh_rescue_hot_cap, mesh_ny=cfg.mesh_ny,
                deconvolve=cfg.mesh_deconvolve, heavy_cap=cfg.pm_heavy_cap,
                switch=cfg.mesh_switch)


def _inside_root(pos, origin, side):
    return ((pos[:, 0] >= origin[0]) & (pos[:, 0] < origin[0] + side)
            & (pos[:, 1] >= origin[1]) & (pos[:, 1] < origin[1] + side))


def make_bh_accel(cfg: SimConfig, caps: Caps, strict_parity: bool = False,
                  evaluate: bool = True):
    """accel(pos, mass, alive, params, probe=None) -> (acc,
    TraversalStats) via Barnes–Hut: one tree build and one traversal with
    ``caps``. With ``strict_parity`` bodies outside the root quad exert no
    force (the reference's insert drops them, ``BarnesHutAlg.kt:126``) but
    still receive one. ``evaluate`` and the call's ``probe`` are passed to
    the traversal (:func:`traverse.bh_accel_from_tree`); ``probe`` is also
    called with ``"build"`` once the tree build is enqueued."""
    origin, side = _root(cfg)
    traversal = _resolve_traversal(cfg)

    def accel(pos, mass, alive, params, probe=None):
        mass_exert = mass
        if strict_parity:
            mass_exert = torch.where(_inside_root(pos, origin, side), mass,
                                     0.0)
        t = tree_lib.build_tree(pos, mass_exert, alive, origin, side,
                                num_nodes=caps.num_nodes,
                                leaf_size=cfg.leaf_size,
                                max_depth=cfg.max_depth)
        if probe is not None:
            probe("build")
        return traverse.bh_accel_from_tree(
            t, params.theta, params.soft2, params.G,
            group_size=caps.group_size, group_cap=caps.group_cap,
            max_depth=cfg.max_depth, frontier_cap=caps.frontier_cap,
            approx_cap=caps.approx_cap, leaf_list_cap=caps.leaf_list_cap,
            direct_body_cap=caps.direct_body_cap,
            group_chunk=cfg.group_chunk, traversal=traversal,
            hier_sizes=tuple(cfg.bh_hier_sizes), cand_caps=caps.cand_caps,
            hier_batch=cfg.bh_hier_batch, evaluate=evaluate, probe=probe)

    return accel


def make_pm_accel(cfg: SimConfig, device):
    """accel(pos, mass, alive, params, kernel=None, probe=None) -> (acc,
    stats) via the P3M solver in the original body order. Its
    ``prepare(params)`` builds the kernel hats on ``device``; the step
    calls it once per ``step(n)`` and passes the result back as
    ``kernel=``."""
    origin, side = _root(cfg)
    knobs = _pm_knobs(cfg)

    def accel(pos, mass, alive, params, kernel=None, probe=None):
        return mesh_lib.pm_accel(pos, mass, alive, params.G, params.soft2,
                                 origin, side, return_stats=True,
                                 kernel=kernel, probe=probe, **knobs)

    accel.prepare = functools.partial(_kernel_hats, cfg, device=device)
    return accel


def make_allpairs_accel(implementation: str = "auto"):
    """accel(pos, mass, alive, params, probe=None) -> (acc, None), exact:
    dead masses zeroed, then :func:`forces.accel_allpairs` (the kernel on
    the card). Dead slots still receive a force, as in the JAX engine.
    ``probe``, where given, is called with ``"allpairs"`` once the pass is
    enqueued."""
    if implementation not in ALLPAIRS_IMPLS:
        raise ValueError(f"allpairs implementation {implementation!r}: "
                         f"expected one of {ALLPAIRS_IMPLS}")

    def accel(pos, mass, alive, params, probe=None):
        mass = torch.where(alive, mass, 0.0)
        acc = forces.accel_allpairs(pos, mass, params.G, params.soft2)
        if probe is not None:
            probe("allpairs")
        return acc, None

    return accel


def _fold(stats: dict, st):
    """Fold a force pass's stats (a TraversalStats, a dict of some
    :data:`STAT_KEYS` or None) or the merge's ``{"heavy_need": n}`` into
    the running maxima ``stats``."""
    if isinstance(st, traverse.TraversalStats):
        stats["trav"] = traverse.max_stats(stats["trav"], st)
        return
    for k, v in (st or {}).items():
        stats[k] = v if stats[k] is None else torch.maximum(stats[k], v)


def _permute(state: SimState, o) -> SimState:
    return state._replace(pos=state.pos[o], vel=state.vel[o],
                          mass=state.mass[o], alive=state.alive[o])


class _Identity:
    """The carry of every path but the sorted one: the state stays in slot
    order and nothing is marked."""

    def enter(self, state, probe):
        return state

    leave = enter

    def after_step(self, i, state, acc, probe):
        return state, acc


class _SortedCarry:
    """Hilbert-sorted state for pm + kdk_reuse, the JAX package's
    ``_make_pm_sorted_step`` and ``_make_pm_subcycled_step``
    (``tpu_nbody/engine.py:260-504``): sorted at enter (``"sort"``) and
    every ``pm_resort_every`` steps with the carried acceleration and
    grids (``"resort"``), unsorted at leave (``"unsort"``); merge ties
    break by lowest Hilbert position. :meth:`accel` is the sorted force
    pass; with ``M = pm_mesh_every > 1`` it carries the long-range grids
    (:func:`mesh_lib.pm_mesh_state`), built by the seed pass, refreshed by
    step ``i``'s pass when ``i % M == 0`` (``i`` from 0 in every call, as
    the JAX scan counts it) and interpolated stale (extrapolated by
    ``(i % M)/M`` with ``pm_mesh_extrapolate``) in between."""

    def __init__(self, cfg: SimConfig):
        self.M = max(1, cfg.pm_mesh_every)
        if self.M > 1 and cfg.pm_heavy_cap <= 0:
            raise ValueError(
                "pm_mesh_every > 1 requires pm_heavy_cap > 0: heavy bodies "
                "riding a stale mesh feel their own deposited image as a "
                "spurious self-force far exceeding their real acceleration "
                "(ops/mesh.py pm_mesh_state).")
        self.cfg, (self.origin, self.side) = cfg, _root(cfg)
        self.extrap = cfg.pm_mesh_extrapolate and self.M > 1
        self.knobs = dict(_pm_knobs(cfg),
                          self_correct=cfg.pm_self_correct and self.M > 1)

    def _order(self, state):
        codes = morton.hilbert_codes(state.pos, self.origin, self.side,
                                     state.alive)
        return torch.argsort(codes, stable=True)

    def enter(self, state, probe):
        self.perm, self.ms, self.i = self._order(state), None, -1
        state = _permute(state, self.perm)
        if probe is not None:
            probe("sort")
        return state

    def accel(self, pos, mass, alive, params, kernel=None, probe=None):
        """The pass after :meth:`enter` is the seed's (``i`` -1)."""
        cfg, M, i = self.cfg, self.M, self.i
        self.i += 1
        if M > 1 and (i < 0 or i % M == 0):
            prev = (self.ms[0] if i >= 0 else "zero") if self.extrap else None
            self.ms = mesh_lib.pm_mesh_state(
                pos, mass, alive, params.soft2, self.origin, self.side,
                mesh_level=cfg.mesh_level, split_cells=cfg.mesh_split,
                order=cfg.mesh_order, interlace=cfg.mesh_interlace,
                mesh_ny=cfg.mesh_ny, heavy_cap=cfg.pm_heavy_cap,
                deconvolve=cfg.mesh_deconvolve, kernel=kernel, prev=prev,
                switch=cfg.mesh_switch)
        acc, st = mesh_lib.pm_accel_sorted(
            pos, mass, alive, params.G, params.soft2, self.origin, self.side,
            kernel=kernel, mesh_state=self.ms, probe=probe,
            stale_frac=f32((i % M) / M) if M > 1 and i >= 0 else None,
            **self.knobs)
        return acc, dict(zip(STAT_KEYS[1:], st))

    def after_step(self, i, state, acc, probe):
        if (i + 1) % max(1, self.cfg.pm_resort_every):
            return state, acc
        o = self._order(state)
        state, acc, self.perm = _permute(state, o), acc[o], self.perm[o]
        if self.ms is not None:
            grids, dep_pos, dep_wmass, heavy_mask = self.ms
            self.ms = grids, dep_pos[o], dep_wmass[o], heavy_mask[o]
        if probe is not None:
            probe("resort")
        return state, acc

    def leave(self, state, probe):
        unsort = torch.empty_like(self.perm)
        unsort[self.perm] = torch.arange(self.perm.shape[0],
                                         device=self.perm.device)
        state = _permute(state, unsort)
        if probe is not None:
            probe("unsort")
        return state


def make_step_fn(cfg: SimConfig, caps: Caps, solver: str, integrator: str,
                 strict_parity: bool, merge_heavy_cap: int,
                 allpairs_impl: str = "auto", device="cuda") -> Callable:
    """Build step_n(state, params, n_steps, probe=None) -> (state, stats),
    the one step loop of every solver and integrator: the pm kernel hats
    on ``device`` (``"hats"``), the carry's enter, the kdk_reuse seed
    pass, then per step the strict-parity nudge (bh; under kdk_reuse the
    carried acceleration is then that of the un-nudged positions), the
    integrator, :func:`merge_bodies` (``"kick"`` before it, ``"merge"``
    after the stats fold) and the carry's after-step; last its leave. The
    carry is :class:`_SortedCarry` for pm + kdk_reuse +
    ``pm_persistent_sort``, the one path that takes ``pm_mesh_every > 1``,
    else :class:`_Identity`. Each force pass but the seed is preceded by
    ``"kick_drift"`` and marks its own phases. ``stats``: ``"trav"`` (a
    TraversalStats for bh, else None) and the :data:`STAT_KEYS`, 0-dim
    device tensors max-reduced over the passes and steps."""
    check_ported(cfg, solver, integrator, allpairs_impl=allpairs_impl)
    carry, prepare = _Identity(), None
    if solver == "pm":
        accel_stats = make_pm_accel(cfg, device)
        prepare = accel_stats.prepare
        if integrator == "kdk_reuse" and cfg.pm_persistent_sort:
            carry = _SortedCarry(cfg)
            accel_stats = carry.accel
        elif max(1, cfg.pm_mesh_every) > 1:
            raise ValueError(
                "pm_mesh_every > 1 (F_long subcycling) is only supported on "
                "the pm + kdk_reuse persistent-sort path (the carried grids "
                "live in its carry); use integrator='kdk_reuse' with "
                "pm_persistent_sort=True.")
    elif solver == "bh":
        accel_stats = make_bh_accel(cfg, caps, strict_parity)
    else:
        accel_stats = make_allpairs_accel(allpairs_impl)
    nudge = None
    if solver == "bh" and strict_parity:
        origin, side = _root(cfg)
        nudge = functools.partial(tree_lib.strict_parity_nudge,
                                  origin=origin, root_side=side)

    def step_n(state: SimState, params: Params, n_steps: int = 1,
               probe=None):
        extra = {}
        if prepare is not None:
            extra["kernel"] = prepare(params)
            if probe is not None:
                probe("hats")
        state = carry.enter(state, probe)
        stats, passes, acc = dict.fromkeys(("trav", *STAT_KEYS)), [], None

        def force(pos, mass, alive, params):
            acc, st = accel_stats(pos, mass, alive, params, probe=probe,
                                  **extra)
            passes.append(st)
            return acc

        def accel(pos, mass, alive, params):
            if probe is not None:
                probe("kick_drift")
            return force(pos, mass, alive, params)

        if integrator == "kdk_reuse":
            acc = force(state.pos, state.mass, state.alive, params)
            _fold(stats, passes.pop())
        # one 0 for the stats no pass has given (heavy_need at least)
        zero = torch.zeros((), dtype=torch.int32, device=state.pos.device)
        stats.update({k: zero for k in STAT_KEYS if stats[k] is None})
        for i in range(n_steps):
            if nudge is not None:
                state = state._replace(pos=nudge(state.pos, state.alive))
            if integrator == "kdk_reuse":
                state, acc = integrate.kdk_reuse_step(state, acc, params,
                                                      accel)
            else:
                state = _INTEGRATORS[integrator](state, params, accel)
            if probe is not None:
                probe("kick")
            state, heavy = merge_bodies(state, params,
                                        heavy_cap=merge_heavy_cap)
            for st in [{"heavy_need": heavy}, *passes]:
                _fold(stats, st)
            passes.clear()
            if probe is not None:
                probe("merge")
            state, acc = carry.after_step(i, state, acc, probe)
        return carry.leave(state, probe), stats

    return step_n


class Engine:
    """The reference's scene API over the port's solvers and integrators.

    ``device`` is where the state lives and the step runs: the card unless
    the caller passes ``device="cpu"``. Without a card the default raises
    (there is no CPU fallback).
    ``seed`` seeds a ``torch.Generator`` on that device for the scene
    generators. The defaults are the JAX engine's: ``solver="bh"`` and
    ``integrator="kdk"``. ``strict_parity`` (bh only) reproduces two
    reference quirks: bodies outside the root quad exert no force, and
    near-coincident bodies are nudged apart during the tree build.
    ``allpairs_impl`` "auto" and "pallas" both run the hand-written
    all-pairs kernel; "xla" raises ``ValueError``. The step function is
    built here, so every refusal comes at construction. With
    ``SimConfig(dim=3)`` (all-pairs only) the state is 3D and the scene
    methods below, all 2D generators, raise ``ValueError``.
    """

    def __init__(self, cfg: SimConfig, params: Params | None = None, *,
                 solver: str = "bh", integrator: str = "kdk",
                 strict_parity: bool = False, merge_heavy_cap: int = 64,
                 allpairs_impl: str = "auto", seed: int = 3,
                 auto_retune: bool = True, device="cuda"):
        check_ported(cfg, solver, integrator, strict_parity, allpairs_impl)
        self.device = state_lib.check_device(device)
        self.cfg = cfg
        self.params = params or Params.default()
        self.solver = solver
        self.integrator = integrator
        self.strict_parity = strict_parity
        self.allpairs_impl = allpairs_impl
        self.merge_heavy_cap = merge_heavy_cap
        self.auto_retune = auto_retune
        self.caps = Caps.from_config(cfg)
        if solver == "bh":
            tree_lib.check_id_range(cfg.capacity, self.caps.num_nodes)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.state = state_lib.empty_state(cfg.capacity, cfg.dim, cfg.tdtype,
                                           device=self.device)
        # The needs of the last step(n) as Python ints (bh; else None).
        self.last_stats: traverse.TraversalStats | None = None
        self.last_heavy_need: int = 0
        # Max rescue partner blocks any band block wanted in the last
        # step(n); need > cfg.mesh_rescue means the farthest candidate
        # boxes were dropped (closest-first ranking; not auto-grown).
        self.last_rescue_need: int = 0
        # Hot blocks (need > mesh_rescue) of the two-tier rescue; must stay
        # <= cfg.mesh_rescue_hot_cap for the hot tier to cover them all.
        self.last_rescue_hot: int = 0
        # Alive bodies outside the rectangular mesh window (cfg.mesh_ny);
        # nonzero means the window is mis-sized for the scene.
        self.last_mesh_oob: int = 0
        self._build_step()

    # ------------------------------------------------------------ stepping
    def _build_step(self):
        self._step_fn = make_step_fn(
            self.cfg, self.caps, self.solver, self.integrator,
            self.strict_parity, self.merge_heavy_cap, self.allpairs_impl,
            self.device)

    def _record_stats(self, stats, syncs=None, probe=None) -> dict:
        """Read the step's stats to the host in one transfer (the one host
        sync of a ``step(n)``) and keep them as ``last_*``. The host
        clock's (start, end) of the read is appended to ``syncs``, and
        ``probe`` marks ``"stats"`` after it."""
        trav = stats["trav"]
        parts = [torch.stack([stats[k].to(torch.int64) for k in STAT_KEYS])]
        if trav is not None:
            parts.append(trav.flat())
        flat = torch.cat(parts)
        t0 = time.time_ns()
        vals = flat.tolist()
        if syncs is not None:
            syncs.append((t0, time.time_ns()))
        if probe is not None:
            probe("stats")
        rec = dict(zip(STAT_KEYS, vals))
        rec["trav"] = None if trav is None \
            else trav.on_host(vals[len(STAT_KEYS):])
        self.last_stats = rec["trav"]
        self.last_heavy_need = rec["heavy_need"]
        self.last_rescue_need = rec["rescue_need"]
        self.last_rescue_hot = rec["rescue_hot"]
        self.last_mesh_oob = rec["mesh_oob"]
        return rec

    def _run_with_retune(self, run: Callable):
        """Run ``run() -> (state, recorded_stats)``; on overflow, grow the
        caps, rebuild the step function and redo from the pre-run state (up
        to 6 rounds). Overflow means interactions (or merge absorbers) were
        dropped; iteration matters because a truncated list hides deeper
        needs, so one growth round may reveal more. ``self.state`` changes
        only at the end. Ending with a cap still overflowing (6 rounds, no
        cap could grow, or ``auto_retune`` off) raises a ``RuntimeWarning``
        that names the caps and the needs."""
        new_state, stats = run()
        rounds = 0
        while self.auto_retune and rounds < 6 and self._overflow_list(stats):
            progressed = False
            if stats["trav"] is not None:
                grown = self.caps.grown(stats["trav"])
                if grown != self.caps:
                    self.caps = grown
                    progressed = True
            if stats["heavy_need"] > self.merge_heavy_cap:
                self.merge_heavy_cap = min(
                    self.cfg.capacity, _next_pow2(2 * stats["heavy_need"]))
                progressed = True
            if not progressed:
                break
            self._build_step()
            new_state, stats = run()
            rounds += 1
        if self._overflow_list(stats):
            warnings.warn(
                f"Engine.step: a cap overflows after {rounds} retune "
                f"rounds, so interactions or merge absorbers were dropped: "
                + "; ".join(f"{name} {cap} < need {need}" for name, cap, need
                            in self._overflow_list(stats)),
                RuntimeWarning, stacklevel=3)
        self.state = new_state
        return self.state

    def _overflow_list(self, stats) -> list:
        """(cap name, cap, need) of every cap ``stats`` overflow."""
        out = []
        if stats["heavy_need"] > self.merge_heavy_cap:
            out.append(("merge_heavy_cap", self.merge_heavy_cap,
                        stats["heavy_need"]))
        if stats["trav"] is not None:
            out += stats["trav"].overflows(self.caps.as_dict())
        return out

    def step(self, n: int = 1):
        """Advance ``n`` steps. Regrows the BH caps and the merge heavy cap
        on overflow. Keeps a :class:`profiling.CallRecord` of the call in
        :data:`profiling.RECORDER`, and, while the recorder is active,
        marks each phase of the call there."""
        t_enter = time.time_ns()
        probe = profiling.RECORDER.call_probe()
        syncs = []

        def run():
            state, stats = self._step_fn(self.state, self.params, n_steps=n,
                                         probe=probe)
            return state, self._record_stats(stats, syncs, probe)

        out = self._run_with_retune(run)
        profiling.RECORDER.record_call(t_enter, syncs, n, probe is not None)
        return out

    def step_stream(self, n: int = 1):
        """The same loop as :meth:`step`. The JAX engine steps here through
        ``n`` single-step executables because a compiled scan over the hier
        traversal faults its TPU backend; eager PyTorch has no scan."""
        return self.step(n)

    def tighten_caps(self) -> bool:
        """Shrink the BH caps to ~1.5x the needs the last ``step`` observed
        (see :meth:`Caps.tightened`). Call after a warm-up step on a
        representative scene. Returns True if the caps changed; the
        overflow retune grows them back if the scene later needs more."""
        if self.last_stats is None:
            return False
        t = self.caps.tightened(self.last_stats)
        if t != self.caps:
            self.set_caps(t)
            return True
        return False

    def set_caps(self, caps: Caps):
        """Step with ``caps`` from now on, e.g. caps fitted to the scene by
        lists-only passes (:func:`tpu_nbody_torch.accuracy.fitted_bh_pass`
        with ``evaluate=False``); the overflow retune still grows them."""
        if self.solver == "bh":
            tree_lib.check_id_range(self.cfg.capacity, caps.num_nodes)
        self.caps = caps
        self._build_step()

    def get_bodies(self):
        """Alive bodies as host numpy (pos, vel, mass)."""
        alive = self.state.alive.cpu().numpy()
        return (self.state.pos.cpu().numpy()[alive],
                self.state.vel.cpu().numpy()[alive],
                self.state.mass.cpu().numpy()[alive])

    # --------------------------------------------------------- scene edits
    def set_bodies(self, pos, vel, mass):
        self.state = state_lib.from_arrays(pos, vel, mass, self.cfg.capacity,
                                           device=self.device)

    def add_bodies(self, pos, vel, mass):
        self.state = state_lib.concat_bodies(self.state, pos, vel, mass)

    def clear(self):
        self.state = state_lib.clear(self.state)

    def _require_2d(self, what: str):
        if self.cfg.dim != 2:
            raise ValueError(f"{what} makes 2D bodies and this engine has "
                             f"dim={self.cfg.dim}; pass (n, {self.cfg.dim}) "
                             f"arrays to set_bodies or add_bodies")

    def reset_default_scene(self, n1: int = 10_000, n2: int = 2_500):
        self._require_2d("reset_default_scene")
        p, v, m = scenes.default_two_disk_scene(
            self.generator, n1=n1, n2=n2, world_w=self.cfg.world_w,
            world_h=self.cfg.world_h, G=self.params.G, dtype=self.cfg.tdtype)
        self.set_bodies(p, v, m)

    def add_galaxy_disk(self, x, y, r=None, n=None, vx=0.0, vy=0.0, **kw):
        """LMB drag equivalent (``NBodyPanel.kt:170,228-234``)."""
        self._require_2d("add_galaxy_disk")
        r = 100.0 if r is None else float(r)
        n = 5_000 if n is None else n
        p, v, m = scenes.make_galaxy_disk(
            self.generator, n, x=x, y=y, r=r, vx=vx, vy=vy, G=self.params.G,
            world_w=self.cfg.world_w, world_h=self.cfg.world_h,
            dtype=self.cfg.tdtype, **kw)
        self.add_bodies(p, v, m)

    def add_kepler_disk(self, x, y, r=None, n=5_000, vx=0.0, vy=0.0, **kw):
        self._require_2d("add_kepler_disk")
        p, v, m = scenes.make_kepler_disk(
            self.generator, n, x=x, y=y, r=r, vx=vx, vy=vy, G=self.params.G,
            world_w=self.cfg.world_w, world_h=self.cfg.world_h,
            dtype=self.cfg.tdtype, **kw)
        self.add_bodies(p, v, m)

    def add_black_hole(self, x, y, vx=0.0, vy=0.0, mass=None):
        """RMB drag: one body of CENTRAL_MASS (``NBodyPanel.kt:171``),
        which feeds the merge rule."""
        self._require_2d("add_black_hole")
        m = CENTRAL_MASS if mass is None else mass
        dt = self.cfg.tdtype
        self.add_bodies(torch.tensor([[float(x), float(y)]], dtype=dt),
                        torch.tensor([[float(vx), float(vy)]], dtype=dt),
                        torch.tensor([float(m)], dtype=dt))

    def add_cloud(self, n: int = 5_000, m: float = 0.5):
        """C key (``NBodyPanel.kt:282-286``)."""
        self._require_2d("add_cloud")
        p, v, mm = scenes.make_uniform_cloud(
            self.generator, n, m, world_w=self.cfg.world_w,
            world_h=self.cfg.world_h, dtype=self.cfg.tdtype)
        self.add_bodies(p, v, mm)

    def compact(self):
        """Pack alive bodies to the front (after heavy merging)."""
        self.state = state_lib.compact(self.state)

    # -------------------------------------------------------------- debug
    def tree_boxes(self):
        """Quad outlines for the D-key debug overlay: (centre, side) of
        every tree node, as numpy arrays."""
        self._require_2d("tree_boxes")
        origin, side = _root(self.cfg)
        st = self.state
        t = tree_lib.build_tree(
            st.pos, torch.where(st.alive, st.mass, 0.0), st.alive, origin,
            side, num_nodes=self.caps.num_nodes,
            leaf_size=self.cfg.leaf_size, max_depth=self.cfg.max_depth)
        center, side, valid = tree_lib.debug_boxes(t)
        v = valid.cpu().numpy()
        return center.cpu().numpy()[v], side.cpu().numpy()[v]

    def stats(self, potential: bool | None = None):
        """HUD scalars as host numpy. ``potential`` (O(N²)) defaults on up
        to 64k capacity, off above."""
        from tpu_nbody_torch.ops import diagnostics
        if potential is None:
            potential = self.cfg.capacity <= 65536
        out = diagnostics.stats(self.state, self.params, potential=potential)
        return {k: v.cpu().numpy() for k, v in out.items()}
