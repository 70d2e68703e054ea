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

``solver="pm"`` with ``kdk_reuse`` and ``pm_persistent_sort`` runs the
sorted-carry step (:func:`_make_pm_sorted_step`), which also carries the
long-range grids for F_long subcycling and heavy-direct summation; every
other combination runs the generic step of :func:`make_step_fn`. A
``step(n)`` call runs its seed force pass (kdk_reuse) and ``n`` steps as a
Python loop of eager device work with no host sync inside; the stats are
max-reduced on the device and read to the host once per call, as the JAX
engine does after its jitted scan.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

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
                  evaluate: bool = True, probe=None):
    """accel(pos, mass, alive, params) -> (acc, TraversalStats) via
    Barnes–Hut: one tree build and one traversal with ``caps``. With
    ``strict_parity`` bodies outside the root quad exert no force
    (the reference's insert drops them, ``BarnesHutAlg.kt:126``) but still
    receive one. ``evaluate`` and ``probe`` are passed to the traversal
    (:func:`traverse.bh_accel_from_tree`); ``probe`` is also called with
    ``"build"`` once the tree build is enqueued."""
    origin, side = _root(cfg)
    traversal = _resolve_traversal(cfg)

    def accel(pos, mass, alive, params):
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
    """accel(pos, mass, alive, params, kernel=None) -> (acc, stats) via
    the P3M solver in the original body order. Its ``prepare(params)``
    builds the kernel hats on ``device``; the step calls it once per
    ``step(n)`` and passes the result back as ``kernel=``."""
    origin, side = _root(cfg)
    knobs = _pm_knobs(cfg)

    def accel(pos, mass, alive, params, kernel=None):
        return mesh_lib.pm_accel(pos, mass, alive, params.G, params.soft2,
                                 origin, side, return_stats=True,
                                 kernel=kernel, **knobs)

    accel.prepare = functools.partial(_kernel_hats, cfg, device=device)
    return accel


def make_allpairs_accel(implementation: str = "auto"):
    """accel(pos, mass, alive, params) -> (acc, None), exact: dead masses
    zeroed, then :func:`forces.accel_allpairs` (the kernel on the card).
    Dead slots still receive a force, as in the JAX engine."""
    if implementation not in ALLPAIRS_IMPLS:
        raise ValueError(f"allpairs implementation {implementation!r}: "
                         f"expected one of {ALLPAIRS_IMPLS}")

    def accel(pos, mass, alive, params):
        mass = torch.where(alive, mass, 0.0)
        return forces.accel_allpairs(pos, mass, params.G, params.soft2), None

    return accel


def _split_aux(st, device) -> dict:
    """A force pass's stats (TraversalStats, pm dict or None) as the step
    stats dict: ``"trav"`` and the :data:`STAT_KEYS`, the merge's
    ``heavy_need`` still 0."""
    zero = torch.zeros((), dtype=torch.int32, device=device)
    if isinstance(st, traverse.TraversalStats):
        return {"trav": st, **{k: zero for k in STAT_KEYS}}
    st = st or {}
    return {"trav": None, **{k: st.get(k, zero) for k in STAT_KEYS}}


def _max_stats(a, b):
    """Elementwise max of two step stats dicts."""
    out = {k: torch.maximum(a[k], b[k]) for k in STAT_KEYS}
    out["trav"] = traverse.max_stats(a["trav"], b["trav"])
    return out


def _permute(state: SimState, o) -> SimState:
    return state._replace(pos=state.pos[o], vel=state.vel[o],
                          mass=state.mass[o], alive=state.alive[o])


def _make_pm_sorted_step(cfg: SimConfig, merge_heavy_cap: int) -> Callable:
    """step_n for solver="pm" + integrator="kdk_reuse" with persistent
    Hilbert-sorted state: the JAX package's ``_make_pm_sorted_step`` and,
    when ``pm_mesh_every > 1`` or ``pm_heavy_cap > 0``, its
    ``_make_pm_subcycled_step`` (``tpu_nbody/engine.py:260-504``).

    The state is sorted once by the seed pass, integrated and merged in the
    sorted frame, re-sorted every ``cfg.pm_resort_every`` steps, and
    returned to its original slot order at the end, so slot identity is
    unchanged for the caller. Under the sorted carry, merge ties break by
    lowest Hilbert position, as in the JAX engine.

    With ``M = pm_mesh_every > 1`` the long-range grids
    (:func:`mesh_lib.pm_mesh_state`) are carried: refreshed when ``i % M ==
    0``, ``i`` counted from 0 in every call as the JAX scan counts it, and
    interpolated stale at the current positions in between (extrapolated
    by ``(i % M)/M`` with ``pm_mesh_extrapolate``), with the stale
    self-term cancelled (``pm_self_correct``) and the ``pm_heavy_cap``
    heaviest bodies summed directly. A re-sort permutes the state's
    per-body arrays but not the grids. The kernel hats are computed once
    per call. Returns ``(state, stats)``, stats as 0-dim device tensors
    max-reduced over the steps; the input state is not modified.
    """
    M = max(1, cfg.pm_mesh_every)
    H = cfg.pm_heavy_cap
    if M > 1 and H <= 0:
        raise ValueError(
            "pm_mesh_every > 1 requires pm_heavy_cap > 0: heavy bodies "
            "riding a stale mesh feel their own deposited image as a "
            "spurious self-force far exceeding their real acceleration "
            "(ops/mesh.py pm_mesh_state).")
    origin, side = _root(cfg)
    K = max(1, cfg.pm_resort_every)
    knobs = _pm_knobs(cfg)
    extrap = cfg.pm_mesh_extrapolate and M > 1
    self_correct = cfg.pm_self_correct and M > 1

    def mesh_state(state, params, kernel, prev):
        return mesh_lib.pm_mesh_state(
            state.pos, state.mass, state.alive, params.soft2, origin, side,
            mesh_level=cfg.mesh_level, split_cells=cfg.mesh_split,
            order=cfg.mesh_order, interlace=cfg.mesh_interlace,
            mesh_ny=cfg.mesh_ny, heavy_cap=H,
            deconvolve=cfg.mesh_deconvolve, kernel=kernel, prev=prev,
            switch=cfg.mesh_switch)

    def accel_sorted(state, params, kernel, ms, frac=None):
        return mesh_lib.pm_accel_sorted(
            state.pos, state.mass, state.alive, params.G, params.soft2,
            origin, side, kernel=kernel, mesh_state=ms,
            self_correct=self_correct, stale_frac=frac, **knobs)

    def sort_order(state):
        codes = morton.hilbert_codes(state.pos, origin, side, state.alive)
        return torch.argsort(codes, stable=True)

    def step_n(state: SimState, params: Params, n_steps: int = 1):
        kernel = _kernel_hats(cfg, params, state.pos.device)
        perm = sort_order(state)
        state = _permute(state, perm)
        ms = None
        if M > 1:
            ms = mesh_state(state, params, kernel,
                            "zero" if extrap else None)
        acc, (resc, hot, oob) = accel_sorted(state, params, kernel, ms)
        heavy = torch.zeros_like(resc)
        half = params.dt * 0.5
        for i in range(n_steps):
            vel = state.vel + acc * half
            state = state._replace(pos=state.pos + vel * params.dt)
            frac = None
            if M > 1:
                if i % M == 0:
                    ms = mesh_state(state, params, kernel,
                                    ms[0] if extrap else None)
                frac = f32((i % M) / M)
            acc, (need, h, o) = accel_sorted(state, params, kernel, ms, frac)
            state = state._replace(vel=vel + acc * half, step=state.step + 1)
            state, hv = merge_bodies(state, params, heavy_cap=merge_heavy_cap)
            if (i + 1) % K == 0:
                o_ = sort_order(state)
                state, acc, perm = _permute(state, o_), acc[o_], perm[o_]
                if ms is not None:
                    grids, dep_pos, dep_wmass, heavy_mask = ms
                    ms = grids, dep_pos[o_], dep_wmass[o_], heavy_mask[o_]
            heavy = torch.maximum(heavy, hv)
            resc = torch.maximum(resc, need)
            hot = torch.maximum(hot, h)
            oob = torch.maximum(oob, o)
        unsort = torch.empty_like(perm)
        unsort[perm] = torch.arange(perm.shape[0], device=perm.device)
        state = _permute(state, unsort)
        return state, {"trav": None, "heavy_need": heavy,
                       "rescue_need": resc, "rescue_hot": hot,
                       "mesh_oob": oob}

    return step_n


def make_step_fn(cfg: SimConfig, caps: Caps, solver: str, integrator: str,
                 strict_parity: bool, merge_heavy_cap: int,
                 allpairs_impl: str = "auto", device="cuda") -> Callable:
    """Build step_n(state, params, n_steps) -> (state, stats).

    ``stats`` holds ``"trav"`` (a TraversalStats for bh, else None) and the
    :data:`STAT_KEYS`, all 0-dim device tensors max-reduced over the force
    passes and steps. pm + kdk_reuse + persistent sort takes
    :func:`_make_pm_sorted_step`; everything else the generic step, which
    runs ``_INTEGRATORS[integrator]`` (or kdk_reuse with a seed force pass
    and the carried acceleration) and merges after every step. With bh and
    ``strict_parity`` the reference's coincident-body nudge
    (:func:`tree_lib.strict_parity_nudge`) moves the positions once per
    step before the force pass; under kdk_reuse the carried acceleration is
    then that of the un-nudged positions, an O(1e-3 px) mismatch.
    ``device`` is where the pm kernel hats are built.
    """
    if (solver == "pm" and integrator == "kdk_reuse"
            and cfg.pm_persistent_sort):
        return _make_pm_sorted_step(cfg, merge_heavy_cap)
    if solver == "pm" and max(1, cfg.pm_mesh_every) > 1:
        raise ValueError(
            "pm_mesh_every > 1 (F_long subcycling) is only supported on "
            "the pm + kdk_reuse persistent-sort path (the carried grids "
            "live in its loop); use integrator='kdk_reuse' with "
            "pm_persistent_sort=True.")
    if solver == "bh":
        accel_stats = make_bh_accel(cfg, caps, strict_parity)
    elif solver == "allpairs":
        accel_stats = make_allpairs_accel(allpairs_impl)
    elif solver == "pm":
        accel_stats = make_pm_accel(cfg, device)
    else:
        raise ValueError(f"unknown solver {solver!r}")
    if integrator not in (*_INTEGRATORS, "kdk_reuse"):
        raise ValueError(f"unknown integrator {integrator!r}")
    prepare = getattr(accel_stats, "prepare", None)
    nudge = None
    if solver == "bh" and strict_parity:
        origin, side = _root(cfg)
        nudge = functools.partial(tree_lib.strict_parity_nudge,
                                  origin=origin, root_side=side)

    def step_n(state: SimState, params: Params, n_steps: int = 1):
        dev = state.pos.device
        extra = {} if prepare is None else {"kernel": prepare(params)}
        passes = []

        def accel(pos, mass, alive, params):
            acc, st = accel_stats(pos, mass, alive, params, **extra)
            passes.append(st)
            return acc

        def pass_stats():
            st = functools.reduce(_max_stats,
                                  [_split_aux(p, dev) for p in passes],
                                  _split_aux(None, dev))
            passes.clear()
            return st

        agg = _split_aux(None, dev)
        if integrator == "kdk_reuse":
            acc = accel(state.pos, state.mass, state.alive, params)  # seed
            agg = pass_stats()
        for _ in range(n_steps):
            if nudge is not None:
                state = state._replace(pos=nudge(state.pos, state.alive))
            if integrator == "kdk_reuse":
                state, acc = integrate.kdk_reuse_step(state, acc, params,
                                                      accel)
            else:
                state = _INTEGRATORS[integrator](state, params, accel)
            st = pass_stats()
            state, st["heavy_need"] = merge_bodies(
                state, params, heavy_cap=merge_heavy_cap)
            agg = _max_stats(agg, st)
        return state, agg

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

    def _record_stats(self, stats) -> dict:
        """Read the step's stats to the host in one transfer (the one host
        sync of a ``step(n)``) and keep them as ``last_*``."""
        trav = stats["trav"]
        parts = [torch.stack([stats[k].to(torch.int64) for k in STAT_KEYS])]
        if trav is not None:
            parts.append(trav.flat())
        vals = torch.cat(parts).tolist()
        rec = dict(zip(STAT_KEYS, vals))
        rec["trav"] = None if trav is None \
            else trav.on_host(vals[len(STAT_KEYS):])
        self.last_stats = rec["trav"]
        self.last_heavy_need = rec["heavy_need"]
        self.last_rescue_need = rec["rescue_need"]
        self.last_rescue_hot = rec["rescue_hot"]
        self.last_mesh_oob = rec["mesh_oob"]
        return rec

    def _overflowed(self, stats) -> bool:
        if stats["heavy_need"] > self.merge_heavy_cap:
            return True
        trav = stats["trav"]
        return trav is not None and trav.overflowed(self.caps.as_dict())

    def _run_with_retune(self, run: Callable):
        """Run ``run() -> (state, recorded_stats)``; on overflow, grow the
        caps, rebuild the step function and redo from the pre-run state (up
        to 6 rounds). Overflow means interactions (or merge absorbers) were
        dropped; iteration matters because a truncated list hides deeper
        needs, so one growth round may reveal more. ``self.state`` changes
        only at the end."""
        new_state, stats = run()
        rounds = 0
        while self.auto_retune and rounds < 6 and self._overflowed(stats):
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
        self.state = new_state
        return self.state

    def step(self, n: int = 1):
        """Advance ``n`` steps. Regrows the BH caps and the merge heavy cap
        on overflow."""

        def run():
            state, stats = self._step_fn(self.state, self.params, n_steps=n)
            return state, self._record_stats(stats)

        return self._run_with_retune(run)

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
            self.caps = t
            self._build_step()
            return True
        return False

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
