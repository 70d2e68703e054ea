"""High-level simulation engine (port of tpu_nbody.engine).

Host-side orchestration of device work. Solvers: ``"pm"`` (P3M, every
knob of the JAX engine) and ``"allpairs"`` (exact O(N²), the hand-written
all-pairs kernel on the card). Integrators: ``"kdk"`` (two force passes a
step), ``"kdk_reuse"`` (one) and ``"euler"``. ``solver="bh"`` and 3D raise
``NotImplementedError``.

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

import functools
from typing import Callable

import torch

from tpu_nbody_torch import state as state_lib
from tpu_nbody_torch.config import (CENTRAL_MASS, ROADMAP_NOTE, Params,
                                    SimConfig, f32)
from tpu_nbody_torch.models import scenes
from tpu_nbody_torch.ops import forces, integrate
from tpu_nbody_torch.ops import mesh as mesh_lib
from tpu_nbody_torch.ops import morton
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


def check_ported(cfg: SimConfig, solver: str, integrator: str,
                 strict_parity: bool = False, allpairs_impl: str = "auto"):
    """Raise ``NotImplementedError`` for what the port does not run yet
    (``solver="bh"``, ``dim != 2``) and ``ValueError`` for an unknown name
    or a switch the port does not honour: ``strict_parity`` outside bh,
    which the JAX engine ignores there, and ``allpairs_impl="xla"``."""
    mesh_lib._check_switch(cfg.mesh_switch)
    mesh_lib._check_order(cfg.mesh_order)
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}")
    if integrator not in (*_INTEGRATORS, "kdk_reuse"):
        raise ValueError(f"unknown integrator {integrator!r}")
    refused = []
    if solver == "bh":
        refused.append("solver='bh'")
    if cfg.dim != 2:
        refused.append(f"dim={cfg.dim}")
    if refused:
        raise NotImplementedError(f"{', '.join(refused)}: {ROADMAP_NOTE}")
    if strict_parity:
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
    """A force pass's stats (pm dict or None) as the step stats dict, the
    merge's ``heavy_need`` still 0."""
    zero = torch.zeros((), dtype=torch.int32, device=device)
    st = st or {}
    return {k: st.get(k, zero) for k in STAT_KEYS}


def _max_stats(a, b):
    """None-tolerant elementwise max of two stats dicts."""
    if a is None or b is None:
        return a if b is None else b
    return {k: torch.maximum(a[k], b[k]) for k in a}


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
        return state, {"heavy_need": heavy, "rescue_need": resc,
                       "rescue_hot": hot, "mesh_oob": oob}

    return step_n


def make_step_fn(cfg: SimConfig, solver: str, integrator: str,
                 merge_heavy_cap: int, allpairs_impl: str = "auto",
                 device="cuda") -> Callable:
    """Build step_n(state, params, n_steps) -> (state, stats).

    ``stats`` holds the :data:`STAT_KEYS` as 0-dim device tensors,
    max-reduced over the steps. pm + kdk_reuse + persistent sort takes
    :func:`_make_pm_sorted_step`; everything else the generic step, which
    runs ``_INTEGRATORS[integrator]`` (or kdk_reuse with a seed force pass
    and the carried acceleration) and merges after every step. ``device``
    is where the pm kernel hats are built.
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
    if solver == "allpairs":
        accel_stats = make_allpairs_accel(allpairs_impl)
    elif solver == "pm":
        accel_stats = make_pm_accel(cfg, device)
    else:
        raise ValueError(f"unknown solver {solver!r}")
    if integrator not in (*_INTEGRATORS, "kdk_reuse"):
        raise ValueError(f"unknown integrator {integrator!r}")
    prepare = getattr(accel_stats, "prepare", None)

    def step_n(state: SimState, params: Params, n_steps: int = 1):
        dev = state.pos.device
        extra = {} if prepare is None else {"kernel": prepare(params)}
        passes = []

        def accel(pos, mass, alive, params):
            acc, st = accel_stats(pos, mass, alive, params, **extra)
            passes.append(st)
            return acc

        def pass_stats():
            st = _split_aux(functools.reduce(_max_stats, passes, None), dev)
            passes.clear()
            return st

        agg = _split_aux(None, dev)
        if integrator == "kdk_reuse":
            acc = accel(state.pos, state.mass, state.alive, params)  # seed
            agg = pass_stats()
        for _ in range(n_steps):
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
    generators. The defaults are ``solver="pm"`` and
    ``integrator="kdk_reuse"``, the bench's main path: the JAX engine
    defaults to "bh" and "kdk", and the port keeps "pm" until Barnes–Hut
    is ported. ``allpairs_impl`` "auto" and "pallas" both run the
    hand-written all-pairs kernel; "xla" raises ``ValueError``. The step
    function is built here, so every refusal comes at construction.
    """

    def __init__(self, cfg: SimConfig, params: Params | None = None, *,
                 solver: str = "pm", integrator: str = "kdk_reuse",
                 strict_parity: bool = False, merge_heavy_cap: int = 64,
                 allpairs_impl: str = "auto", seed: int = 3,
                 auto_retune: bool = True, device="cuda"):
        check_ported(cfg, solver, integrator, strict_parity, allpairs_impl)
        self.device = state_lib.check_device(device)
        self.cfg = cfg
        self.params = params or Params.default()
        self.solver = solver
        self.integrator = integrator
        self.allpairs_impl = allpairs_impl
        self.merge_heavy_cap = merge_heavy_cap
        self.auto_retune = auto_retune
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.state = state_lib.empty_state(cfg.capacity, cfg.dim, cfg.tdtype,
                                           device=self.device)
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
        self._step_fn = make_step_fn(self.cfg, self.solver, self.integrator,
                                     self.merge_heavy_cap,
                                     self.allpairs_impl, self.device)

    def _record_stats(self, stats) -> dict:
        vals = torch.stack([stats[k].to(torch.int64) for k in STAT_KEYS])
        rec = dict(zip(STAT_KEYS, vals.tolist()))     # the one host sync
        self.last_heavy_need = rec["heavy_need"]
        self.last_rescue_need = rec["rescue_need"]
        self.last_rescue_hot = rec["rescue_hot"]
        self.last_mesh_oob = rec["mesh_oob"]
        return rec

    def _run_with_retune(self, run: Callable):
        """Run ``run() -> (state, recorded_stats)``; while the merge heavy
        set overflowed, grow ``merge_heavy_cap`` and redo from the pre-run
        state (up to 6 rounds). ``self.state`` changes only at the end."""
        new_state, stats = run()
        rounds = 0
        while (self.auto_retune and rounds < 6
               and stats["heavy_need"] > self.merge_heavy_cap):
            self.merge_heavy_cap = min(self.cfg.capacity,
                                       _next_pow2(2 * stats["heavy_need"]))
            self._build_step()
            new_state, stats = run()
            rounds += 1
        self.state = new_state
        return self.state

    def step(self, n: int = 1):
        """Advance ``n`` steps. Regrows the merge heavy cap on overflow."""

        def run():
            state, stats = self._step_fn(self.state, self.params, n_steps=n)
            return state, self._record_stats(stats)

        return self._run_with_retune(run)

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

    def reset_default_scene(self, n1: int = 10_000, n2: int = 2_500):
        p, v, m = scenes.default_two_disk_scene(
            self.generator, n1=n1, n2=n2, world_w=self.cfg.world_w,
            world_h=self.cfg.world_h, G=self.params.G, dtype=self.cfg.tdtype)
        self.set_bodies(p, v, m)

    def add_galaxy_disk(self, x, y, r=None, n=None, vx=0.0, vy=0.0, **kw):
        """LMB drag equivalent (``NBodyPanel.kt:170,228-234``)."""
        r = 100.0 if r is None else float(r)
        n = 5_000 if n is None else n
        p, v, m = scenes.make_galaxy_disk(
            self.generator, n, x=x, y=y, r=r, vx=vx, vy=vy, G=self.params.G,
            world_w=self.cfg.world_w, world_h=self.cfg.world_h,
            dtype=self.cfg.tdtype, **kw)
        self.add_bodies(p, v, m)

    def add_kepler_disk(self, x, y, r=None, n=5_000, vx=0.0, vy=0.0, **kw):
        p, v, m = scenes.make_kepler_disk(
            self.generator, n, x=x, y=y, r=r, vx=vx, vy=vy, G=self.params.G,
            world_w=self.cfg.world_w, world_h=self.cfg.world_h,
            dtype=self.cfg.tdtype, **kw)
        self.add_bodies(p, v, m)

    def add_black_hole(self, x, y, vx=0.0, vy=0.0, mass=None):
        """RMB drag: one body of CENTRAL_MASS (``NBodyPanel.kt:171``),
        which feeds the merge rule."""
        m = CENTRAL_MASS if mass is None else mass
        dt = self.cfg.tdtype
        self.add_bodies(torch.tensor([[float(x), float(y)]], dtype=dt),
                        torch.tensor([[float(vx), float(vy)]], dtype=dt),
                        torch.tensor([float(m)], dtype=dt))

    def add_cloud(self, n: int = 5_000, m: float = 0.5):
        """C key (``NBodyPanel.kt:282-286``)."""
        p, v, mm = scenes.make_uniform_cloud(
            self.generator, n, m, world_w=self.cfg.world_w,
            world_h=self.cfg.world_h, dtype=self.cfg.tdtype)
        self.add_bodies(p, v, mm)

    def compact(self):
        """Pack alive bodies to the front (after heavy merging)."""
        self.state = state_lib.compact(self.state)

    def stats(self, potential: bool | None = None):
        """HUD scalars as host numpy. ``potential`` (O(N²)) defaults on up
        to 64k capacity, off above."""
        from tpu_nbody_torch.ops import diagnostics
        if potential is None:
            potential = self.cfg.capacity <= 65536
        out = diagnostics.stats(self.state, self.params, potential=potential)
        return {k: v.cpu().numpy() for k, v in out.items()}
