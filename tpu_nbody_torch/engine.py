"""High-level simulation engine (port of tpu_nbody.engine, P3M main path).

Host-side orchestration of device work. The port runs one configuration
of the JAX engine: ``solver="pm"`` with ``integrator="kdk_reuse"`` and
persistent Hilbert-sorted state (:func:`_make_pm_sorted_step`). Other
solvers, integrators and P3M knobs raise ``NotImplementedError``.

A ``step(n)`` call runs the seed force pass and ``n`` steps as a Python loop
of eager device work with no host sync inside; the stats are max-reduced on
the device and read to the host once per call, as the JAX engine does after
its jitted scan.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpu_nbody_torch import state as state_lib
from tpu_nbody_torch.config import (CENTRAL_MASS, ROADMAP_NOTE, Params,
                                    SimConfig)
from tpu_nbody_torch.models import scenes
from tpu_nbody_torch.ops import mesh as mesh_lib
from tpu_nbody_torch.ops import morton
from tpu_nbody_torch.ops.merge import merge_bodies
from tpu_nbody_torch.state import SimState

STAT_KEYS = ("heavy_need", "rescue_need", "rescue_hot", "mesh_oob")


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 1).bit_length()


def check_ported(cfg: SimConfig, solver: str, integrator: str,
                 strict_parity: bool = False):
    """Raise ``NotImplementedError`` for every knob the port does not run
    yet, instead of ignoring it, and ``ValueError`` for an unknown switch."""
    mesh_lib._check_switch(cfg.mesh_switch)
    refused = []
    if solver != "pm":
        refused.append(f"solver={solver!r}")
    if integrator != "kdk_reuse":
        refused.append(f"integrator={integrator!r}")
    if strict_parity:
        refused.append("strict_parity=True")
    if cfg.dim != 2:
        refused.append(f"dim={cfg.dim}")
    if not cfg.pm_persistent_sort:
        refused.append("pm_persistent_sort=False")
    if cfg.mesh_order != 2:
        refused.append(f"mesh_order={cfg.mesh_order}")
    if cfg.mesh_interlace:
        refused.append("mesh_interlace=True")
    if cfg.mesh_rescue_hot > 0:
        refused.append(f"mesh_rescue_hot={cfg.mesh_rescue_hot}")
    if cfg.pm_mesh_every > 1:
        refused.append(f"pm_mesh_every={cfg.pm_mesh_every}")
    if cfg.pm_heavy_cap > 0:
        refused.append(f"pm_heavy_cap={cfg.pm_heavy_cap}")
    if refused:
        raise NotImplementedError(f"{', '.join(refused)}: {ROADMAP_NOTE}")


def _root(cfg: SimConfig):
    ox, oy = cfg.root_center
    return (ox - cfg.root_half, oy - cfg.root_half), 2.0 * cfg.root_half


def _make_pm_sorted_step(cfg: SimConfig, merge_heavy_cap: int) -> Callable:
    """step_n for solver="pm" + integrator="kdk_reuse" with persistent
    Hilbert-sorted state.

    The state is sorted once by the seed pass, integrated and merged in the
    sorted frame, re-sorted every ``cfg.pm_resort_every`` steps (a Python
    ``if`` on the loop counter), and returned to its original slot order at
    the end, so slot identity is unchanged for the caller. Under the sorted
    carry, merge ties break by lowest Hilbert position, as in the JAX
    engine (``tpu_nbody/engine.py:260-353``). The kernel hats are computed
    once per call. Returns ``(state, stats)``, stats as 0-dim device
    tensors max-reduced over the steps; the input state is not modified.
    """
    origin, side = _root(cfg)
    K = max(1, cfg.pm_resort_every)
    chunk = min(cfg.mesh_chunk, cfg.capacity)

    def accel_sorted(pos, mass, alive, params, kernel):
        return mesh_lib.pm_accel_sorted(
            pos, mass, alive, params.G, params.soft2, origin, side,
            mesh_level=cfg.mesh_level, split_cells=cfg.mesh_split,
            band=cfg.mesh_band, chunk=chunk, order=cfg.mesh_order,
            interlace=cfg.mesh_interlace, rescue_k=cfg.mesh_rescue,
            rescue_k_hot=cfg.mesh_rescue_hot, mesh_ny=cfg.mesh_ny,
            kernel=kernel, switch=cfg.mesh_switch)

    def permute(state, o):
        return state._replace(pos=state.pos[o], vel=state.vel[o],
                              mass=state.mass[o], alive=state.alive[o])

    def sort_order(state):
        codes = morton.hilbert_codes(state.pos, origin, side, state.alive)
        return torch.argsort(codes, stable=True)

    def step_n(state: SimState, params: Params, n_steps: int = 1):
        kernel = mesh_lib.kernel_hats_for(
            side, params.soft2, mesh_level=cfg.mesh_level,
            split_cells=cfg.mesh_split, mesh_ny=cfg.mesh_ny,
            dtype=cfg.tdtype, order=cfg.mesh_order,
            deconvolve=cfg.mesh_deconvolve, switch=cfg.mesh_switch,
            device=state.pos.device)
        perm = sort_order(state)
        state = permute(state, perm)
        acc, (resc, hot, oob) = accel_sorted(state.pos, state.mass,
                                             state.alive, params, kernel)
        heavy = torch.zeros_like(resc)
        half = params.dt * 0.5
        for i in range(n_steps):
            vel = state.vel + acc * half
            pos = state.pos + vel * params.dt
            acc, (need, h, o) = accel_sorted(pos, state.mass, state.alive,
                                             params, kernel)
            vel = vel + acc * half
            state = state._replace(pos=pos, vel=vel, step=state.step + 1)
            state, hv = merge_bodies(state, params, heavy_cap=merge_heavy_cap)
            if (i + 1) % K == 0:
                o_ = sort_order(state)
                state, acc, perm = permute(state, o_), acc[o_], perm[o_]
            heavy = torch.maximum(heavy, hv)
            resc = torch.maximum(resc, need)
            hot = torch.maximum(hot, h)
            oob = torch.maximum(oob, o)
        unsort = torch.empty_like(perm)
        unsort[perm] = torch.arange(perm.shape[0], device=perm.device)
        state = permute(state, unsort)
        return state, {"heavy_need": heavy, "rescue_need": resc,
                       "rescue_hot": hot, "mesh_oob": oob}

    return step_n


class Engine:
    """The reference's scene API over the port's P3M main path.

    ``device`` is where the state lives and the step runs: the card unless
    the caller passes ``device="cpu"``. Without a card the default raises
    (there is no CPU fallback).
    ``seed`` seeds a ``torch.Generator`` on that device for the scene
    generators. The defaults for ``solver`` and ``integrator`` are the
    ones the port runs (the JAX engine defaults to "bh" and "kdk").
    """

    def __init__(self, cfg: SimConfig, params: Params | None = None, *,
                 solver: str = "pm", integrator: str = "kdk_reuse",
                 strict_parity: bool = False, merge_heavy_cap: int = 64,
                 seed: int = 3, auto_retune: bool = True, device="cuda"):
        check_ported(cfg, solver, integrator, strict_parity)
        self.device = state_lib.check_device(device)
        self.cfg = cfg
        self.params = params or Params.default()
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
        self.last_rescue_hot: int = 0
        # Alive bodies outside the rectangular mesh window (cfg.mesh_ny);
        # nonzero means the window is mis-sized for the scene.
        self.last_mesh_oob: int = 0
        self._step_fn = None

    # ------------------------------------------------------------ stepping
    def _build_step(self):
        self._step_fn = _make_pm_sorted_step(self.cfg, self.merge_heavy_cap)

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
        if self._step_fn is None:
            self._build_step()

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
