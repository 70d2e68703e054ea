"""Sharded engine: the reference's scene API with bodies sharded over a
rank group (port of tpu_nbody.parallel.engine).

:class:`ShardedEngine` keeps :class:`tpu_nbody_torch.engine.Engine`'s
surface while the state lives sharded over a
:class:`~tpu_nbody_torch.parallel.collectives.Group` and every step runs
the ranks' bodies (``parallel/sharded.py`` ring all-pairs,
``parallel/sharded_pm.py`` domain-decomposed P3M or
``parallel/sharded_bh.py`` domain-decomposed Barnes–Hut).

* Scene edits reuse the one-device Engine's methods on the global state
  (rare, host-driven events), then re-shard it with
  :func:`reshard_by_hilbert`, so each rank owns a contiguous Hilbert
  segment: the compact domain the sharded P3M's halo relies on.
* ``step`` runs in blocks of ``reshard_every`` steps: within a block the
  decomposition stays put; between blocks the device reshard
  (:func:`make_device_reshard`) refreshes it, so no body drifts past the
  short-range halo.
* The caps (merge heavy cap, cross-shard export, BH tree and LET caps)
  grow on overflow and the block is redone from its pre-block state, up
  to 6 rounds; a block that still overflows raises a ``RuntimeWarning``.
"""

from __future__ import annotations

import warnings

import torch

from tpu_nbody_torch import state as state_lib
from tpu_nbody_torch.config import Params, SimConfig
from tpu_nbody_torch.engine import Engine, _next_pow2
from tpu_nbody_torch.parallel.mesh import (BODY_AXIS, gather_state,
                                           make_mesh)
from tpu_nbody_torch.parallel.sharded import make_sharded_step
from tpu_nbody_torch.parallel.sharded_bh import make_sharded_bh_step
from tpu_nbody_torch.parallel.sharded_pm import (make_device_reshard,
                                                 make_sharded_pm_step,
                                                 reshard_by_hilbert)

MAX_REDO_ROUNDS = 6


class ShardedEngine(Engine):
    """Engine API with bodies sharded over a rank group.

    ``solver``: ``"pm"`` (domain-decomposed P3M, the scale path), ``"bh"``
    (domain-decomposed trees and a locally-essential export; kick-drift-kick
    with force reuse for ``integrator`` "kdk" and "kdk_reuse" alike) or
    ``"allpairs"`` (the exact ring). ``mesh`` is a
    :class:`~tpu_nbody_torch.parallel.collectives.Group` on ``device``
    (default: one rank there, :func:`make_mesh`). ``device`` is the card
    unless the caller asks for the CPU; without a card the default raises.
    ``state``, ``get_bodies`` and ``stats`` see the global state, the ranks'
    blocks in rank order. ``axis`` is the JAX constructor's mesh axis: a
    group has one, :data:`BODY_AXIS`, and any other name raises.
    """

    def __init__(self, cfg: SimConfig, params: Params | None = None, *,
                 mesh=None, solver: str = "pm", integrator: str = "kdk",
                 reshard_every: int = 8, heavy_cap_local: int = 16,
                 let_approx_cap: int = 2048, let_body_cap: int = 2048,
                 let_leaf_cap: int = 512, let_frontier_cap: int = 4096,
                 axis: str = BODY_AXIS, seed: int = 3, device="cuda"):
        if solver not in ("pm", "bh", "allpairs"):
            raise ValueError(
                f"ShardedEngine supports pm|bh|allpairs, got {solver!r}")
        if cfg.dim != 2:
            raise ValueError("ShardedEngine is 2D: its reshard orders bodies "
                             "along the 2D Hilbert curve")
        if axis != BODY_AXIS:
            raise ValueError(f"a group has the one axis {BODY_AXIS!r}, got "
                             f"{axis!r}")
        dev = state_lib.check_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(device=dev)
        if self.mesh.device != dev:
            raise ValueError(f"mesh runs on {self.mesh.device}, the engine "
                             f"on {dev}")
        self.reshard_every = int(reshard_every)
        self.heavy_cap_local = int(heavy_cap_local)
        self.let_approx_cap = int(let_approx_cap)
        self.let_body_cap = int(let_body_cap)
        self.let_leaf_cap = int(let_leaf_cap)
        self.let_frontier_cap = int(let_frontier_cap)
        self._steps_since_reshard = 0
        self._local = None        # the sharded state, one block a local rank
        self._global = None       # the global state, gathered when read
        self._device_reshard = None
        # pm: cross-shard rescue export cap (grown on overflow)
        self.xrescue_export = int(cfg.mesh_xrescue_export)
        self.last_xport_need = 0
        self.last_ximport_need = 0
        self.last_export_need = 0
        self._needs = {}
        super().__init__(cfg, params, solver=solver, integrator=integrator,
                         seed=seed, auto_retune=False, device=dev)

    # -------------------------------------------------------------- state
    @property
    def state(self):
        if self._global is None:
            self._global = gather_state(self._local, self.mesh)
        return self._global

    @state.setter
    def state(self, st):
        """A global state; the next step re-shards it (host path)."""
        self._global = st
        self._local = None

    # ------------------------------------------------------------ stepping
    def _build_step(self):
        if self.solver == "pm":
            self._step_fn = make_sharded_pm_step(
                self.mesh, self.cfg, integrator=self.integrator,
                heavy_cap_local=self.heavy_cap_local,
                xrescue_export=self.xrescue_export)
        elif self.solver == "bh":
            self._step_fn = make_sharded_bh_step(
                self.mesh, self.cfg, self.caps,
                heavy_cap_local=self.heavy_cap_local,
                let_approx_cap=self.let_approx_cap,
                let_body_cap=self.let_body_cap,
                let_leaf_cap=self.let_leaf_cap,
                let_frontier_cap=self.let_frontier_cap,
                integrator=self.integrator)
        else:
            self._step_fn = make_sharded_step(
                self.mesh, integrator=self.integrator,
                heavy_cap_local=self.heavy_cap_local)

    def _reshard(self):
        if self._local is not None:
            # periodic reshard inside a run: on the device, nothing gathered
            if self._device_reshard is None:
                self._device_reshard = make_device_reshard(self.mesh,
                                                           self.cfg)
            self._local = self._device_reshard(self._local)
        else:
            # fresh or host-edited state: one sort of the global state
            self._local = reshard_by_hilbert(self._global, self.mesh,
                                             self.cfg)
        self._global = None
        self._steps_since_reshard = 0

    def _read_needs(self, aux) -> dict:
        """A block's needs (a heavy need, PmShardStats or ShardedBHStats)
        as Python ints, read in one transfer, and kept as ``last_*``."""
        trav = getattr(aux, "trav", None)
        if isinstance(aux, tuple):
            names = [f for f in aux._fields if f != "trav"]
            vals = [getattr(aux, f) for f in names]
        else:
            names, vals = ["heavy_need"], [aux]
        parts = [torch.stack([v.to(torch.int64) for v in vals])]
        if trav is not None:
            parts.append(trav.flat())
        host = torch.cat(parts).tolist()
        needs = dict(zip(names, host))
        self.last_heavy_need = needs["heavy_need"]
        if trav is not None:
            needs["trav"] = self.last_stats = trav.on_host(host[len(names):])
            self.last_export_need = needs["export_need"]
        if "xport_need" in needs:
            self.last_rescue_need = needs["rescue_need"]
            self.last_xport_need = needs["xport_need"]
            self.last_ximport_need = needs["ximport_need"]
            self.last_mesh_oob = needs["mesh_oob"]
        return needs

    def _capped_needs(self, needs: dict) -> list:
        """(attribute, need) of every scalar cap a block is held to: the
        merge heavy cap; for pm the cross-shard export (rescue needs are
        informational, as the closest-first ranking drops only the
        farthest boxes, but a dropped export hides a block a remote rank
        needs); for bh each of the four LET pools against its own need
        (the JAX engine tests the node and body pools' sum, which misses a
        full body pool beside a node pool with room)."""
        out = [("heavy_cap_local", needs["heavy_need"])]
        if self.solver == "pm" and self.cfg.mesh_xrescue > 0:
            out.append(("xrescue_export", needs["xport_need"]))
        if self.solver == "bh":
            out += [(f"let_{k}_cap", needs[f"let_{k}_need"])
                    for k in ("approx", "body", "leaf", "frontier")]
        return out

    def _overflows(self, needs: dict) -> list:
        """(cap name, cap, need) of every cap the block overflowed, which
        means dropped absorbers, cross-shard pairs or interactions."""
        out = [(attr, getattr(self, attr), need)
               for attr, need in self._capped_needs(needs)
               if need > getattr(self, attr)]
        if self.solver == "bh":
            out += needs["trav"].overflows(self.caps.as_dict())
        return out

    def _grow_on_overflow(self, aux) -> bool:
        """Read a block's needs and grow each overflowed cap to twice its
        need (the heavy cap at most to a rank's slots; the BH tree caps by
        :meth:`Caps.grown`); True if any cap changed."""
        needs = self._needs = self._read_needs(aux)
        limit = {"heavy_cap_local": self.cfg.capacity // self.mesh.size}
        grew = False
        for attr, need in self._capped_needs(needs):
            cap = getattr(self, attr)
            if need > cap:
                new = _next_pow2(2 * need)
                new = min(new, limit.get(attr, new))
                if new != cap:
                    setattr(self, attr, new)
                    grew = True
        if self.solver == "bh" and needs["trav"].overflowed(
                self.caps.as_dict()):
            grown = self.caps.grown(needs["trav"])
            if grown != self.caps:
                self.caps = grown
                grew = True
        return grew

    def step(self, n: int = 1):
        """Advance ``n`` steps, resharding every ``reshard_every``; a block
        whose caps overflow is redone with grown caps (up to 6 rounds)."""
        if self._local is None:
            self._reshard()
        remaining = int(n)
        while remaining > 0:
            if self._steps_since_reshard >= self.reshard_every:
                self._reshard()
            blk = min(remaining,
                      self.reshard_every - self._steps_since_reshard)
            pre = self._local
            new, aux = self._step_fn(pre, self.params, n_steps=blk)
            rounds = 0
            while rounds < MAX_REDO_ROUNDS and self._grow_on_overflow(aux):
                self._build_step()
                new, aux = self._step_fn(pre, self.params, n_steps=blk)
                rounds += 1
            if rounds == MAX_REDO_ROUNDS:
                self._needs = self._read_needs(aux)
            over = self._overflows(self._needs)
            if over:
                warnings.warn(
                    f"ShardedEngine.step: a block of {blk} steps still "
                    f"overflows after {rounds} retune rounds, so absorbers, "
                    f"cross-shard pairs or interactions were dropped: "
                    + "; ".join(f"{name} {cap} < need {need}"
                                for name, cap, need in over),
                    RuntimeWarning, stacklevel=2)
            self._local = new
            self._global = None
            self._steps_since_reshard += blk
            remaining -= blk
        return self.state

    # --------------------------------------------------------- scene edits
    # Engine's edits act on the global state; re-shard after (host path)
    def set_bodies(self, pos, vel, mass):
        super().set_bodies(pos, vel, mass)
        self._reshard()

    def add_bodies(self, pos, vel, mass):
        super().add_bodies(pos, vel, mass)
        self._reshard()

    def clear(self):
        super().clear()
        self._reshard()
