"""Faults planted under the timed path, for the tests: each wraps the
program (:class:`nbody_bench.system.Program`) so that its engine's
``step`` or the loop's frame goes wrong in one way. :data:`FAULTS` are
step faults every cell can have; :data:`FAULTS_3D` those of a 3D
Euler cell with no merging, where a merge fault changes nothing."""

from __future__ import annotations

import torch

from nbody_bench.system import Program


class _Wrapped:
    """The engine with ``step`` replaced by ``fault(engine, n)``."""

    def __init__(self, eng, fault):
        self._eng, self._fault = eng, fault

    def __getattr__(self, name):
        return getattr(self._eng, name)

    def __setattr__(self, name, value):
        if name in ("_eng", "_fault"):
            object.__setattr__(self, name, value)
        else:
            setattr(self._eng, name, value)

    def step(self, n):
        return self._fault(self._eng, n)


def unchanged(eng, n):
    """The step returns its state unchanged."""
    return eng.state


def half_left_out(eng, n):
    """Every second body keeps its state: half the batch left out."""
    before = eng.state
    after = eng.step(n)
    keep = torch.zeros(before.alive.shape, dtype=torch.bool,
                       device=before.alive.device)
    keep[::2] = True
    eng.state = after._replace(
        pos=torch.where(keep[:, None], before.pos, after.pos),
        vel=torch.where(keep[:, None], before.vel, after.vel))
    return eng.state


def one_altered(eng, n):
    """One body's position moved by 20 px where the step produces it."""
    after = eng.step(n)
    i = int(torch.nonzero(after.alive)[len(after.alive) // 3])
    pos = after.pos.clone()
    pos[i, 0] += 20.0
    eng.state = after._replace(pos=pos)
    return eng.state


def merge_skipped(eng, n):
    """The step runs without its merge (the absorb distance set to 0)."""
    real = eng.params
    eng.params = real.replace(merge_min_dist=0.0)
    try:
        return eng.step(n)
    finally:
        eng.params = real


def merge_too_far(eng, n):
    """The step absorbs at ten times the absorb distance: bodies the rule
    keeps are killed, their mass kept."""
    real = eng.params
    eng.params = real.replace(merge_min_dist=10.0 * real.merge_min_dist)
    try:
        return eng.step(n)
    finally:
        eng.params = real


def mass_lost(eng, n):
    """The step absorbs, but the heavies keep the mass they had: the
    victims' mass is lost."""
    before = eng.state
    heavy = before.alive & (before.mass > eng.params.merge_max_mass)
    after = eng.step(n)
    eng.state = after._replace(mass=torch.where(heavy, before.mass,
                                                after.mass))
    return eng.state


def z_dropped(eng, n):
    """The forces lose their z component: each Euler step leaves the z
    velocity as it was and drifts z by it."""
    dt = eng.params.dt
    for _ in range(n):
        before = eng.state
        after = eng.step(1)
        vz = before.vel[:, 2:]
        eng.state = after._replace(
            vel=torch.cat([after.vel[:, :2], vz], dim=1),
            pos=torch.cat([after.pos[:, :2], before.pos[:, 2:] + vz * dt],
                          dim=1))
    return eng.state


FAULTS = {"unchanged": unchanged, "half_left_out": half_left_out,
          "one_altered": one_altered, "merge_skipped": merge_skipped,
          "merge_too_far": merge_too_far, "mass_lost": mass_lost}
FAULTS_3D = {"unchanged": unchanged, "half_left_out": half_left_out,
             "one_altered": one_altered, "z_dropped": z_dropped}


def program_with(fault):
    """A ``make_system`` whose engine steps with ``fault``."""
    def make(config, device, workload=None):
        p = Program(config, device)
        p.eng = _Wrapped(p.eng, fault)
        return p
    return make


def program_as(integrator: str):
    """A ``make_system`` whose engine steps by ``integrator`` in place of
    the configuration's (kick-drift-kick in place of Euler)."""
    def make(config, device, workload=None):
        return Program({**config, "integrator": integrator}, device)
    return make


def camera_turned(monkeypatch, by: float = 0.05):
    """The program's 3D frames rendered at a yaw ``by`` rad past the one
    the loop returns."""
    from tpu_nbody_torch.ops import render

    real = render.render_frame_3d

    def turned(*args, cam_angle=0.0, **kw):
        return real(*args, cam_angle=cam_angle + by, **kw)

    monkeypatch.setattr(render, "render_frame_3d", turned)
