"""Time integrators (port of tpu_nbody.ops.integrate).

* :func:`kdk_step` — literal kick-drift-kick leapfrog, two force passes
  (``BarnesHutAlg.kt:405-439``).
* :func:`kdk_reuse_step` — leapfrog reusing the previous step's closing
  a(t+dt) as this step's opening a(t): one force pass per step.
* :func:`euler_step` — semi-implicit Euler (``gpu/GPU.kt:147-148``).

Every slot is updated; dead slots carry mass 0 and zero forces.
"""

from __future__ import annotations

from tpu_nbody_torch.state import SimState


def kdk_step(state: SimState, params, accel_fn) -> SimState:
    """One literal KDK step: a(t) kick/2, drift, a(t+dt) kick/2."""
    a = accel_fn(state.pos, state.mass, state.alive, params)
    half = params.dt * 0.5
    vel = state.vel + a * half
    pos = state.pos + vel * params.dt
    a2 = accel_fn(pos, state.mass, state.alive, params)
    vel = vel + a2 * half
    return state._replace(pos=pos, vel=vel, step=state.step + 1)


def kdk_reuse_step(state: SimState, acc, params, accel_fn):
    """One KDK step reusing the carried a(t); returns (state, a(t+dt)).
    ``acc`` must equal accel(state)."""
    half = params.dt * 0.5
    vel = state.vel + acc * half
    pos = state.pos + vel * params.dt
    a2 = accel_fn(pos, state.mass, state.alive, params)
    vel = vel + a2 * half
    return state._replace(pos=pos, vel=vel, step=state.step + 1), a2


def euler_step(state: SimState, params, accel_fn) -> SimState:
    """Semi-implicit Euler: v += a*dt; x += v*dt."""
    a = accel_fn(state.pos, state.mass, state.alive, params)
    vel = state.vel + a * params.dt
    pos = state.pos + vel * params.dt
    return state._replace(pos=pos, vel=vel, step=state.step + 1)
