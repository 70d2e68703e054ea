"""Simulation state: fixed-capacity structure of arrays (port of
tpu_nbody.state).

Tensors of static shape ``(capacity, dim)`` with an ``alive`` mask; dead
slots carry mass 0, so they are force-neutral by construction. Every
function here returns new tensors and leaves its input state untouched, so
the engine can re-run a step from the state it started with.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SimState(NamedTuple):
    pos: torch.Tensor    # (capacity, dim) float
    vel: torch.Tensor    # (capacity, dim) float
    mass: torch.Tensor   # (capacity,) float; 0 for dead slots
    alive: torch.Tensor  # (capacity,) bool
    step: torch.Tensor   # () int32 — global step counter

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def dim(self) -> int:
        return self.pos.shape[1]

    def n_alive(self) -> torch.Tensor:
        return self.alive.sum(dtype=torch.int32)


def check_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`. Raises for a CUDA device on a
    machine without one (the port never falls back to the CPU) and for any
    device type other than ``cpu`` and ``cuda``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is not "
                           "available; the port does not fall back to the "
                           "CPU (pass device='cpu' to run there)")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def empty_state(capacity: int, dim: int = 2, dtype=torch.float32, *,
                device) -> SimState:
    return SimState(
        pos=torch.zeros((capacity, dim), dtype=dtype, device=device),
        vel=torch.zeros((capacity, dim), dtype=dtype, device=device),
        mass=torch.zeros((capacity,), dtype=dtype, device=device),
        alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def from_arrays(pos, vel, mass, capacity: int | None = None,
                device="cuda") -> SimState:
    """Build a state on ``device`` from dense (n, dim) arrays, padding up to
    ``capacity``; raises when ``device`` is CUDA and there is no card."""
    pos = torch.as_tensor(pos, device=check_device(device))
    vel = torch.as_tensor(vel, dtype=pos.dtype, device=pos.device)
    mass = torch.as_tensor(mass, dtype=pos.dtype, device=pos.device)
    n, dim = pos.shape
    cap = capacity or n
    if n > cap:
        raise ValueError(f"{n} bodies exceed capacity {cap}")
    st = empty_state(cap, dim, pos.dtype, device=pos.device)
    st.pos[:n] = pos
    st.vel[:n] = vel
    st.mass[:n] = mass
    st.alive[:n] = True
    return st


def concat_bodies(state: SimState, pos, vel, mass) -> SimState:
    """Append new bodies into the lowest free slots.

    Bodies beyond the free slots are dropped silently and no live body is
    overwritten (callers check ``n_alive``), as in the JAX version. More
    bodies than the state has slots, which the JAX version refuses with a
    shape error, are first cut to the capacity, so the 5,000-body cloud or
    disk of the interactive window lands on a small engine too.
    """
    dev, dt = state.pos.device, state.pos.dtype
    pos = torch.as_tensor(pos, dtype=dt, device=dev)
    vel = torch.as_tensor(vel, dtype=dt, device=dev)
    mass = torch.as_tensor(mass, dtype=dt, device=dev)
    k = min(pos.shape[0], state.capacity)
    pos, vel, mass = pos[:k], vel[:k], mass[:k]
    free_rank = torch.where(state.alive, torch.iinfo(torch.int32).max, 0)
    order = torch.argsort(free_rank, stable=True)   # free slots first
    slots = order[:k]
    can = ~state.alive[slots]                        # only genuinely free
    out = SimState(state.pos.clone(), state.vel.clone(), state.mass.clone(),
                   state.alive.clone(), state.step)
    out.pos[slots] = torch.where(can[:, None], pos, state.pos[slots])
    out.vel[slots] = torch.where(can[:, None], vel, state.vel[slots])
    out.mass[slots] = torch.where(can, mass, state.mass[slots])
    out.alive[slots] = state.alive[slots] | can
    return out


def clear(state: SimState) -> SimState:
    """Remove all bodies (middle-mouse clear, ``NBodyPanel.kt:143-146``)."""
    return empty_state(state.capacity, state.dim, state.pos.dtype,
                       device=state.pos.device)._replace(step=state.step)


def compact(state: SimState) -> SimState:
    """Pack alive bodies to the front, keeping their relative order."""
    rank = torch.where(state.alive, 0, 1)
    order = torch.argsort(rank, stable=True)
    alive = state.alive[order]
    return state._replace(
        pos=state.pos[order],
        vel=state.vel[order],
        mass=torch.where(alive, state.mass[order], 0.0),
        alive=alive,
    )
