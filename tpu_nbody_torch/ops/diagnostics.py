"""On-device diagnostics: energy, momentum, centre of mass, body counts
(port of tpu_nbody.ops.diagnostics). Every reduction runs on the bodies'
device; only O(1) scalars cross to the host."""

from __future__ import annotations

import torch

from tpu_nbody_torch.ops import forces
from tpu_nbody_torch.state import SimState


def kinetic_energy(state: SimState):
    v2 = torch.sum(state.vel * state.vel, dim=-1)
    return 0.5 * torch.sum(state.mass * v2)


def momentum(state: SimState):
    return torch.sum(state.mass[:, None] * state.vel, dim=0)


def center_of_mass(state: SimState):
    m = torch.sum(state.mass)
    com = torch.sum(state.mass[:, None] * state.pos, dim=0)
    return torch.where(m > 0, com / torch.clamp(m, min=1e-30), 0.0)


def angular_momentum_z(state: SimState):
    """L_z about the centre of mass (2D scalar / 3D z-component)."""
    r = state.pos - center_of_mass(state)
    return torch.sum(state.mass * (r[:, 0] * state.vel[:, 1]
                                   - r[:, 1] * state.vel[:, 0]))


def stats(state: SimState, params, potential: bool = True):
    """Scalar HUD dict of device tensors. ``potential`` adds the O(N²)
    pairwise potential energy and the total energy."""
    ke = kinetic_energy(state)
    out = {
        "n_alive": state.n_alive(),
        "step": state.step,
        "kinetic": ke,
        "momentum": momentum(state),
        "com": center_of_mass(state),
        "angular_momentum_z": angular_momentum_z(state),
        "total_mass": torch.sum(state.mass),
    }
    if potential:
        pe = forces.potential_energy(state.pos, state.mass, params.G,
                                     params.soft2)
        out["potential"] = pe
        out["energy"] = ke + pe
    return out
