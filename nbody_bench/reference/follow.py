"""The reference's steps over one call, by the configuration's integrator.

``kdk`` and ``kdk_reuse``: kick-drift-kick with a carried acceleration.
From a state (positions, velocities, masses, alive flags) the reference
runs the call's force pass at the start (its seed) and then, each step:
half kick, drift, a force pass at the new positions, half kick, the
absorb rule (:mod:`.merge`). ``euler``: semi-implicit Euler, each step a
force pass at the step's start, v += a·dt, then x += v·dt, then the
absorb rule.

With a mesh ``solver`` (2D) every body follows the plain P3M
(:mod:`.p3m`); the sampled targets follow the same steps under exact
forces (:mod:`.gravity`) from every body's P3M positions and masses, and
the absorb rule among them (the heavies are always targets), each
target's sum leaving out its own copy among the bodies. With none (3D,
where there is no mesh reference) every body follows exact forces, and
the targets are its rows. Each body's closest approach to an alive
heavy, where the absorb rule looks (after each drift), is kept over the
call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nbody_bench.reference import gravity, merge
from nbody_bench.reference.p3m import P3M


class Physics(NamedTuple):
    G: float
    dt: float
    soft2: float
    merge_max_mass: float
    merge_min_dist: float


class Followed(NamedTuple):
    pos: torch.Tensor           # every body, the plain P3M
    vel: torch.Tensor
    mass: torch.Tensor
    alive: torch.Tensor
    tpos: torch.Tensor          # the targets, exact forces
    tvel: torch.Tensor
    talive: torch.Tensor
    closest: torch.Tensor       # every body, px to the nearest alive heavy


INTEGRATORS = ("kdk", "kdk_reuse", "euler")


def follow(pos, vel, mass, alive, targets, steps: int, phys: Physics,
           solver: P3M | None, integrator: str = "kdk_reuse",
           dtype=torch.float64) -> Followed:
    """The reference's state after ``steps`` steps from the given one."""
    if integrator not in INTEGRATORS:
        raise ValueError(f"integrator {integrator!r}: expected one of "
                         f"{INTEGRATORS}")
    kdk = integrator != "euler"
    P = pos.to(dtype)
    V = vel.to(dtype)
    A = alive.clone()
    M = torch.where(A, mass.to(dtype), 0.0)
    TP, TV, TA = P[targets].clone(), V[targets].clone(), A[targets].clone()
    half, dt = 0.5 * phys.dt, phys.dt
    everyone = torch.arange(P.shape[0], device=P.device)

    def exact(tp):
        return gravity.direct_accel(tp, P, M, phys.G, phys.soft2,
                                    self_idx=targets, dtype=dtype)

    def accel(P, M):
        if solver is None:
            return gravity.direct_accel(P, P, M, phys.G, phys.soft2,
                                        self_idx=everyone, dtype=dtype)
        return solver.accel(P, M)

    if kdk:
        a = accel(P, M)
        ta = exact(TP) if solver is not None else None
    closest = torch.full(A.shape, float("inf"), dtype=dtype, device=P.device)
    for _ in range(steps):
        if kdk:
            V = V + a * half
            P = P + V * dt
        else:
            ta = exact(TP) if solver is not None else None
            V = V + accel(P, M) * dt
            P = P + V * dt
        for h in merge.heavies(M, A, phys.merge_max_mass).tolist():
            closest = torch.minimum(closest,
                                    torch.linalg.norm(P - P[h], dim=1))
        if kdk:
            a = accel(P, M)
            V = V + a * half
        if solver is not None:
            if kdk:
                TV = TV + ta * half
                TP = TP + TV * dt
                ta = exact(TP)
                TV = TV + ta * half
            else:
                TV = TV + ta * dt
                TP = TP + TV * dt
            tm = torch.where(TA, M[targets], 0.0)
            _, TA = merge.absorb(TP, tm, TA, phys.merge_max_mass,
                                 phys.merge_min_dist)
        M, A = merge.absorb(P, M, A, phys.merge_max_mass,
                            phys.merge_min_dist)
    if solver is None:
        TP, TV, TA = P[targets], V[targets], A[targets]
    return Followed(P, V, M, A, TP, TV, TA, closest)
