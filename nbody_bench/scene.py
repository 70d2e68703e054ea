"""The two-disk collision, made on the device from the run's seed.

A frozen copy of the program's generator (``NBodyPanel.kt:83-100``,
``BodyFactory.kt:63-147``), so that the inputs cannot move with the
program: an n1-body galaxy disk (r = 300, central mass 50,000, satellites
5,000 in all) centred in the 2400 x 800 window, and an n2-body disk
(r = 100, 5,000 and 500) at y = 0.2 H drifting at vx = -50. Each disk is
an exponential profile of scale r/3 by inverse CDF on [min_r, r] with an
m = 2 bar tapered at 0.6 r, on circular orbits from the enclosed mass
with 1% speed jitter; body 0 of each disk is its central mass. Eight
``torch.rand`` calls on a ``torch.Generator`` on the device make every
number; the same seed gives the same bodies, and every seed the same
counts.
"""

from __future__ import annotations

import math

import torch


def _disk(gen, n, *, x, y, r, min_r, central_mass, total_satellite_mass, G,
          vx=0.0, vy=0.0, eps_m2=0.03, speed_jitter=0.01, dtype):
    dev = gen.device
    u_r, u_ang, u_v, _ = [torch.rand((n - 1,), generator=gen, dtype=dtype,
                                     device=dev) for _ in range(4)]
    Rd, taper_r = r / 3.0, r * 0.6
    A = math.exp(-(r - min_r) / Rd)
    R = min_r - Rd * torch.log(1.0 - u_r * (1.0 - A))
    theta = u_ang * 2.0 * math.pi
    R2 = R * (1.0 + eps_m2 * torch.cos(2.0 * theta)
              * torch.exp(-(R / taper_r) ** 2))
    center = torch.tensor([x, y], dtype=dtype, device=dev)
    sat = center + R2[:, None] * torch.stack([torch.cos(theta),
                                              torch.sin(theta)], dim=-1)
    pos = torch.cat([center[None], sat])
    mass = torch.cat([torch.tensor([central_mass], dtype=dtype, device=dev),
                      torch.full((n - 1,), total_satellite_mass / (n - 1),
                                 dtype=dtype, device=dev)])
    # circular speed from the enclosed mass (a stable sort by radius)
    d = pos - center
    rr = torch.linalg.norm(d, dim=-1)
    order = torch.argsort(rr, stable=True)
    menc = torch.empty_like(rr)
    menc[order] = torch.cumsum(mass[order], dim=0)
    rr = torch.clamp(rr, min=1e-6)
    jitter = torch.cat([torch.full((1,), 0.5, dtype=dtype, device=dev), u_v])
    v = torch.sqrt(G * menc / rr) * (1.0 + (jitter - 0.5) * 2.0 * speed_jitter)
    vel = torch.stack([d[:, 1] / rr * v, -d[:, 0] / rr * v], dim=-1)
    drift = torch.tensor([vx, vy], dtype=dtype, device=dev)
    vel = vel + drift
    vel[0] = drift
    return pos, vel, mass


def two_disk(seed: int, n: int, device, *, world_w=2400.0, world_h=800.0,
             G=80.0, min_r=8.0, dtype=torch.float32):
    """(pos, vel, mass) of the collision at ``n`` bodies: n1 = n - n//5
    in the large disk, n2 = n//5 in the small one."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    n2 = n // 5
    p1, v1, m1 = _disk(gen, n - n2, x=world_w * 0.5, y=world_h * 0.5,
                       r=300.0, min_r=min_r, central_mass=50_000.0,
                       total_satellite_mass=5_000.0, G=G, dtype=dtype)
    p2, v2, m2 = _disk(gen, n2, x=world_w * 0.5, y=world_h * 0.2, r=100.0,
                       min_r=min_r, central_mass=5_000.0,
                       total_satellite_mass=500.0, G=G, vx=-50.0,
                       dtype=dtype)
    return torch.cat([p1, p2]), torch.cat([v1, v2]), torch.cat([m1, m2])
