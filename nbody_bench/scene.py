"""The scenes of the configurations, made on the device from the run's
seed; a configuration names its scene by the key ``scene`` (absent:
``two_disk``), and :func:`make` builds it.

``two_disk``: the two-disk collision, a frozen copy of the program's
generator (``NBodyPanel.kt:83-100``, ``BodyFactory.kt:63-147``), so that
the inputs cannot move with the program: an n1-body galaxy disk (r = 300, central mass 50,000, satellites
5,000 in all) centred in the 2400 x 800 window, and an n2-body disk
(r = 100, 5,000 and 500) at y = 0.2 H drifting at vx = -50. Each disk is
an exponential profile of scale r/3 by inverse CDF on [min_r, r] with an
m = 2 bar tapered at 0.6 r, on circular orbits from the enclosed mass
with 1% speed jitter; body 0 of each disk is its central mass. Eight
``torch.rand`` calls on a ``torch.Generator`` on the device make every
number; the same seed gives the same bodies, and every seed the same
counts.

``sphere3d``: the GPU demo's ball (``gpu/GPU.kt:508-548, 657-735``), a
frozen copy of the program's ``models/scenes3d.sphere_from_uniforms``:
n − 1 satellites of mass 1 in a ball of radius 0.45 min(W, H) (r = r_max
cbrt(u)) centred in the W × H × min(W, H) box (3440 × 1440 × 1440), each
at the tangential speed 3e5 / max(10, r) along cross(r̂, axis), the axis
ŷ or, within 0.99 of a pole, x̂; and last the central body of mass 5e6 at
rest at the centre. One ``torch.rand`` call of (3, n − 1) on a
``torch.Generator`` on the device makes every number; every seed gives the
same counts and masses.
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


def sphere3d(seed: int, n: int, device, *, w=3440.0, h=1440.0,
             central_mass=5_000_000.0, speed_const=300_000.0,
             dtype=torch.float32):
    """(pos, vel, mass) of the ball at ``n`` bodies, (n, 3) each: n − 1
    satellites and the central body last."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    u_r, u_z, u_phi = torch.rand((3, n - 1), generator=gen, dtype=dtype,
                                 device=gen.device)
    dev = gen.device
    c = torch.tensor([w * 0.5, h * 0.5, min(w, h) * 0.5], dtype=dtype,
                     device=dev)
    r = min(w, h) * 0.45 * torch.pow(u_r, 1.0 / 3.0)
    z = u_z * 2.0 - 1.0
    phi = u_phi * 2.0 * math.pi
    s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    rdir = torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], dim=-1)
    pole = (torch.abs(z) > 0.99).to(dtype)
    axis = torch.stack([pole, 1.0 - pole, torch.zeros_like(z)], dim=-1)
    t = torch.linalg.cross(rdir, axis)
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-8)
    vel = t * (speed_const / torch.clamp(r, min=10.0))[:, None]
    pos = torch.cat([c + r[:, None] * rdir, c[None]])
    vel = torch.cat([vel, torch.zeros((1, 3), dtype=dtype, device=dev)])
    mass = torch.cat([torch.ones((n - 1,), dtype=dtype, device=dev),
                      torch.tensor([central_mass], dtype=dtype, device=dev)])
    return pos, vel, mass


def make(config: dict, seed: int, device):
    """(pos, vel, mass) of the configuration's scene at its ``n_bodies``."""
    name = config.get("scene", "two_disk")
    n = config["n_bodies"]
    if name == "two_disk":
        return two_disk(seed, n, device, world_w=config["world_w"],
                        world_h=config["world_h"], G=config["params"]["G"])
    if name == "sphere3d":
        return sphere3d(seed, n, device, w=config["world_w"],
                        h=config["world_h"])
    raise ValueError(f"unknown scene {name!r}: two_disk or sphere3d")
