"""Scene generators, 2D (port of tpu_nbody.models.scenes).

Each generator is a ``*_from_uniforms`` core (deterministic math given
uniform draws, so tests can feed the JAX package and the port the same
numbers) and a thin wrapper that draws the uniforms from a
``torch.Generator``. Body 0 of each disk is the central mass.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu_nbody_torch import config as cfg


def _enclosed_mass(pos, mass, center):
    """Per-body enclosed mass via a stable sort by radius and a cumsum
    (``BodyFactory.kt:43-47,119-123``)."""
    r = torch.linalg.norm(pos - center, dim=-1)
    order = torch.argsort(r, stable=True)
    csum = torch.cumsum(mass[order], dim=0)
    menc = torch.empty_like(csum)
    menc[order] = csum
    return menc, r


def _circularize(pos, mass, center, G, clockwise, speed_jitter_u,
                 drift, radial_jitter_u=None, radial_jitter=0.0,
                 speed_jitter=0.01):
    """Tangential circular-orbit velocities from the enclosed mass
    (``BodyFactory.kt:49-59,126-147``). Row 0 keeps the drift only."""
    menc, r = _enclosed_mass(pos, mass, center)
    d = pos - center
    rr = torch.clamp(torch.linalg.norm(d, dim=-1), min=1e-6)
    v_circ = torch.sqrt(G * menc / rr)
    v = v_circ * (1.0 + (speed_jitter_u - 0.5) * 2.0 * speed_jitter)
    dx, dy = d[:, 0], d[:, 1]
    tx = dy / rr if clockwise else -dy / rr
    ty = -dx / rr if clockwise else dx / rr
    vel = torch.stack([tx * v, ty * v], dim=-1)
    if radial_jitter > 0.0 and radial_jitter_u is not None:
        vr = (radial_jitter_u - 0.5) * 2.0 * radial_jitter * v_circ
        vel = vel + d / rr[:, None] * vr[:, None]
    drift_t = torch.tensor(drift, dtype=pos.dtype, device=pos.device)
    vel = vel + drift_t
    vel[0] = drift_t
    return vel


def _disk_arrays(center, sat_pos, central_mass, total_satellite_mass, u):
    sats = sat_pos.shape[0]
    m_sat = total_satellite_mass / max(sats, 1) if sats > 0 else 0.0
    pos = torch.cat([center[None], sat_pos], dim=0)
    mass = torch.cat([torch.tensor([central_mass], dtype=u.dtype,
                                   device=u.device),
                      torch.full((sats,), m_sat, dtype=u.dtype,
                                 device=u.device)])
    return pos, mass


def _with_centre(u):
    return torch.cat([torch.full((1,), 0.5, dtype=u.dtype, device=u.device),
                      u])


def kepler_disk_from_uniforms(u_r, u_rj, u_ang, u_v, *, x, y, r, min_r,
                              central_mass, total_satellite_mass, G,
                              clockwise=True, radial_jitter=0.03,
                              speed_jitter=0.01, vx=0.0, vy=0.0):
    """Kepler disk given uniform draws in [0, 1): uniform-in-area radii
    with ±3% jitter (``BodyFactory.kt:33-41``)."""
    center = torch.tensor([x, y], dtype=u_r.dtype, device=u_r.device)
    rr = torch.sqrt(u_r * (r * r - min_r * min_r) + min_r * min_r)
    rj = rr * (1.0 + (u_rj - 0.5) * 2.0 * radial_jitter)
    ang = u_ang * 2.0 * math.pi
    sat_pos = center + rj[:, None] * torch.stack(
        [torch.cos(ang), torch.sin(ang)], dim=-1)
    pos, mass = _disk_arrays(center, sat_pos, central_mass,
                             total_satellite_mass, u_r)
    vel = _circularize(pos, mass, center, G, clockwise, _with_centre(u_v),
                       (vx, vy), speed_jitter=speed_jitter)
    return pos, vel, mass


def _uniforms(generator, k, n, dtype):
    return [torch.rand((n,), generator=generator, dtype=dtype,
                       device=generator.device) for _ in range(k)]


def make_kepler_disk(generator, n_total, *, x=None, y=None, r=None,
                     min_r=cfg.MIN_R, central_mass=cfg.CENTRAL_MASS,
                     total_satellite_mass=cfg.TOTAL_SATELLITE_MASS,
                     G=cfg.G_DEFAULT, clockwise=True, radial_jitter=0.03,
                     speed_jitter=0.01, vx=0.0, vy=0.0,
                     world_w=cfg.WIDTH_PX, world_h=cfg.HEIGHT_PX,
                     dtype=torch.float32):
    """Kepler disk: central mass + satellites on circular orbits
    (``BodyFactory.kt:11-22``), drawn on ``generator``'s device."""
    x = world_w * 0.5 if x is None else x
    y = world_h * 0.5 if y is None else y
    r = min(world_w, world_h) * 0.38 if r is None else r
    u = _uniforms(generator, 4, max(n_total - 1, 0), dtype)
    return kepler_disk_from_uniforms(
        u[0], u[1], u[2], u[3], x=x, y=y, r=r, min_r=min_r,
        central_mass=central_mass, total_satellite_mass=total_satellite_mass,
        G=G, clockwise=clockwise, radial_jitter=radial_jitter,
        speed_jitter=speed_jitter, vx=vx, vy=vy)


def galaxy_disk_from_uniforms(u_r, u_ang, u_v, *, x, y, r, min_r,
                              central_mass, total_satellite_mass, G,
                              eps_m2=0.03, phi0=0.0, bar_taper_r=None,
                              radial_scale=None, speed_jitter=0.01,
                              radial_jitter=0.0, u_vr=None, clockwise=True,
                              vx=0.0, vy=0.0):
    """Galaxy disk given uniform draws: exponential profile with scale
    r/3 by inverse CDF on [min_r, r], an m=2 bar perturbation tapered at
    0.6 r, and enclosed-mass circularization (``BodyFactory.kt:97-147``)."""
    center = torch.tensor([x, y], dtype=u_r.dtype, device=u_r.device)
    Rd = (r / 3.0) if radial_scale is None else radial_scale
    taper_r = (r * 0.6) if bar_taper_r is None else bar_taper_r
    A = math.exp(-(r - min_r) / Rd)
    t = 1.0 - u_r * (1.0 - A)
    R = min_r - Rd * torch.log(t)
    theta = u_ang * 2.0 * math.pi
    taper = torch.exp(-(R / taper_r) ** 2)
    R2 = R * (1.0 + eps_m2 * torch.cos(2.0 * (theta - phi0)) * taper)
    sat_pos = center + R2[:, None] * torch.stack(
        [torch.cos(theta), torch.sin(theta)], dim=-1)
    pos, mass = _disk_arrays(center, sat_pos, central_mass,
                             total_satellite_mass, u_r)
    u_vr_all = None if u_vr is None else _with_centre(u_vr)
    vel = _circularize(pos, mass, center, G, clockwise, _with_centre(u_v),
                       (vx, vy), radial_jitter_u=u_vr_all,
                       radial_jitter=radial_jitter, speed_jitter=speed_jitter)
    return pos, vel, mass


def make_galaxy_disk(generator, n_total, *, x=None, y=None, r=200.0,
                     min_r=cfg.MIN_R, central_mass=cfg.CENTRAL_MASS,
                     total_satellite_mass=cfg.TOTAL_SATELLITE_MASS,
                     G=cfg.G_DEFAULT, eps_m2=0.03, phi0=0.0,
                     bar_taper_r=None, radial_scale=None, speed_jitter=0.01,
                     radial_jitter=0.0, clockwise=True, vx=0.0, vy=0.0,
                     world_w=cfg.WIDTH_PX, world_h=cfg.HEIGHT_PX,
                     dtype=torch.float32):
    """Galaxy disk with exponential profile and m=2 bar
    (``BodyFactory.kt:63-82``), drawn on ``generator``'s device."""
    x = world_w * 0.5 if x is None else x
    y = world_h * 0.5 if y is None else y
    u = _uniforms(generator, 4, max(n_total - 1, 0), dtype)
    return galaxy_disk_from_uniforms(
        u[0], u[1], u[2], x=x, y=y, r=r, min_r=min_r,
        central_mass=central_mass, total_satellite_mass=total_satellite_mass,
        G=G, eps_m2=eps_m2, phi0=phi0, bar_taper_r=bar_taper_r,
        radial_scale=radial_scale, speed_jitter=speed_jitter,
        radial_jitter=radial_jitter, u_vr=u[3] if radial_jitter > 0 else None,
        clockwise=clockwise, vx=vx, vy=vy)


def make_uniform_cloud(generator, n, m=0.5, *, world_w=cfg.WIDTH_PX,
                       world_h=cfg.HEIGHT_PX, dtype=torch.float32):
    """Uniform zero-velocity cloud over the window
    (``BodyFactory.kt:160-177``)."""
    u = torch.rand((n, 2), generator=generator, dtype=dtype,
                   device=generator.device)
    pos = u * torch.tensor([world_w, world_h], dtype=dtype, device=u.device)
    return pos, torch.zeros_like(pos), torch.full((n,), m, dtype=dtype,
                                                  device=u.device)


def default_two_disk_scene(generator, *, n1=10_000, n2=2_500,
                           world_w=cfg.WIDTH_PX, world_h=cfg.HEIGHT_PX,
                           G=cfg.G_DEFAULT, dtype=torch.float32):
    """The two-galaxy collision (``NBodyPanel.kt:83-100``): an ``n1``-body
    disk (r=300, M_c=50k, M_sat=5k) centred in the window plus an
    ``n2``-body disk (r=100, M_c=5k, M_sat=500) at y=0.2*H drifting at
    vx=-50."""
    p1, v1, m1 = make_galaxy_disk(
        generator, n1, r=300.0, central_mass=50_000.0,
        total_satellite_mass=5_000.0, world_w=world_w, world_h=world_h, G=G,
        dtype=dtype)
    p2, v2, m2 = make_galaxy_disk(
        generator, n2, y=world_h * 0.2, vx=-50.0, r=100.0,
        central_mass=5_000.0, total_satellite_mass=500.0, world_w=world_w,
        world_h=world_h, G=G, dtype=dtype)
    return torch.cat([p1, p2]), torch.cat([v1, v2]), torch.cat([m1, m2])


def multi_galaxy_merger(generator, *, n_total=10_000_000, n_galaxies=4,
                        world_w=cfg.WIDTH_PX, world_h=cfg.HEIGHT_PX,
                        ring_frac=0.30, infall_speed=40.0,
                        G=cfg.G_DEFAULT, dtype=torch.float32):
    """Several galaxies falling into a common merger: ``n_galaxies`` disks
    (the r=300, M_c=50k profile) on a ring of radius ``ring_frac * min(W,
    H)`` around the world centre, each with an inward and a 25% tangential
    velocity so they meet near the centre within a few hundred steps. No
    reference counterpart: the N-scaling workload. Galaxy 0 takes the
    remainder of ``n_total``."""
    per = n_total // n_galaxies
    cx, cy = world_w * 0.5, world_h * 0.5
    ring_r = ring_frac * min(world_w, world_h)
    ps, vs, ms = [], [], []
    for g in range(n_galaxies):
        ang = 2.0 * math.pi * g / n_galaxies
        # float32 cos and sin, as the JAX package takes them
        cos = float(np.cos(np.float32(ang)))
        sin = float(np.sin(np.float32(ang)))
        n_g = per + (n_total - per * n_galaxies if g == 0 else 0)
        p, v, m = make_galaxy_disk(
            generator, n_g, x=cx + ring_r * cos, y=cy + ring_r * sin,
            r=300.0, central_mass=50_000.0, total_satellite_mass=5_000.0,
            vx=-infall_speed * cos - 0.25 * infall_speed * sin,
            vy=-infall_speed * sin + 0.25 * infall_speed * cos, phi0=ang,
            world_w=world_w, world_h=world_h, G=G, dtype=dtype)
        ps.append(p), vs.append(v), ms.append(m)
    return torch.cat(ps), torch.cat(vs), torch.cat(ms)
