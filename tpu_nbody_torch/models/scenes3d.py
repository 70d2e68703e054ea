"""Scene generators, 3D, for the all-pairs demo path (port of
tpu_nbody.models.scenes3d).

The reference GPU program's scene math (``src/main/kotlin/gpu/GPU.kt``):

* :func:`generate_sphere` — ``generateSphere`` (lines 508-548): bodies in a
  ball (r ~ rMax * cbrt(u)), tangential speeds 300000/max(10, r) via a
  cross-product frame, plus one central body of mass 5e6 as the last body.
* :func:`generate_disk3d` — ``generateDisk`` (lines 479-498): 2D disk with
  z in [1, 11), tangential speed 50/max(10, r), mass in [1, 3).
* :func:`make_galaxy_disk3d` — the 3D float clone of makeGalaxyDisk
  (lines 575-652), z = 0 plane.

As in :mod:`tpu_nbody_torch.models.scenes`, each generator is a
``*_from_uniforms`` core that takes the uniform draws as tensors and a thin
wrapper that draws them from a ``torch.Generator`` on its device.
"""

from __future__ import annotations

import math

import torch

from tpu_nbody_torch import config as cfg
from tpu_nbody_torch.models import scenes as scenes2d


def sphere_from_uniforms(u_r, u_z, u_phi, *, w=cfg.GPU_WIDTH_PX,
                         h=cfg.GPU_HEIGHT_PX, central_mass=5_000_000.0,
                         speed_const=300_000.0):
    """Ball of satellites + one central mass given uniform draws in [0, 1).

    torch has no ``cbrt``: ``pow(u, 1/3)`` differs from the JAX package's
    cube root in the last bits, and every position and speed inherits that
    relative difference."""
    dt, dev = u_r.dtype, u_r.device
    n = u_r.shape[0]
    c = torch.tensor([w * 0.5, h * 0.5, min(w, h) * 0.5], dtype=dt,
                     device=dev)
    r_max = min(w, h) * 0.45
    r = r_max * torch.pow(u_r, 1.0 / 3.0)
    z = u_z * 2.0 - 1.0
    phi = u_phi * 2.0 * math.pi
    s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    rdir = torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], dim=-1)
    pos = c + r[:, None] * rdir
    speed = speed_const / torch.clamp(r, min=10.0)
    # Tangential direction: cross(rdir, axis) with the axis flipped near
    # the poles (GPU.kt:536-540).
    near_pole = torch.abs(z) > 0.99
    one, zero = torch.ones_like(z), torch.zeros_like(z)
    axis = torch.stack([torch.where(near_pole, one, zero),
                        torch.where(near_pole, zero, one), zero], dim=-1)
    t = torch.linalg.cross(rdir, axis)
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-8)
    vel = t * speed[:, None]
    pos = torch.cat([pos, c[None]])
    vel = torch.cat([vel, torch.zeros((1, 3), dtype=dt, device=dev)])
    mass = torch.cat([torch.ones((n,), dtype=dt, device=dev),
                      torch.tensor([central_mass], dtype=dt, device=dev)])
    return pos, vel, mass


def generate_sphere(generator, n, *, w=cfg.GPU_WIDTH_PX, h=cfg.GPU_HEIGHT_PX,
                    central_mass=5_000_000.0, speed_const=300_000.0,
                    dtype=torch.float32):
    """Ball of ``n`` satellites + one central mass (the GPU demo's default
    scene), drawn on ``generator``'s device."""
    u = scenes2d._uniforms(generator, 3, n, dtype)
    return sphere_from_uniforms(*u, w=w, h=h, central_mass=central_mass,
                                speed_const=speed_const)


def disk3d_from_uniforms(u_r, u_a, u_z, u_m, *, w=cfg.GPU_WIDTH_PX,
                         h=cfg.GPU_HEIGHT_PX):
    """Thin 3D disk given uniform draws: r ~ rMax*sqrt(u), z in [1, 11),
    m in [1, 3)."""
    c = torch.tensor([w * 0.5, h * 0.5], dtype=u_r.dtype, device=u_r.device)
    r_max = min(w, h) * 0.45
    r = r_max * torch.sqrt(u_r)
    a = u_a * 2.0 * math.pi
    z = 1.0 + u_z * 10.0
    xy = c + r[:, None] * torch.stack([torch.cos(a), torch.sin(a)], dim=-1)
    pos = torch.cat([xy, z[:, None]], dim=-1)
    v = 50.0 / torch.clamp(r, min=10.0)
    vel = torch.stack([-v * torch.sin(a), v * torch.cos(a),
                       torch.zeros_like(v)], dim=-1)
    mass = 1.0 + u_m * 2.0
    return pos, vel, mass


def generate_disk3d(generator, n, *, w=cfg.GPU_WIDTH_PX, h=cfg.GPU_HEIGHT_PX,
                    dtype=torch.float32):
    """Thin 3D disk of ``n`` bodies, drawn on ``generator``'s device."""
    u = scenes2d._uniforms(generator, 4, n, dtype)
    return disk3d_from_uniforms(*u, w=w, h=h)


def _lift(pos2, vel2, mass):
    z = torch.zeros((pos2.shape[0], 1), dtype=pos2.dtype, device=pos2.device)
    return torch.cat([pos2, z], dim=-1), torch.cat([vel2, z], dim=-1), mass


def galaxy_disk3d_from_uniforms(u_r, u_ang, u_v, *, x=None, y=None, r=200.0,
                                min_r=cfg.GPU_MIN_R,
                                central_mass=cfg.GPU_CENTRAL_MASS,
                                total_satellite_mass=(
                                    cfg.GPU_TOTAL_SATELLITE_MASS),
                                G=cfg.G_DEFAULT, w=cfg.GPU_WIDTH_PX,
                                h=cfg.GPU_HEIGHT_PX, **kw):
    """The 2D galaxy disk of :func:`scenes.galaxy_disk_from_uniforms` with
    the GPU demo's defaults, lifted into the z = 0 plane."""
    x = w * 0.5 if x is None else x
    y = h * 0.5 if y is None else y
    return _lift(*scenes2d.galaxy_disk_from_uniforms(
        u_r, u_ang, u_v, x=x, y=y, r=r, min_r=min_r,
        central_mass=central_mass,
        total_satellite_mass=total_satellite_mass, G=G, **kw))


def make_galaxy_disk3d(generator, n_total, *, x=None, y=None, r=200.0,
                       min_r=cfg.GPU_MIN_R, central_mass=cfg.GPU_CENTRAL_MASS,
                       total_satellite_mass=cfg.GPU_TOTAL_SATELLITE_MASS,
                       G=cfg.G_DEFAULT, w=cfg.GPU_WIDTH_PX,
                       h=cfg.GPU_HEIGHT_PX, dtype=torch.float32, **kw):
    """3D (z = 0 plane) galaxy disk, the GPU demo's unused generator, drawn
    on ``generator``'s device."""
    x = w * 0.5 if x is None else x
    y = h * 0.5 if y is None else y
    return _lift(*scenes2d.make_galaxy_disk(
        generator, n_total, x=x, y=y, r=r, min_r=min_r,
        central_mass=central_mass,
        total_satellite_mass=total_satellite_mass, G=G, world_w=w, world_h=h,
        dtype=dtype, **kw))
