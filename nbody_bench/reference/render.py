"""The point splat of a frame (the viewer's "speed" mode), and the GPU
demo's 3D camera in front of it.

A body at world (x, y) lights pixel (floor((x − view_x)·zoom),
floor((y − view_y)·zoom)) of a (height, width) RGB frame. Its colour
ramps with its speed s: t = 5·clamp(s·speed_scale, 0, 1), white → cyan
by smoothstep(0, 0.5, t), → purple by smoothstep(0.5, 1, t), each mixed
toward white with weight 0.77. Its point size is clamp(1 + size_mass_scale
· m, 1, 5): size ≥ 2.5 adds the eight pixels around it, ≥ 4.5 the twelve
of the 5 × 5 disc's outer ring (corners left out). Each colour is scaled
by ``gain``; colours add and the sum is clipped to [0, 1], then scaled to
0-255 and rounded half up.

In 3D (:func:`frame3d`, ``gpu/GPU.kt:200-230``) a body's position, scaled
by ``world_scale``, is taken about the alive bodies' centre of mass,
turned by the yaw ``cam_angle`` about the vertical axis, then by the
pitch ``cam_pitch``; its screen point is (x + W/2, H/2 − y) of the turned
position, splatted as above.
"""

from __future__ import annotations

import math

import torch

_RING1 = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
          if (dx, dy) != (0, 0)]
_RING2 = [(dx, dy) for dx in range(-2, 3) for dy in range(-2, 3)
          if max(abs(dx), abs(dy)) == 2 and abs(dx) * abs(dy) != 4]


def _smooth(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def frame(pos, vel, mass, alive, *, width: int, height: int,
          speed_scale: float, size_mass_scale: float = 0.0, gain=1.0,
          view_x=0.0, view_y=0.0, zoom=1.0, dtype=torch.float64):
    """(height, width, 3) uint8 frame of the alive bodies."""
    p, v, m = pos.to(dtype), vel.to(dtype), mass.to(dtype)
    dev = p.device
    t = torch.clamp(torch.linalg.norm(v, dim=1) * speed_scale, 0.0, 1.0) * 5
    white = torch.ones(3, dtype=dtype, device=dev)
    cyan = torch.tensor([0.0, 1.0, 1.0], dtype=dtype, device=dev)
    purple = torch.tensor([0.65, 0.0, 0.95], dtype=dtype, device=dev)
    mid = 0.77 * white + 0.23 * cyan
    fast = 0.77 * white + 0.23 * purple
    s1 = _smooth(0.0, 0.5, t)[:, None]
    s2 = _smooth(0.5, 1.0, t)[:, None]
    col = ((white * (1 - s1) + mid * s1) * (1 - s2) + fast * s2) * gain
    ix = torch.floor((p[:, 0] - view_x) * zoom)
    iy = torch.floor((p[:, 1] - view_y) * zoom)
    size = torch.clamp(1.0 + size_mass_scale * m, 1.0, 5.0)
    fb = torch.zeros((height * width + 1, 3), dtype=dtype, device=dev)

    def splat(dx, dy, sel):
        jx, jy = ix + dx, iy + dy
        on = sel & (jx >= 0) & (jx < width) & (jy >= 0) & (jy < height)
        lin = torch.where(on, jy * width + jx, height * width)
        fb.index_add_(0, lin.to(torch.int64), col * on[:, None].to(dtype))

    splat(0, 0, alive)
    for ring, least in ((_RING1, 2.5), (_RING2, 4.5)):
        for dx, dy in ring:
            splat(dx, dy, alive & (size >= least))
    img = torch.clamp(fb[:-1], 0.0, 1.0).reshape(height, width, 3)
    return torch.floor(img * 255.0 + 0.5).to(torch.uint8)


def frame3d(pos, vel, mass, alive, *, cam_angle: float, cam_pitch: float,
            world_scale: float, width: int, height: int, dtype=torch.float64,
            **splat):
    """(height, width, 3) uint8 frame of the alive 3D bodies under the
    camera; ``splat`` goes to :func:`frame`."""
    p, m = pos.to(dtype) * world_scale, mass.to(dtype)
    live = torch.where(alive, m, 0.0)
    q = p - (live[:, None] * p).sum(dim=0) / live.sum()
    ca, sa = math.cos(cam_angle), math.sin(cam_angle)
    cp, sp = math.cos(cam_pitch), math.sin(cam_pitch)
    x = ca * q[:, 0] + sa * q[:, 2]
    z = -sa * q[:, 0] + ca * q[:, 2]
    y = cp * q[:, 1] - sp * z
    screen = torch.stack([x + 0.5 * width, 0.5 * height - y], dim=-1)
    return frame(screen, vel, mass, alive, width=width, height=height,
                 dtype=dtype, **splat)
