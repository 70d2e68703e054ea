"""The point splat of a frame (the viewer's "speed" mode).

A body at world (x, y) lights pixel (floor((x − view_x)·zoom),
floor((y − view_y)·zoom)) of a (height, width) RGB frame. Its colour
ramps with its speed s: t = 5·clamp(s·speed_scale, 0, 1), white → cyan
by smoothstep(0, 0.5, t), → purple by smoothstep(0.5, 1, t), each mixed
toward white with weight 0.77. Its point size is clamp(1 + size_mass_scale
· m, 1, 5): size ≥ 2.5 adds the eight pixels around it, ≥ 4.5 the twelve
of the 5 × 5 disc's outer ring (corners left out). Colours add and the
sum is clipped to [0, 1], then scaled to 0-255 and rounded half up.
"""

from __future__ import annotations

import torch

_RING1 = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
          if (dx, dy) != (0, 0)]
_RING2 = [(dx, dy) for dx in range(-2, 3) for dy in range(-2, 3)
          if max(abs(dx), abs(dy)) == 2 and abs(dx) * abs(dy) != 4]


def _smooth(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def frame(pos, vel, mass, alive, *, width: int, height: int,
          speed_scale: float, size_mass_scale: float, view_x=0.0,
          view_y=0.0, zoom=1.0, dtype=torch.float64):
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
    col = (white * (1 - s1) + mid * s1) * (1 - s2) + fast * s2
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
