"""On-device point-splat rendering (port of tpu_nbody.ops.render).

Both reference render paths become a scatter-add into an RGB framebuffer
on the bodies' device; only the final image crosses to the host (the
reference GPU demo reads back ALL per-body data every frame,
``src/main/kotlin/gpu/GPU.kt:390-411``). Plain torch: the JAX package has
no kernel here either, and its ``.at[].add`` is ``index_add_``.

Color modes:

* ``"classic"`` — the Swing panel's scheme (``NBodyPanel.kt:302-307``):
  1px points, white for m < 1000, black for m >= 1000, on black background.
* ``"speed"`` — the GPU fragment shader's speed ramp
  (``gpu/GPU.kt:241-257``): t = clamp(|v| * speed_scale, 0, 1) * 5, colors
  mixed toward white with W = 0.77: white -> cyan (smoothstep 0..0.5) ->
  purple (smoothstep 0.5..1). Default speed_scale = 1/10000
  (``gpu/GPU.kt:454``).

The world->screen transform matches the panel viewport
(``NBodyPanel.kt:68-73``): screen = (world - view) * zoom. Splats accumulate
additively and saturate, which reads like the reference's overdrawn points.
On a card the adds are atomic, so a pixel's float sum depends on their
order: two renders of the same bodies agree to rounding, not to the bit.
"""

from __future__ import annotations

import torch

# 5x5 circular sprite tiers (gpu/GPU.kt:226 point size + :242-243 round
# sprite discard): ring 1 completes a 3x3 disc for point size >= 3, ring 2
# the 21-pixel 5x5 disc (corners discarded) for size >= 5.
_RING1 = tuple((dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
               if (dx, dy) != (0, 0))
_RING2 = tuple((dx, dy) for dx in (-2, -1, 0, 1, 2) for dy in (-2, -1, 0, 1, 2)
               if max(abs(dx), abs(dy)) == 2 and abs(dx) * abs(dy) != 4)
_REACH = 2      # the farthest sprite offset


def _smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def speed_colors(vel, speed_scale=1.0 / 10_000.0):
    """Per-body RGB from the GPU shader's white->cyan->purple ramp."""
    def rgb(*c):
        return torch.tensor(c, dtype=vel.dtype, device=vel.device)

    sp = torch.linalg.norm(vel, dim=-1)
    t = torch.clamp(sp * speed_scale, 0.0, 1.0) * 5.0
    W = 0.77
    white = rgb(1.0, 1.0, 1.0)
    mid = white * W + rgb(0.0, 1.0, 1.0) * (1.0 - W)
    fast = white * W + rgb(0.65, 0.0, 0.95) * (1.0 - W)
    s1 = _smoothstep(0.0, 0.5, t)[:, None]
    s2 = _smoothstep(0.5, 1.0, t)[:, None]
    return (white * (1 - s1) + mid * s1) * (1 - s2) + fast * s2


def classic_colors(mass):
    """Swing panel scheme: white below mass 1000, black at/above."""
    light = (mass < 1000.0)[:, None]
    return light.to(mass.dtype).expand(-1, 3)


def _pixel(s, size: int):
    """floor(s) as int64, for any float ``s``. A float -> int cast of a
    non-finite or far-off value is undefined on a card, so the floor is
    first clamped to [-1 - _REACH, size + _REACH]: whatever lies outside is
    off screen for every sprite offset, before and after the clamp. NaN
    goes to the low end."""
    f = torch.nan_to_num(torch.floor(s), nan=-1.0 - _REACH)
    return torch.clamp(f, -1.0 - _REACH, float(size + _REACH)).to(torch.int64)


def _splat_sum(pos, vel, mass, alive, *, width, height, view_x, view_y, zoom,
               mode, speed_scale, gain, size_base, size_mass_scale):
    """The (height, width, 3) additive splat before the final clip."""
    ix = _pixel((pos[:, 0] - view_x) * zoom, width)
    iy = _pixel((pos[:, 1] - view_y) * zoom, height)

    if mode == "speed":
        col = speed_colors(vel, speed_scale)
    elif mode == "classic":
        col = classic_colors(mass)
    else:
        raise ValueError(f"unknown color mode {mode!r}")
    col = col * gain

    # one extra row takes every body that is off screen or not selected
    fb = torch.zeros((width * height + 1, 3), dtype=col.dtype,
                     device=col.device)

    def splat(dx, dy, sel):
        jx, jy = ix + dx, iy + dy
        on = sel & (jx >= 0) & (jx < width) & (jy >= 0) & (jy < height)
        lin = torch.where(on, jy * width + jx, width * height)
        fb.index_add_(0, lin, col * on[:, None].to(col.dtype))

    splat(0, 0, alive)
    if size_mass_scale:
        size = torch.clamp(size_base + size_mass_scale * mass, 1.0, 5.0)
        for ring, least in ((_RING1, 2.5), (_RING2, 4.5)):
            sel = alive & (size >= least)
            for dx, dy in ring:
                splat(dx, dy, sel)
    return fb[:-1].reshape(height, width, 3)


def render_frame(pos, vel, mass, alive, *, width: int, height: int,
                 view_x=0.0, view_y=0.0, zoom=1.0, mode: str = "speed",
                 speed_scale=1.0 / 10_000.0, gain=1.0,
                 size_base: float = 1.0, size_mass_scale: float = 0.0):
    """Splat bodies into an (height, width, 3) float [0,1] framebuffer on
    the bodies' device (``pos[:, :2]`` are the world coordinates).

    With ``size_mass_scale`` > 0, per-body point size =
    clamp(size_base + size_mass_scale * mass, 1, 5) — the GPU vertex
    shader's mass-scaled ``gl_PointSize`` (``gpu/GPU.kt:226``) — and heavy
    bodies splat as circular 3x3 / 5x5 sprites (the fragment shader's round
    discard, ``gpu/GPU.kt:242-243``). 0 (default) keeps the 1-pixel splat
    and its single-scatter cost. A body at a non-finite coordinate is off
    screen.
    """
    return torch.clamp(_splat_sum(
        pos, vel, mass, alive, width=width, height=height, view_x=view_x,
        view_y=view_y, zoom=zoom, mode=mode, speed_scale=speed_scale,
        gain=gain, size_base=size_base, size_mass_scale=size_mass_scale),
        0.0, 1.0)


def _project_3d(pos, mass, alive, *, width: int, height: int, cam_angle=0.0,
                cam_pitch=0.2617994, center=None):
    """Screen coordinates (n, 2) of 3D bodies under the GPU-demo camera:
    translate to ``center`` (default: the alive bodies' centre of mass),
    yaw by ``cam_angle``, pitch by ``cam_pitch`` (15 degrees), project
    (``gpu/GPU.kt:200-230``). The angles may be Python floats or tensors;
    their sines are taken in the bodies' dtype on their device."""
    def scalar(x):
        return torch.as_tensor(x, dtype=pos.dtype, device=pos.device)

    if center is None:
        live = torch.where(alive, mass, 0.0)
        center = torch.sum(live[:, None] * pos, dim=0) / torch.clamp(
            torch.sum(live), min=1e-30)
    q = pos - scalar(center)
    ca, sa = torch.cos(scalar(cam_angle)), torch.sin(scalar(cam_angle))
    rx = ca * q[:, 0] + sa * q[:, 2]
    ry = q[:, 1]
    rz = -sa * q[:, 0] + ca * q[:, 2]
    cp, sp = torch.cos(scalar(cam_pitch)), torch.sin(scalar(cam_pitch))
    py = cp * ry - sp * rz
    # NDC -> pixels
    sx = (rx / (width * 0.5) + 1.0) * 0.5 * width
    sy = (-py / (height * 0.5) + 1.0) * 0.5 * height
    return torch.stack([sx, sy], dim=-1)


def render_frame_3d(pos, vel, mass, alive, *, width: int, height: int,
                    cam_angle=0.0, cam_pitch=0.2617994, center=None,
                    speed_scale=1.0 / 10_000.0, gain=1.0):
    """:func:`render_frame` in ``"speed"`` mode under the GPU-demo camera
    of :func:`_project_3d`: screen x = pr.x / (W/2), y = -pr.y / (H/2),
    here mapped to pixels."""
    pos2 = _project_3d(pos, mass, alive, width=width, height=height,
                       cam_angle=cam_angle, cam_pitch=cam_pitch,
                       center=center)
    return render_frame(pos2, vel, mass, alive, width=width, height=height,
                        mode="speed", speed_scale=speed_scale, gain=gain)


def to_uint8(fb):
    return (torch.clamp(fb, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def render_movie(state, params, step_fn, *, n_frames: int,
                 steps_per_frame: int, width: int, height: int,
                 view_x=0.0, view_y=0.0, zoom=1.0, mode: str = "speed",
                 speed_scale=1.0 / 10_000.0, gain=1.0):
    """Simulate and render a whole movie on the state's device.

    ``step_fn(state, params) -> state`` advances one step. The JAX package
    fuses this into one jitted scan; here it is a loop of eager device work
    that writes each uint8 frame into one preallocated tensor and reads
    nothing back, so the host only enqueues (as long as ``step_fn`` itself
    does not sync). Returns (final_state, frames (n_frames, height, width,
    3) uint8 on the device).
    """
    frames = torch.empty((n_frames, height, width, 3), dtype=torch.uint8,
                         device=state.pos.device)
    for i in range(n_frames):
        for _ in range(steps_per_frame):
            state = step_fn(state, params)
        frames[i] = to_uint8(render_frame(
            state.pos, state.vel, state.mass, state.alive, width=width,
            height=height, view_x=view_x, view_y=view_y, zoom=zoom, mode=mode,
            speed_scale=speed_scale, gain=gain))
    return state, frames
