"""Frames in 3D: the GPU demo's closed loop, one frame at a time (the tick
of ``gpu/GPU.kt:657-735``, ``examples/sphere3d_demo.py``):
``Engine.step(steps_per_frame)``, then ``render_frame_3d`` of every alive
body's position times ``world_scale`` (1/8, the GL projection's) at the
traffic's size in speed mode with its ``speed_scale`` and ``gain``, under
the orbiting camera: pitch ``cam_pitch``, the yaw advancing
``yaw_per_frame`` a frame (0.25 rad/s at the demo's 0.016 s frame,
``GPU.kt:680,707``); then ``to_uint8`` and the frame's copy to the host,
which waits for the frame.

The yaw is the engine's step counter over ``steps_per_frame`` times
``yaw_per_frame``, taken on the device, so the loop keeps no state of its
own. A call returns the frame with that yaw, so the check renders the
same view.
"""

from __future__ import annotations


def steps(traffic: dict) -> int:
    return int(traffic["steps_per_frame"])


def call(eng, traffic: dict, probe):
    from tpu_nbody_torch.ops import render

    k = steps(traffic)
    eng.step(k)
    st = eng.state
    yaw = st.step.to(st.pos.dtype) * (traffic["yaw_per_frame"] / k)
    with probe("render"):
        fb = render.render_frame_3d(
            st.pos * traffic["world_scale"], st.vel, st.mass, st.alive,
            width=traffic["width"], height=traffic["height"], cam_angle=yaw,
            cam_pitch=traffic["cam_pitch"],
            speed_scale=traffic["speed_scale"], gain=traffic["gain"])
        img = render.to_uint8(fb)
    return img.cpu(), yaw
