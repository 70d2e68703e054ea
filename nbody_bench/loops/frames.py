"""Frames: the interactive viewer's closed loop, one frame at a time (the
``tick`` of ``examples/interactive.py``): ``Engine.step(steps_per_frame)``,
then ``render_frame`` of every alive body at the traffic's size in
``"speed"`` mode, ``to_uint8`` and the frame's copy to the host, which
waits for the frame."""

from __future__ import annotations


def steps(traffic: dict) -> int:
    return int(traffic["steps_per_frame"])


def call(eng, traffic: dict, probe):
    from tpu_nbody_torch.ops import render

    eng.step(steps(traffic))
    st = eng.state
    with probe("render"):
        fb = render.render_frame(
            st.pos, st.vel, st.mass, st.alive, width=traffic["width"],
            height=traffic["height"], mode="speed",
            speed_scale=traffic["speed_scale"],
            size_mass_scale=traffic["size_mass_scale"])
        img = render.to_uint8(fb)
    return img.cpu()
