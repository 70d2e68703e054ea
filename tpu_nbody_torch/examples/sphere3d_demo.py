"""3D all-pairs demo — the reference GPU program's workload.

Reproduces ``src/main/kotlin/gpu/GPU.kt main()`` (lines 657-735): a 50k-body
3D sphere with tangential velocities + a 5e6-mass central body, integrated
with semi-implicit Euler under exact all-pairs forces (the hand-written
kernel on the card), rendered on the device with the auto-orbiting camera
(yaw advancing 0.25 rad/s, fixed 15 deg pitch) and the speed color ramp,
written as an animated GIF. Only the finished uint8 frames cross to the
host, once, after the last step.

    python -m tpu_nbody_torch.examples.sphere3d_demo --out sphere.gif --n 50000
"""

from __future__ import annotations

import argparse
import contextlib
import time


def simulate(n, frames, steps_per_frame, width, height, device="cuda",
             timer=None, bodies=None):
    """Run the demo on ``device``; returns (engine, frames) with the
    frames a (frames, height, width, 3) uint8 tensor on the device.
    ``timer`` (a :class:`tpu_nbody_torch.profiling.PhaseTimer`) times the
    scene, step and render phases, synchronising after each. ``bodies``,
    (pos, vel, mass) arrays of n + 1 bodies, replaces the sphere scene
    drawn from the engine's generator."""
    import torch

    from tpu_nbody_torch.config import Params, SimConfig
    from tpu_nbody_torch.engine import Engine
    from tpu_nbody_torch.models import scenes3d
    from tpu_nbody_torch.ops import render

    def phase(name):
        return contextlib.nullcontext({}) if timer is None else timer(name)

    # GPU demo physics: G=80, dt=0.005, softening 1 (GPU.kt:36-41), no merge.
    eng = Engine(SimConfig(capacity=n + 1, dim=3),
                 Params.default(merge_min_dist=0.0), solver="allpairs",
                 integrator="euler", seed=1, device=device)
    with phase("scene") as h:
        eng.set_bodies(*(bodies if bodies is not None else
                         scenes3d.generate_sphere(eng.generator, n)))
        h["result"] = eng.state
    out = torch.empty((frames, height, width, 3), dtype=torch.uint8,
                      device=eng.device)
    cam_angle = 0.0
    t0 = time.perf_counter()
    for i in range(frames):
        with phase("step") as h:
            h["result"] = eng.step(steps_per_frame)
        cam_angle += 0.25 * 0.016  # GPU.kt:680,707 at ~60 FPS frame time
        # world scaled into the viewport like the GL projection (GPU.kt:222)
        with phase("render") as h:
            st = eng.state
            out[i] = render.to_uint8(render.render_frame_3d(
                st.pos / 8.0, st.vel, st.mass, st.alive, width=width,
                height=height, cam_angle=cam_angle,
                speed_scale=1.0 / 10_000.0, gain=0.6))
            h["result"] = out
        if (i + 1) % 15 == 0:
            print(f"frame {i + 1}/{frames}  "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
    return eng, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="sphere.gif")
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--steps-per-frame", type=int, default=1)
    ap.add_argument("--width", type=int, default=430)
    ap.add_argument("--height", type=int, default=180)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card) or 'cpu'")
    args = ap.parse_args(argv)

    from tpu_nbody_torch import viewer

    _, frames = simulate(args.n, args.frames, args.steps_per_frame,
                         args.width, args.height, device=args.device)
    viewer.write_gif(args.out, list(frames.cpu().numpy()), fps=25)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
