"""Two-disk galaxy collision demo -> animated GIF.

Recreates the reference's collide.gif demo (README.md:3): the default
R-reset scene (a 10k-body disk + 2.5k-body drifting disk) run under the
Barnes-Hut solver with per-frame on-device point-splat rendering. Only the
rendered frames cross to the host.

    python -m tpu_nbody_torch.examples.collide_demo --out collide.gif --frames 120
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="collide.gif")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--steps-per-frame", type=int, default=8)
    ap.add_argument("--n1", type=int, default=10_000)
    ap.add_argument("--n2", type=int, default=2_500)
    ap.add_argument("--width", type=int, default=600)
    ap.add_argument("--height", type=int, default=200)
    ap.add_argument("--mode", default="speed", choices=["speed", "classic"])
    ap.add_argument("--speed-scale", type=float, default=1.0 / 300.0)
    ap.add_argument("--fused", action="store_true",
                    help="step and render the whole movie on the device "
                         "through render_movie (no per-frame host round "
                         "trips, no cap retune)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card) or 'cpu'")
    args = ap.parse_args(argv)

    from tpu_nbody_torch import viewer
    from tpu_nbody_torch.config import SimConfig
    from tpu_nbody_torch.engine import Engine, make_step_fn
    from tpu_nbody_torch.ops import render

    cap = 1 << (args.n1 + args.n2 - 1).bit_length()
    cfg = SimConfig(capacity=cap, max_depth=12, group_chunk=16,
                    approx_cap=1024, direct_body_cap=2048,
                    frontier_cap=1024, leaf_list_cap=512)
    eng = Engine(cfg, solver="bh", integrator="kdk_reuse",
                 device=args.device)
    eng.reset_default_scene(n1=args.n1, n2=args.n2)

    zoom = args.width / cfg.world_w
    view = dict(width=args.width, height=args.height, zoom=zoom,
                view_y=-(args.height / zoom - cfg.world_h) / 2,
                mode=args.mode, speed_scale=args.speed_scale)

    if args.fused:
        # Fused path: steps + on-device splats in one loop of device work;
        # only the final uint8 frame stack crosses to the host.
        step_once = make_step_fn(cfg, eng.caps, "bh", "kdk", False, 64,
                                 device=eng.device)

        def step_fn(state, params):
            return step_once(state, params, n_steps=1)[0]

        t0 = time.perf_counter()
        eng.state, frames_dev = render.render_movie(
            eng.state, eng.params, step_fn, n_frames=args.frames,
            steps_per_frame=args.steps_per_frame, **view)
        frames = list(frames_dev.cpu().numpy())
        print(f"fused loop: {len(frames)} frames in "
              f"{time.perf_counter() - t0:.1f}s")
        viewer.write_gif(args.out, frames, fps=25)
        print(f"wrote {args.out}")
        return args.out

    frames = []
    t0 = time.perf_counter()
    for i in range(args.frames):
        eng.step(args.steps_per_frame)
        fb = render.render_frame(
            eng.state.pos, eng.state.vel, eng.state.mass, eng.state.alive,
            **view)
        frames.append(render.to_uint8(fb).cpu().numpy())
        if (i + 1) % 20 == 0:
            el = time.perf_counter() - t0
            print(f"frame {i + 1}/{args.frames}  n={int(eng.state.n_alive())}"
                  f"  {el:.1f}s")
    viewer.write_gif(args.out, frames, fps=25)
    print(f"wrote {args.out} ({len(frames)} frames)")
    return args.out


if __name__ == "__main__":
    main()
