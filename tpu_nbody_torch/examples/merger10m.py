"""Multi-galaxy merger on a rank group (the JAX package's BASELINE
config[4], ``examples/merger10m.py``).

Four (or ``--galaxies``) galaxy disks fall into a common merger; the state
is domain-decomposed over ``--devices`` ranks and stepped with the sharded
P3M solver (``tpu_nbody_torch/parallel/sharded_pm.py``). With
``--backend thread`` the ranks are threads of this process on one device
(one card, or the CPU); with ``--backend dist`` each process launched by
``torchrun`` is one rank on its own card (NCCL) or the CPU (gloo).

    python -m tpu_nbody_torch.examples.merger10m --devices 4 --n 10000000 --steps 2
    python -m tpu_nbody_torch.examples.merger10m --devices 4 --n 20000 --steps 16 --device cpu
    torchrun --nproc-per-node 4 -m tpu_nbody_torch.examples.merger10m --backend dist

Writes a GIF when --out is given (frames rendered on the device).
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--galaxies", type=int, default=4)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks (0: one for --backend thread, the world "
                         "size for --backend dist)")
    ap.add_argument("--reshard-every", type=int, default=8)
    ap.add_argument("--out", type=str, default="")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    ap.add_argument("--backend", default="thread", choices=["thread", "dist"])
    args = ap.parse_args(argv)

    import torch

    from tpu_nbody_torch.config import Params, SimConfig
    from tpu_nbody_torch.models import scenes
    from tpu_nbody_torch.parallel.engine import ShardedEngine
    from tpu_nbody_torch.parallel.mesh import make_mesh

    mesh = make_mesh(args.devices or None, device=args.device,
                     backend=args.backend)
    lead = mesh.local_ranks[0] == 0        # this process prints and writes
    n_dev = mesh.size
    cap = 1 << (args.n - 1).bit_length()
    small = args.n < 100_000
    cfg = SimConfig(capacity=cap,
                    mesh_level=9 if small else 12,
                    mesh_band=64 if small else 512,
                    mesh_split=4.0 if small else 6.0,
                    mesh_chunk=min(16384, cap // n_dev))
    params = Params.default()
    eng = ShardedEngine(cfg, params, mesh=mesh, solver="pm",
                        reshard_every=args.reshard_every,
                        device=mesh.device)
    g = torch.Generator(device=eng.device).manual_seed(3)
    p, v, m = scenes.multi_galaxy_merger(g, n_total=args.n,
                                         n_galaxies=args.galaxies,
                                         G=params.G)
    eng.set_bodies(p, v, m)
    del p, v, m
    if lead:
        print(f"# devices={n_dev} n={args.n} cap={cap} "
              f"galaxies={args.galaxies} backend={args.backend} "
              f"device={eng.device}", flush=True)

    frames = []
    lines = []
    spf = max(1, args.steps // max(args.frames, 1))
    t0 = time.perf_counter()
    done = 0
    while done < args.steps:
        eng.step(min(spf, args.steps - done))
        done += spf
        stats = eng.stats(potential=False)
        lines.append((done, int(stats["n_alive"]), float(stats["kinetic"])))
        if lead:
            print(f"step {done:5d}  n_alive={lines[-1][1]}  "
                  f"KE={lines[-1][2]:.3e}", flush=True)
        if args.out:
            from tpu_nbody_torch.ops import render
            st = eng.state
            fb = render.render_frame(
                st.pos, st.vel, st.mass, st.alive, width=400, height=300,
                view_x=0.0, view_y=0.0, zoom=400.0 / cfg.world_w,
                mode="speed", speed_scale=1 / 300.0, size_mass_scale=1e-4)
            frames.append(render.to_uint8(fb).cpu().numpy())
    dt = time.perf_counter() - t0
    ups = args.n * args.steps / dt
    if lead:
        print(f"# {dt:.1f}s for {args.steps} steps -> {ups / 1e6:.2f}M "
              f"updates/s", flush=True)
    if args.out and frames and lead:
        from tpu_nbody_torch.viewer import write_gif
        write_gif(args.out, frames, fps=8)
        print(f"wrote {args.out} ({len(frames)} frames)", flush=True)
    mesh.close()        # --backend dist: leave the process group in order
    return dict(seconds=dt, updates_per_s=ups, lines=lines, engine=eng)


if __name__ == "__main__":
    main()
