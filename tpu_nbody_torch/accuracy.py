"""Sampled exact force error of the P3M solver (port of
tools/acc_sampled.py).

A full all-pairs reference costs N² pairs; the relative force error
|a_pm − a_exact| / |a_exact| is measured instead on a random sample of
alive targets against the exact force from every alive source: samples × N
pairs through the all-pairs kernel on the card. The sample estimates the
error distribution of the whole pass to sampling noise ~1/sqrt(samples).

    python -m tpu_nbody_torch.accuracy --n 1000000 --samples 4096
    python -m tpu_nbody_torch.accuracy --device cpu --n 20000 \\
        --samples 256 --level 9 --ny 256

The command line builds the two-disk scene (n1 = 4n/5, n2 = n/5) in a
power-of-two capacity and prints the error's mean, p50, p99 and max.
"""

from __future__ import annotations

import argparse
import time

import torch

from tpu_nbody_torch.config import Params, SimConfig
from tpu_nbody_torch.engine import _pm_knobs, _root
from tpu_nbody_torch.ops import forces
from tpu_nbody_torch.ops import mesh as mesh_lib
from tpu_nbody_torch.state import SimState


def exact_sampled(tpos, pos, mass, G, soft2):
    """Exact softened acceleration at the target rows ``tpos`` from every
    source ``pos`` with masses ``mass`` (dead sources with mass 0)."""
    return forces.accel_allpairs(pos, mass, G, soft2, targets=tpos)


def sampled_force_error(state_or_arrays, cfg: SimConfig, params: Params,
                        samples: int, generator: torch.Generator,
                        **pm_knobs) -> dict:
    """Relative P3M force error over ``samples`` alive bodies.

    ``state_or_arrays`` is a :class:`SimState` or ``(pos, mass, alive)``.
    One fresh ``pm_accel`` pass with ``cfg``'s knobs, any of them
    overridden by ``pm_knobs`` (``order``, ``interlace``, ``heavy_cap``,
    ``rescue_k_hot``, ...), is held against :func:`exact_sampled` on bodies
    drawn without replacement by ``generator`` (on the bodies' device).
    Returns mean, p50, p99 and max of the error, the sample count, and the
    pass's ``rescue_need``, ``rescue_hot`` and ``mesh_oob`` as ints.
    """
    if isinstance(state_or_arrays, SimState):
        st = state_or_arrays
        pos, mass, alive = st.pos, st.mass, st.alive
    else:
        pos, mass, alive = state_or_arrays
    origin, side = _root(cfg)
    knobs = _pm_knobs(cfg)
    knobs.update(pm_knobs)
    acc, st = mesh_lib.pm_accel(pos, mass, alive, params.G, params.soft2,
                                origin, side, return_stats=True, **knobs)
    alive_idx = torch.nonzero(alive).flatten()
    pick = torch.randperm(alive_idx.shape[0], generator=generator,
                          device=alive_idx.device)
    idx = alive_idx[pick[:samples]]
    exact = exact_sampled(pos[idx].contiguous(), pos,
                          torch.where(alive, mass, 0.0), params.G,
                          params.soft2)
    rel = (acc[idx] - exact).norm(dim=1) / (exact.norm(dim=1) + 1e-9)
    q = torch.quantile(rel, torch.tensor([0.5, 0.99], device=rel.device))
    out = dict(mean=float(rel.mean()), p50=float(q[0]), p99=float(q[1]),
               max=float(rel.max()), samples=int(idx.shape[0]))
    out.update({k: int(v) for k, v in st.items()})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--samples", type=int, default=2000)
    ap.add_argument("--level", type=int, default=12)
    ap.add_argument("--ny", type=int, default=2048)
    ap.add_argument("--split", type=float, default=2.5)
    ap.add_argument("--band", type=int, default=128)
    ap.add_argument("--rescue", type=int, default=8)
    ap.add_argument("--order", type=int, default=2)
    ap.add_argument("--interlace", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)

    from tpu_nbody_torch import state as state_lib
    from tpu_nbody_torch.models import scenes

    dev = state_lib.check_device(args.device)
    n = args.n
    cap = 1 << (n - 1).bit_length()
    cfg = SimConfig(capacity=cap, mesh_level=args.level, mesh_ny=args.ny,
                    mesh_split=args.split, mesh_band=args.band,
                    mesh_rescue=args.rescue, mesh_order=args.order,
                    mesh_interlace=args.interlace, mesh_chunk=16384)
    params = Params.default()
    g = torch.Generator(device=dev).manual_seed(args.seed)
    n2 = n // 5
    p, v, m = scenes.default_two_disk_scene(g, n1=n - n2, n2=n2,
                                            dtype=cfg.tdtype)
    st = state_lib.from_arrays(p, v, m, cap, device=dev)
    t0 = time.perf_counter()
    err = sampled_force_error(st, cfg, params, args.samples, g)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"# pm pass + exact reference ({err['samples']} targets x {cap} "
          f"sources) in {time.perf_counter() - t0:.1f}s on {dev}",
          flush=True)
    print(f"# n={n} lvl={args.level} ny={args.ny} split={args.split} "
          f"band={args.band} k={args.rescue} order={args.order} "
          f"interlace={args.interlace} rescue_need={err['rescue_need']}")
    print(f"mean {err['mean']:.2e}  p50 {err['p50']:.2e}  "
          f"p99 {err['p99']:.2e}  max {err['max']:.2e}", flush=True)


if __name__ == "__main__":
    main()
