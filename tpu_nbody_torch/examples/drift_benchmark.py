"""Energy-drift harness: the accuracy metric of BASELINE.json.

Runs the two-disk collision for many steps with merging disabled (the merge
rule deliberately destroys momentum/energy, BarnesHutAlg.kt:518-519) and
reports relative energy and angular-momentum drift. The reference has no
energy diagnostics at all; its drift is whatever KDK leapfrog at dt=0.005
produces — this harness measures exactly that quantity for each solver so
they can be compared like-for-like.

At the reference's default dt=0.005 the scene's inner orbits (r ~ MIN_R =
8 px around the 50k-mass center) have omega*dt ~ 0.4 and are under-resolved
by the reference configuration itself: a float64 NumPy transliteration of
the reference math drifts by several times |E0| within 2000 steps, and so
does every solver here. Angular momentum, which leapfrog does conserve,
drifts only ~3e-3 over 10k steps. For actually-conserved energy, lower dt
(drift scales ~dt^2): dt=1e-4 brings the exact solver under 1e-3.

    python -m tpu_nbody_torch.examples.drift_benchmark --solver bh --n 5000 --steps 10000
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", default="bh", choices=["bh", "pm", "allpairs"])
    ap.add_argument("--n", type=int, default=5_000)
    ap.add_argument("--steps", type=int, default=10_000)
    ap.add_argument("--report-every", type=int, default=1_000)
    ap.add_argument("--theta", type=float, default=0.5)
    ap.add_argument("--dt", type=float, default=None,
                    help="override Params.dt (reference default 0.005); "
                         "dt=5e-4 resolves the default scene's inner "
                         "orbits and makes drift<=1e-3 reachable")
    ap.add_argument("--mesh-split", type=float, default=None,
                    help="pm only: short/long-range split radius in cell "
                         "units (SimConfig.mesh_split); larger hands more "
                         "of each pair force to the exactly-central "
                         "short-range sum — tighter E/Lz conservation")
    ap.add_argument("--mesh-rescue-k", type=int, default=None,
                    help="pm only: rescue partner blocks per band block")
    ap.add_argument("--mesh-level", type=int, default=None,
                    help="pm only: world grid = 2^level per side "
                         "(SimConfig.mesh_level; default 11 here)")
    ap.add_argument("--mesh-band", type=int, default=None,
                    help="pm only: sorted-order band block size")
    ap.add_argument("--mesh-every", type=int, default=None,
                    help="pm only: F_long subcycling interval "
                         "(SimConfig.pm_mesh_every; requires --heavy-cap)")
    ap.add_argument("--heavy-cap", type=int, default=None,
                    help="pm only: heaviest bodies excluded from the mesh "
                         "and summed directly (SimConfig.pm_heavy_cap)")
    ap.add_argument("--integrator", default="kdk",
                    choices=["kdk", "kdk_reuse"],
                    help="with merging disabled (as here) kdk_reuse is "
                         "trajectory-identical to the literal 2-pass kdk "
                         "(the reused closing kick IS the next opening "
                         "kick) at half the force passes")
    ap.add_argument("--checkpoint", default=None,
                    help="optional .npz path saved at every report")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card) or 'cpu'")
    args = ap.parse_args(argv)

    from tpu_nbody_torch import checkpoint
    from tpu_nbody_torch.config import Params, SimConfig
    from tpu_nbody_torch.engine import Engine

    cap = 1 << (args.n - 1).bit_length()
    mesh_kw = {}
    if args.mesh_split is not None:
        mesh_kw["mesh_split"] = args.mesh_split
    if args.mesh_rescue_k is not None:
        mesh_kw["mesh_rescue"] = args.mesh_rescue_k
    if args.mesh_level is not None:
        mesh_kw["mesh_level"] = args.mesh_level
    if args.mesh_band is not None:
        mesh_kw["mesh_band"] = args.mesh_band
    if args.mesh_every is not None:
        mesh_kw["pm_mesh_every"] = args.mesh_every
    if args.heavy_cap is not None:
        mesh_kw["pm_heavy_cap"] = args.heavy_cap
    mesh_kw.setdefault("mesh_level", 11)
    mesh_kw.setdefault("mesh_band", 128)
    cfg = SimConfig(capacity=cap, max_depth=12,
                    mesh_chunk=min(32768, cap), **mesh_kw)
    params = Params.default(theta=args.theta, merge_min_dist=0.0)
    if args.dt is not None:
        params = params.replace(dt=args.dt)
    eng = Engine(cfg, params, solver=args.solver,
                 integrator=args.integrator, device=args.device)
    n2 = args.n // 5
    eng.reset_default_scene(n1=args.n - n2, n2=n2)

    # the O(N^2) potential is asked for whatever the capacity: the energy
    # is the metric
    s0 = eng.stats(potential=True)
    e0 = float(s0["energy"])
    l0 = float(s0["angular_momentum_z"])
    print(f"# E0={e0:.6e} Lz0={l0:.6e} n={int(s0['n_alive'])}", flush=True)

    t0 = time.perf_counter()
    done = 0
    de = dl = 0.0
    while done < args.steps:
        k = min(args.report_every, args.steps - done)
        eng.step(k)
        done += k
        s = eng.stats(potential=True)
        de = abs(float(s["energy"]) - e0) / abs(e0)
        dl = abs(float(s["angular_momentum_z"]) - l0) / max(abs(l0), 1e-30)
        print(json.dumps({
            "step": done,
            "energy_drift": round(de, 8),
            "Lz_drift": round(dl, 8),
            "elapsed_s": round(time.perf_counter() - t0, 1),
        }), flush=True)
        if args.checkpoint:
            checkpoint.save(args.checkpoint, eng.state, eng.params,
                            e0=e0, l0=l0)

    result = {
        "metric": f"relative energy drift over {args.steps} steps "
                  f"(solver={args.solver}, N={args.n}, theta={args.theta}, "
                  f"dt={float(eng.params.dt)})",
        "value": de,
        "unit": "relative",
    }
    print(json.dumps(result), flush=True)
    return dict(result, Lz_drift=dl, elapsed_s=time.perf_counter() - t0)


if __name__ == "__main__":
    main()
