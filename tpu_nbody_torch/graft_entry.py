"""The port's twin of the repo's ``__graft_entry__.py``: a one-device step
and a dry run of the sharded solvers.

    python -m tpu_nbody_torch.graft_entry              # on the card
    python -m tpu_nbody_torch.graft_entry --device cpu
"""

from __future__ import annotations

import argparse

import torch


def entry(device="cuda"):
    """(step, (state, params)): the Barnes–Hut kick-drift-kick step and the
    merge rule on the reference's two-disk collision (``NBodyPanel.kt:
    83-100``), 12,500 bodies at capacity 16,384 (seed 3), on ``device``
    (the card unless the caller asks for the CPU; raises without a card)."""
    from tpu_nbody_torch.config import Params, SimConfig
    from tpu_nbody_torch.engine import Caps, make_bh_accel
    from tpu_nbody_torch.models import scenes
    from tpu_nbody_torch.ops.integrate import kdk_step
    from tpu_nbody_torch.ops.merge import merge_bodies
    from tpu_nbody_torch.state import check_device, from_arrays

    dev = check_device(device)
    cfg = SimConfig(capacity=16384, max_depth=12, group_chunk=8,
                    approx_cap=2048, direct_body_cap=4096,
                    frontier_cap=1024, leaf_list_cap=512)
    accel_stats = make_bh_accel(cfg, Caps.from_config(cfg))

    def accel(pos, mass, alive, params):
        return accel_stats(pos, mass, alive, params)[0]

    def step(state, params):
        return merge_bodies(kdk_step(state, params, accel), params)[0]

    g = torch.Generator(device=dev).manual_seed(3)
    p, v, m = scenes.default_two_disk_scene(g, n1=10_000, n2=2_500)
    state = from_arrays(p, v, m, capacity=cfg.capacity, device=dev)
    return step, (state, Params.default())


def _check_ran(name: str, states):
    st = states[0]
    if int(st.step) != 2 or not all(bool(torch.isfinite(s.pos).all())
                                    for s in states):
        raise RuntimeError(f"dryrun_multichip: {name} did not run two finite "
                           f"steps")


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Two steps of each sharded solver on ``n_devices`` ranks of one
    ThreadGroup on ``device`` (the card unless the caller asks for the CPU)
    at capacity 64 per rank: the exact ring all-pairs step, the
    domain-decomposed P3M step and the domain-decomposed Barnes–Hut step,
    each with the sharded merge. A check that every collective and kernel
    of the sharded paths runs, not a benchmark."""
    from tpu_nbody_torch.config import Params, SimConfig
    from tpu_nbody_torch.engine import Caps
    from tpu_nbody_torch.models import scenes
    from tpu_nbody_torch.parallel import mesh as mesh_lib
    from tpu_nbody_torch.parallel.sharded import make_sharded_step
    from tpu_nbody_torch.parallel.sharded_bh import make_sharded_bh_step
    from tpu_nbody_torch.parallel.sharded_pm import (make_sharded_pm_step,
                                                     reshard_by_hilbert)
    from tpu_nbody_torch.state import from_arrays

    cap = 64 * n_devices
    mesh = mesh_lib.make_mesh(n_devices, device=device)
    g = torch.Generator(device=mesh.device).manual_seed(0)
    p, v, m = scenes.default_two_disk_scene(g, n1=cap // 2, n2=cap // 4)
    state = from_arrays(p, v, m, capacity=cap, device=mesh.device)
    params = Params.default()

    # 1. exact ring all-pairs
    out, _ = make_sharded_step(mesh)(mesh_lib.shard_state(state, mesh),
                                     params, n_steps=2)
    _check_ran("the ring all-pairs step", out)

    # 2. domain-decomposed P3M
    cfg = SimConfig(capacity=cap, mesh_level=8, mesh_band=16,
                    mesh_chunk=max(16, cap // n_devices))
    out, _ = make_sharded_pm_step(mesh, cfg)(
        reshard_by_hilbert(state, mesh, cfg), params, n_steps=2)
    _check_ran("the P3M step", out)

    # 3. domain-decomposed Barnes–Hut (local trees + LET exchange)
    cfg_bh = SimConfig(capacity=cap, max_depth=6, group_chunk=8,
                       approx_cap=256, direct_body_cap=256,
                       frontier_cap=128, leaf_list_cap=64,
                       node_capacity=512)
    out, _ = make_sharded_bh_step(
        mesh, cfg_bh, Caps.from_config(cfg_bh), let_approx_cap=128,
        let_body_cap=128, let_leaf_cap=64, let_frontier_cap=256)(
            reshard_by_hilbert(state, mesh, cfg_bh), params, n_steps=2)
    _check_ran("the Barnes–Hut step", out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    ap.add_argument("--devices", type=int, default=8,
                    help="ranks of the dry run")
    args = ap.parse_args(argv)
    dryrun_multichip(args.devices, device=args.device)
    print(f"dryrun_multichip ok on {args.devices} ranks", flush=True)
    fn, (state, params) = entry(device=args.device)
    out = fn(state, params)
    print(f"entry ok: n_alive = {int(out.n_alive())}", flush=True)


if __name__ == "__main__":
    main()
