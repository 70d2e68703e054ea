"""What decides ``correct``: the window's calls held against the plain
reference (:mod:`nbody_bench.reference`).

During the window a reservoir sample, drawn from the seed, keeps copies
of the state before and after some of the window's calls (and the frame
the call rendered); set-up keeps the generated scene and the state after
the program's first, short ``Engine.step`` from it (the start). Once the
window has closed and the program is freed, the reference follows each
kept call from its state before, by the configuration's integrator
(:mod:`nbody_bench.reference.follow`): the start from the benchmark's own
scene, the window's calls from the program's state (the reference cannot
reach them otherwise: see ``PERF.md``). In 2D every body follows the
reference's plain P3M and the sampled targets exact forces; in 3D
(``sim_config.dim`` 3) every body follows exact forces. For each kept
call it compares, against the limits of the cell's
``workloads/<cell>.json``:

* ``dv_p99`` — over the sampled targets (random alive bodies and the
  heavies) alive on both sides, the 99th percentile of |v_program −
  v_reference| over the larger of the target's own velocity change in
  the reference and the median change: the force solver and the
  integrator, against exact gravity;
* ``dx_max_px`` — over every body alive on both sides and farther than
  ``calm_px`` from every heavy at the call's start, the largest
  |x_program − x_reference| in px, the reference's trajectory:
  an answer altered anywhere (near a heavy an orbit of a few steps a turn
  parts any two solvers' trajectories by px);
* ``merge_left`` — the alive bodies of the program's state after the call
  that the absorb rule (:mod:`nbody_bench.reference.merge`) still finds
  closer to an alive heavy than the absorb distance less
  ``merge_slack_px``: the merge rule's one side, judged on what the
  program returned (which bodies a chaotic orbit near a heavy brings into
  reach differs between any two solvers, so their counts are no fair
  comparison);
* ``killed_far`` — the bodies the program killed in the call that were
  farther than ``calm_px`` from every heavy at its start and that never
  came within the absorb distance plus ``kill_slack_px`` of an alive heavy
  in the reference: the rule's other side (a body the rule keeps, killed);
* ``mass_gap`` — |total alive mass after the call − before| over the
  total before, in the program's own state: the absorb rule moves mass
  and never loses it;
* ``frame_px_share`` (a call that renders) — of the pixels lit in either
  frame, the share whose channels differ by more than one level between
  the program's frame and the reference's frame of its own state: the
  render. A 3D loop returns its frame with the camera's yaw, and the
  reference's frame is taken under the same camera.

Each number is the largest over the run's checked calls.
"""

from __future__ import annotations

import random
import time
from typing import NamedTuple

import torch

from nbody_bench import work
from nbody_bench.reference import merge
from nbody_bench.reference import render as ref_render
from nbody_bench.reference.follow import Physics, follow
from nbody_bench.reference.p3m import P3M

NUMBERS = ("dv_p99", "dx_max_px", "merge_left", "killed_far", "mass_gap",
           "frame_px_share")
# the traffic's keys that the reference's frame takes
RENDER_KEYS = ("width", "height", "speed_scale", "size_mass_scale", "gain",
               "cam_pitch", "world_scale")


class Kept(NamedTuple):
    index: int          # the call's number in the window; -1: the start
    steps: int
    before: tuple       # (pos, vel, mass, alive) copies
    after: tuple
    frame: object       # the host uint8 frame, (frame, yaw) in 3D, or None


def copy_state(st) -> tuple:
    return tuple(t.detach().clone() for t in (st.pos, st.vel, st.mass,
                                              st.alive))


class Reservoir:
    """A uniform sample of ``k`` of the window's calls (algorithm R),
    decided before each call from a generator seeded by the run's seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen = k, 0
        self.rng = random.Random(seed * 7919 + 17)
        self.kept: list[Kept | None] = [None] * k

    def slot(self) -> int | None:
        """The slot the next call fills, or None."""
        self.seen += 1
        if self.seen <= self.k:
            return self.seen - 1
        j = self.rng.randrange(self.seen)
        return j if j < self.k else None


def physics(config: dict) -> Physics:
    p = config["params"]
    return Physics(float(p["G"]), float(p["dt"]),
                   float(p["softening"]) ** 2, float(p["merge_max_mass"]),
                   float(p["merge_min_dist"]))


def reference_solver(config: dict, sample: dict, device,
                     dtype=torch.float64) -> P3M | None:
    """The reference's own P3M: cells of side root / 2^``ref_level``, the
    short range within 2 x ``ref_split_cells`` cells; None in 3D, where
    every body follows exact forces."""
    if config["sim_config"].get("dim", 2) == 3:
        return None
    _, side = work.root(config["world_w"], config["world_h"])
    h = side / (1 << sample["ref_level"])
    ph = physics(config)
    return P3M(h, 2.0 * sample["ref_split_cells"] * h, ph.soft2, ph.G,
               dtype=dtype, device=device)


def targets(alive, heavy, count: int, seed: int, index: int):
    """Sorted unique indices: ``count`` alive bodies drawn from (seed,
    index), and every heavy."""
    dev = alive.device
    g = torch.Generator(device=dev)
    g.manual_seed((int(seed) * 1_000_003 + index + 1) % (1 << 63))
    live = torch.nonzero(alive).flatten()
    pick = live[torch.randperm(live.numel(), generator=g,
                               device=dev)[:count]]
    return torch.unique(torch.cat([pick, heavy]))


def judge_one(kept: Kept, config: dict, sample: dict, render_cfg, seed: int,
              solver: P3M | None) -> dict:
    """The numbers of one kept call, with counts beside them."""
    ph = physics(config)
    pos0, _, mass0, alive0 = kept.before
    heavy = merge.heavies(mass0, alive0, ph.merge_max_mass)
    tid = targets(alive0, heavy, sample["random_targets"], seed, kept.index)
    t = time.perf_counter()
    f = follow(*kept.before, tid, kept.steps, ph, solver,
               config["integrator"])
    follow_s = time.perf_counter() - t
    pos, vel, mass, alive = (t.to(f.pos.device) for t in kept.after)
    v0 = kept.before[1][tid].double()
    both = alive[tid] & f.talive
    dv_ref = torch.linalg.norm(f.tvel - v0, dim=1)
    scale = torch.clamp(dv_ref, min=float(dv_ref[both].median()))
    err = torch.linalg.norm(vel[tid].double() - f.tvel, dim=1) / scale
    e = err[both]
    dv_p99 = float(torch.quantile(e, 0.99)) if e.numel() else float("inf")
    p0 = pos0.double()
    near = torch.zeros_like(alive0)
    for h in heavy.tolist():
        near |= torch.linalg.norm(p0 - p0[h], dim=1) <= sample["calm_px"]
    calm = alive & f.alive & ~near
    dx = torch.linalg.norm(pos.double() - f.pos, dim=1)[calm]
    dx_max = float(dx.max()) if dx.numel() else float("inf")
    n0 = int(alive0.sum())
    reach = ph.merge_min_dist - sample["merge_slack_px"]
    _, kept_alive = merge.absorb(pos.double(), mass.double(), alive,
                                 ph.merge_max_mass, reach)
    far = f.closest > ph.merge_min_dist + sample["kill_slack_px"]
    killed = alive0 & ~alive
    m0 = float(mass0.double()[alive0].sum())
    m1 = float(mass.double()[alive].sum())
    out = dict(dv_p99=dv_p99, dx_max_px=dx_max,
               merge_left=int((alive & ~kept_alive).sum()),
               killed_far=int((killed & ~near & far).sum()),
               mass_gap=abs(m1 - m0) / m0,
               targets=int(tid.numel()), compared=int(both.sum()),
               calm=int(calm.sum()), absorbed=n0 - int(alive.sum()),
               absorbed_ref=n0 - int(f.alive.sum()), follow_s=follow_s)
    if kept.frame is not None:
        got, yaw = kept.frame if isinstance(kept.frame, tuple) \
            else (kept.frame, None)
        if yaw is None:
            ref = ref_render.frame(f.pos, f.vel, f.mass, f.alive,
                                   **render_cfg)
        else:
            ref = ref_render.frame3d(f.pos, f.vel, f.mass, f.alive,
                                     cam_angle=float(yaw), **render_cfg)
        got = torch.as_tensor(got).to(ref.device)
        diff = (got.to(torch.int16) - ref.to(torch.int16)).abs().amax(dim=2)
        lit = (got.amax(dim=2) > 0) | (ref.amax(dim=2) > 0)
        out["frame_px_share"] = float((diff > 1).sum()) / max(
            int(lit.sum()), 1)
    return out


def judge(kept: list, config: dict, workload: dict, render_cfg, seed: int,
          device) -> tuple:
    """(correct, {name: (value, limit)}, [per-call details]) over the kept
    calls; a number absent from every call is left out."""
    sample = workload["check"]
    limits = workload["limits"]
    solver = reference_solver(config, sample, device)
    details = [dict(index=k.index, **judge_one(k, config, sample, render_cfg,
                                               seed, solver))
               for k in kept if k is not None]
    numbers = {}
    for name in NUMBERS:
        vals = [d[name] for d in details if name in d]
        if vals:
            numbers[name] = (max(vals), float(limits[name]))
    ok = bool(details) and all(v <= lim for v, lim in numbers.values())
    return ok, numbers, details
