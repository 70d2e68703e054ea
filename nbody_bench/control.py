"""The control of the correctness check: the plain reference put in the
program's place, computed in bfloat16, the precision below the float32
that the configurations state.

Every body follows the reference's steps by the configuration's
integrator (kick-drift-kick, or semi-implicit Euler) with the plain P3M
in 2D (:mod:`nbody_bench.reference.p3m`; its FFT in float32, which torch
cannot run in bfloat16) or exact forces in 3D
(:mod:`nbody_bench.reference.gravity`), and the absorb rule, every
number of a call computed in bfloat16; between calls the state keeps
those values in the program's float32, which the loops' render takes. The
harness drives it through the cell's own loop and window and judges it
like the program: its ``correct`` has to come out false. On the card, at
the cell's own size:

    python3 -m nbody_bench.control --workload <cell> --seed <n> --seconds <s>

prints the compared numbers beside their limits; the benchmark's own runs
never run it. ``nbody_bench/tests/test_nbb_control.py`` runs it at a size
the CPU holds.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import NamedTuple

import torch

from nbody_bench import check
from nbody_bench.reference import gravity, merge
from nbody_bench.reference.p3m import P3M

DTYPE = torch.bfloat16


class State(NamedTuple):
    pos: torch.Tensor
    vel: torch.Tensor
    mass: torch.Tensor
    alive: torch.Tensor
    step: torch.Tensor          # () int32, the steps taken


class Engine:
    """``step(n)`` and ``state``, as the loops use them."""

    def __init__(self, config: dict, device, sample: dict, dtype=DTYPE):
        self.phys = check.physics(config)
        ref = check.reference_solver(config, sample, device)
        self.solver = None if ref is None else P3M(
            ref.h, ref.rc, ref.soft2, ref.G, dtype=dtype, device=device)
        self.euler = config["integrator"] == "euler"
        self.dtype = dtype
        self.state = None

    def accel(self, P, M):
        if self.solver is not None:
            return self.solver.accel(P, M).to(self.dtype)
        own = torch.arange(P.shape[0], device=P.device)
        return gravity.direct_accel(P, P, M, self.phys.G, self.phys.soft2,
                                    self_idx=own, dtype=self.dtype)

    def step(self, n: int):
        ph, dt = self.phys, self.dtype
        st = self.state
        P, V, M = (t.to(dt) for t in (st.pos, st.vel, st.mass))
        A = st.alive
        half = torch.tensor(0.5 * ph.dt, dtype=dt, device=P.device)
        step = torch.tensor(ph.dt, dtype=dt, device=P.device)
        a = None if self.euler else self.accel(P, M)
        for _ in range(n):
            if self.euler:
                V = V + self.accel(P, M) * step
                P = P + V * step
            else:
                V = V + a * half
                P = P + V * step
                a = self.accel(P, M)
                V = V + a * half
            M, A = merge.absorb(P, M, A, ph.merge_max_mass,
                                ph.merge_min_dist)
        kept = st.pos.dtype
        self.state = State(P.to(kept), V.to(kept), M.to(kept), A,
                           st.step + n)
        return self.state


class Control:
    """The system the harness builds (:func:`nbody_bench.run.run`'s
    ``make_system``): the check's own reference solver, as the cell's
    ``workloads/<cell>.json`` sets it, in bfloat16."""

    def __init__(self, config: dict, device, workload: dict):
        self.eng = Engine(config, device, workload["check"])

    def load(self, pos, vel, mass):
        alive = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
        self.eng.state = State(pos, vel, mass, alive,
                               torch.zeros((), dtype=torch.int32,
                                           device=pos.device))

    def tuning(self):
        return ()

    def counters(self) -> str:
        return f"control: the plain reference in {self.eng.dtype}"


def main(argv=None) -> int:
    from nbody_bench import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("nbody_bench.control: needs a CUDA device", file=sys.stderr)
        return 2
    res = run.run(args.workload, args.seed, args.seconds, False,
                  make_system=Control)
    print(json.dumps({"control": args.workload, "seed": args.seed,
                      "correct": res["correct"], "checks": res["checks"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
