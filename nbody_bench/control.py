"""The control of the correctness check: the plain reference put in the
program's place, computed in bfloat16, the precision below the float32
that the configurations state.

Every body follows the reference's kick-drift-kick with the plain P3M
(:mod:`nbody_bench.reference.p3m`; its FFT in float32, which torch cannot
run in bfloat16) and the absorb rule, the state held in bfloat16. The
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
from nbody_bench.reference import merge
from nbody_bench.reference.p3m import P3M

DTYPE = torch.bfloat16


class State(NamedTuple):
    pos: torch.Tensor
    vel: torch.Tensor
    mass: torch.Tensor
    alive: torch.Tensor


class Engine:
    """``step(n)`` and ``state``, as the loops use them."""

    def __init__(self, config: dict, device, sample: dict, dtype=DTYPE):
        self.phys = check.physics(config)
        ref = check.reference_solver(config, sample, device)
        self.solver = P3M(ref.h, ref.rc, ref.soft2, ref.G, dtype=dtype,
                          device=device)
        self.dtype = dtype
        self.state = None

    def step(self, n: int):
        ph, dt = self.phys, self.dtype
        P, V, M, A = self.state
        half = torch.tensor(0.5 * ph.dt, dtype=dt, device=P.device)
        step = torch.tensor(ph.dt, dtype=dt, device=P.device)
        a = self.solver.accel(P, M).to(dt)
        for _ in range(n):
            V = V + a * half
            P = P + V * step
            a = self.solver.accel(P, M).to(dt)
            V = V + a * half
            M, A = merge.absorb(P, M, A, ph.merge_max_mass,
                                ph.merge_min_dist)
        self.state = State(P, V, M, A)
        return self.state


class Control:
    """The system the harness builds (:func:`nbody_bench.run.run`'s
    ``make_system``): the check's own reference solver, as the cell's
    ``workloads/<cell>.json`` sets it, in bfloat16."""

    def __init__(self, config: dict, device, workload: dict):
        self.eng = Engine(config, device, workload["check"])

    def load(self, pos, vel, mass):
        dt = self.eng.dtype
        alive = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
        self.eng.state = State(pos.to(dt), vel.to(dt), mass.to(dt), alive)

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
