"""Exact all-pairs gravity on the two-disk collision: the benchmark's
``collide1m_allpairs`` configuration, scaled as its CPU tests scale it
(``nbody_bench/tests/tiny.py``: 3,000 bodies in 4,096 slots), through the
benchmark's system (``nbody_bench.system.Program``, the port's ``Engine``)
against a plain float64 step loop built from the benchmark's reference:
every body under exact softened gravity from every body
(``nbody_bench.reference.gravity``), kick-drift-kick with the carried
acceleration, the absorb rule (``nbody_bench.reference.merge``) after each
step. The same loop in bfloat16, the precision below the configuration's
float32, fails the same tolerances. Also: the all-pairs pass's phase mark
and the pairs it counts."""

import json

import pytest
import torch

from nbody_bench import scene
from nbody_bench.reference import gravity, merge
from nbody_bench.system import Program
from nbody_bench.tests import tiny
from tpu_nbody_torch.config import SimConfig
from tpu_nbody_torch.engine import Engine
from tpu_nbody_torch.kernels import _build
from tpu_nbody_torch.ops import forces

torch.set_num_threads(2)

STEPS = 20
SEED = 2          # a scene whose heavies absorb bodies within the 20 steps
CALM_PX = 30.0
# Tolerances, each against the float64 loop after STEPS steps. The port
# read dv_p99 3.1e-4 to 4.4e-4, dx 5.5e-4 to 8.1e-4 px and a mass gap of
# 4e-8 to 5e-8 on seeds 1-3; the bfloat16 loop 2.2-2.7, 37-43 px and
# 7e-3 to 8e-3, and it absorbed 25 to 30 times the bodies.
# dv: float32 positions (7e-5 px of rounding at x ~ 1200 px) and float32
# pair terms against float64, over the larger of each body's velocity
# change and the median change; 3e-3 is seven times the largest reading
# and 700 times under the bfloat16 loop's least.
DV_P99 = 3e-3
# dx (bodies more than CALM_PX from every heavy at the start, where no
# orbit of a few steps a turn amplifies rounding): the float32 drifts and
# velocities move a body by under 1e-3 px in 20 steps; 0.01 px is twelve
# times the largest reading and 3,700 times under the bfloat16 loop's.
DX_MAX_PX = 0.01
# mass: the heavies gain their victims' mass in float32 (6e-8 of the sum
# an add); 1e-6 of the total alive mass is twenty times the reading.
MASS_GAP = 1e-6
# absorbed sets: equal. At dx under 1e-3 px a body would have to pass
# within that of the 8 px absorb distance to flip; none does on seeds 1-3.


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    pkg, _ = tiny.make(tmp_path_factory.mktemp("bench"))
    return json.loads((pkg / "configs" / "collide1m_allpairs.json")
                      .read_text())


@pytest.fixture(scope="module")
def program_run(config):
    """(state before, state after) of the port's step(STEPS) from the
    seeded scene, float32 tensors on the CPU."""
    prog = Program(config, torch.device("cpu"))
    pos, vel, mass = scene.two_disk(SEED, config["n_bodies"], "cpu",
                                    world_w=config["world_w"],
                                    world_h=config["world_h"],
                                    G=config["params"]["G"])
    prog.load(pos, vel, mass)
    st = prog.eng.state
    before = tuple(t.clone() for t in (st.pos, st.vel, st.mass, st.alive))
    st = prog.eng.step(STEPS)
    return before, (st.pos, st.vel, st.mass, st.alive)


def plain_loop(pos, vel, mass, alive, params: dict, steps: int,
               dtype=torch.float64):
    """Every body under exact forces from every alive body, kick-drift-kick
    with the carried acceleration, the absorb rule after each step; the
    state held in ``dtype``."""
    G, dt = params["G"], params["dt"]
    soft2 = params["softening"] ** 2
    P, V = pos.to(dtype), vel.to(dtype)
    A = alive.clone()
    M = torch.where(A, mass.to(dtype), 0.0)
    own = torch.arange(P.shape[0])

    def accel(P, M):
        return gravity.direct_accel(P, P, M, G, soft2, self_idx=own,
                                    dtype=dtype).to(dtype)

    a = accel(P, M)
    for _ in range(steps):
        V = V + a * (0.5 * dt)
        P = P + V * dt
        a = accel(P, M)
        V = V + a * (0.5 * dt)
        M, A = merge.absorb(P, M, A, params["merge_max_mass"],
                            params["merge_min_dist"])
    return P, V, M, A


def compare(before, after, ref, params: dict) -> dict:
    """The numbers each tolerance bounds, of ``after`` against ``ref``."""
    pos0, vel0, mass0, alive0 = before
    pos, vel, mass, alive = after
    P, V, M, A = (t.double() if t.is_floating_point() else t for t in ref)
    both = alive & A
    dv_ref = torch.linalg.norm(V - vel0.double(), dim=1)
    scale = torch.clamp(dv_ref, min=float(dv_ref[both].median()))
    err = torch.linalg.norm(vel.double() - V, dim=1) / scale
    heavy = merge.heavies(mass0, alive0, params["merge_max_mass"])
    p0 = pos0.double()
    near = torch.zeros_like(alive0)
    for h in heavy.tolist():
        near |= torch.linalg.norm(p0 - p0[h], dim=1) <= CALM_PX
    calm = both & ~near
    dx = torch.linalg.norm(pos.double() - P, dim=1)[calm]
    m_prog = float(mass.double()[alive].sum())
    m_ref = float(M[A].sum())
    return dict(dv_p99=float(torch.quantile(err[both], 0.99)),
                dx_max_px=float(dx.max()), calm=int(calm.sum()),
                absorbed=alive0 & ~alive, absorbed_ref=alive0 & ~A,
                mass_gap=abs(m_prog - m_ref) / m_ref)


@pytest.fixture(scope="module")
def reference(config, program_run):
    return plain_loop(*program_run[0], config["params"], STEPS)


def test_the_port_matches_the_plain_float64_loop(config, program_run,
                                                 reference):
    before, after = program_run
    got = compare(before, after, reference, config["params"])
    assert got["calm"] > config["n_bodies"] // 2
    assert got["dv_p99"] <= DV_P99, got
    assert got["dx_max_px"] <= DX_MAX_PX, got
    # the same bodies absorbed, and some: the rule ran and agreed
    assert int(got["absorbed_ref"].sum()) > 0
    assert torch.equal(got["absorbed"], got["absorbed_ref"])
    assert got["mass_gap"] <= MASS_GAP, got


def test_the_loop_in_bfloat16_fails_the_tolerances(config, program_run,
                                                   reference):
    before, _ = program_run
    params = config["params"]
    low = plain_loop(*before, params, STEPS, dtype=torch.bfloat16)
    got = compare(before, tuple(t.float() if t.is_floating_point() else t
                                for t in low), reference, params)
    assert got["dv_p99"] > DV_P99
    assert got["dx_max_px"] > DX_MAX_PX
    assert got["mass_gap"] > MASS_GAP
    assert not torch.equal(got["absorbed"], got["absorbed_ref"])


@pytest.mark.parametrize("integrator,passes", [("kdk_reuse", 4),
                                               ("kdk", 6), ("euler", 3)])
def test_a_step_counts_its_pairs(integrator, passes):
    """step(3): kdk_reuse runs 3 + 1 passes (its seed), kdk 2 a step,
    euler 1; every pass takes every slot as a target and as a source,
    dead or alive. The CPU path launches nothing."""
    cap = 256
    eng = Engine(SimConfig(capacity=cap), solver="allpairs",
                 integrator=integrator, device="cpu")
    eng.reset_default_scene(n1=150, n2=50)
    p0, l0 = _build.LAUNCHES["allpairs_pairs"], _build.LAUNCHES["allpairs"]
    eng.step(3)
    assert _build.LAUNCHES["allpairs_pairs"] - p0 == passes * cap * cap
    assert _build.LAUNCHES["allpairs"] == l0


def test_targets_apart_from_the_sources_count_their_own_pairs():
    g = torch.Generator().manual_seed(5)
    pos = torch.rand((300, 2), generator=g) * 100
    mass = torch.rand((300,), generator=g)
    tgt = torch.rand((37, 2), generator=g) * 100
    p0 = _build.LAUNCHES["allpairs_pairs"]
    forces.accel_allpairs(pos, mass, 1.0, 1.0, targets=tgt)
    assert _build.LAUNCHES["allpairs_pairs"] - p0 == 37 * 300
