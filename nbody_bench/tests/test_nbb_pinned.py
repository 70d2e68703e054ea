"""The 2D check reads what it read before it learnt 3D: on a fixed seed and
state its numbers are pinned to those of the harness before that change.

The state is the benchmark's own: the scene at 3,000 bodies from a fixed
seed, and as the "program's" answer the reference's own steps on a
coarser mesh in float32, with the frame of that answer, so that every
number reads above zero. Floats are held to 1e-9 of their pinned value
(a CPU with other vector units rounds torch's sums otherwise), counts
exactly."""

import pytest
import torch

from nbody_bench import check, scene
from nbody_bench.reference import render as ref_render
from nbody_bench.reference.follow import follow

SEED = 2 ** 31 + 5
CONFIG = {"n_bodies": 3000, "world_w": 2400.0, "world_h": 800.0,
          "integrator": "kdk_reuse", "sim_config": {},
          "params": {"G": 80.0, "dt": 0.005, "softening": 1.0, "theta": 0.3,
                     "merge_max_mass": 4000.0, "merge_min_dist": 8.0}}
WORKLOAD = {"check": {"calls": 1, "start_steps": 2, "random_targets": 64,
                      "calm_px": 30.0, "merge_slack_px": 0.001,
                      "kill_slack_px": 1.0, "ref_level": 10,
                      "ref_split_cells": 1.5},
            "limits": {"dv_p99": 0.1, "dx_max_px": 1.0, "merge_left": 0,
                       "killed_far": 0, "mass_gap": 1e-05,
                       "frame_px_share": 0.05}}
RENDER = {"width": 2400, "height": 800, "speed_scale": 1 / 300,
          "size_mass_scale": 1e-4}
SCENE_SUMS = (4658361.98979187, -42702.84452454746, 60500.00015151501)
PINNED = {"dv_p99": 0.19676307734482204, "dx_max_px": 0.05861080391172969,
          "merge_left": 0, "killed_far": 0,
          "mass_gap": 2.4838880996920417e-08,
          "frame_px_share": 0.04695945945945946}
PINNED_CALLS = [
    {"index": -1, "dv_p99": 0.19676307734482204, "targets": 66,
     "compared": 66, "calm": 2197, "absorbed": 4, "absorbed_ref": 5},
    {"index": 7, "dv_p99": 0.15713644352488493, "targets": 66,
     "compared": 66, "calm": 2197, "absorbed": 4, "absorbed_ref": 5,
     "frame_px_share": 0.04695945945945946}]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(got, want):
    if isinstance(want, int):
        assert got == want
    else:
        assert got == pytest.approx(want, rel=1e-9, abs=0.0)


def test_the_2d_check_reads_its_pinned_numbers(one_thread):
    pos, vel, mass = scene.make(CONFIG, SEED, "cpu")
    for got, want in zip(scene.two_disk(SEED, CONFIG["n_bodies"], "cpu"),
                         (pos, vel, mass)):
        assert torch.equal(got, want)
    for t, want in zip((pos, vel, mass), SCENE_SUMS):
        _same(float(t.double().sum()), want)
    alive = torch.ones(CONFIG["n_bodies"], dtype=torch.bool)
    before = (pos, vel, mass, alive)
    coarse = check.reference_solver(
        CONFIG, {**WORKLOAD["check"], "ref_level": 8}, "cpu")
    f = follow(*before, torch.arange(4), 3, check.physics(CONFIG), coarse,
               dtype=torch.float32)
    after = (f.pos, f.vel, f.mass, f.alive)
    img = ref_render.frame(f.pos, f.vel, f.mass, f.alive, **RENDER,
                           dtype=torch.float32)
    kept = [check.Kept(-1, 3, before, after, None),
            check.Kept(7, 3, before, after, img)]
    ok, numbers, details = check.judge(kept, CONFIG, WORKLOAD, RENDER, SEED,
                                       "cpu")
    assert not ok      # dv_p99 reads above its limit of 0.1
    assert set(numbers) == set(PINNED)
    for name, want in PINNED.items():
        _same(numbers[name][0], want)
        assert numbers[name][1] == WORKLOAD["limits"][name]
    for d, want in zip(details, PINNED_CALLS):
        for key, value in want.items():
            _same(d[key], value)
