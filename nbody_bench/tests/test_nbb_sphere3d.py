"""The 3D path of the harness at a size the CPU holds: the frozen sphere
scene, a whole run of the GPU demo's loop (exact 3D all-pairs forces,
semi-implicit Euler, no merging, the orbiting camera's frames) correct,
each fault a 3D Euler cell can have caught, and the bfloat16 control not
correct. No cell of ``BENCHMARK.json`` runs 3D yet: the cell is the copy's
own (``tiny.add_sphere3d``)."""

import json

import pytest
import torch

from nbody_bench import control, run, scene
from nbody_bench.tests import faults, tiny


def _run(tmp_path, make_system=None, seed=2 ** 31 + 93, traced=False):
    pkg, bench = tiny.make(tmp_path)
    cell = tiny.add_sphere3d(pkg, bench)
    return run.run(cell, seed, 0.5, traced, device="cpu", bench=bench,
                   pkg=pkg, make_system=make_system)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7, 2 ** 33 + 1])
def test_the_sphere_has_the_same_counts_for_every_seed(seed):
    pos, vel, mass = scene.sphere3d(seed, 501, "cpu")
    assert pos.shape == vel.shape == (501, 3) and mass.shape == (501,)
    assert mass[:-1].eq(1.0).all() and float(mass[-1]) == 5e6
    centre = torch.tensor([1720.0, 720.0, 720.0])
    assert torch.equal(pos[-1], centre) and not vel[-1].any()
    r = (pos[:-1] - centre).norm(dim=1)
    assert float(r.max()) <= 648.0 * (1 + 1e-6)
    # tangential: the velocity is normal to the radius, of speed 3e5/r
    d = pos[:-1] - centre
    cos = (d * vel[:-1]).sum(dim=1) / (r * vel[:-1].norm(dim=1))
    assert float(cos.abs().max()) < 1e-3
    assert torch.allclose(vel[:-1].norm(dim=1),
                          3e5 / torch.clamp(r, min=10.0), rtol=1e-5)
    again = scene.sphere3d(seed, 501, "cpu")
    assert all(torch.equal(a, b) for a, b in zip((pos, vel, mass), again))
    other = scene.sphere3d(seed + 1, 501, "cpu")
    assert not torch.equal(pos, other[0])


def test_a_configuration_names_its_scene():
    config = dict(tiny.SPHERE3D_CONFIG)
    got = scene.make(config, 5, "cpu")
    want = scene.sphere3d(5, config["n_bodies"], "cpu")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        scene.make({**config, "scene": "no_such_scene"}, 5, "cpu")


@pytest.mark.parametrize("traced", [False, True])
def test_sound_program_is_correct(tmp_path, traced):
    res = _run(tmp_path, traced=traced)
    json.dumps(res)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["checks"]) == {"dv_p99", "dx_max_px", "merge_left",
                                  "killed_far", "mass_gap", "frame_px_share"}
    assert res["checks"]["merge_left"]["value"] == 0
    assert res["checks"]["killed_far"]["value"] == 0
    if not traced:
        assert set(res["metrics"]) == {"frames_per_s", "frame_ms_p95",
                                       "setup_s"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS_3D))
def test_fault_is_caught(tmp_path, fault):
    res = _run(tmp_path, faults.program_with(faults.FAULTS_3D[fault]), seed=3)
    assert not res["correct"], res["checks"]


def test_kick_drift_kick_in_place_of_euler_is_caught(tmp_path):
    res = _run(tmp_path, faults.program_as("kdk"), seed=3)
    assert not res["correct"], res["checks"]
    assert res["checks"]["dv_p99"]["value"] > \
        res["checks"]["dv_p99"]["limit"]


def test_a_frame_at_another_camera_angle_is_caught(tmp_path, monkeypatch):
    faults.camera_turned(monkeypatch)
    res = _run(tmp_path, seed=3)
    assert not res["correct"]
    share = res["checks"]["frame_px_share"]
    assert share["value"] > share["limit"]
    # the bodies themselves stepped right
    assert res["checks"]["dv_p99"]["value"] <= \
        res["checks"]["dv_p99"]["limit"]


def test_control_is_not_correct(tmp_path):
    res = _run(tmp_path, control.Control, seed=11)
    assert not res["correct"]
    assert res["checks"]["dv_p99"]["value"] > \
        res["checks"]["dv_p99"]["limit"]
