"""The exact all-pairs cell, ``allpairs_collide1m_batch``, at a size the CPU
holds: whole runs (traced and not), each fault of ``faults.py`` caught,
the control not correct; its two readers on synthetic spans; and the
frozen pair count against the program's."""

import json
from types import SimpleNamespace

import pytest
import torch

from nbody_bench import allpairs_work, control, readers, run, spans, work
from nbody_bench.tests import faults, tiny
from nbody_bench.tests.test_nbb_spans import _Program, _ctx, _launch_case

CELL = "allpairs_collide1m_batch"


def _run(tmp_path, traced=False, make_system=None, seed=2 ** 31 + 91):
    pkg, bench = tiny.make(tmp_path)
    return run.run(CELL, seed, 0.5, traced, device="cpu", bench=bench,
                   pkg=pkg, make_system=make_system), pkg, bench


@pytest.mark.parametrize("traced", [False, True])
def test_tiny_run(tmp_path, traced):
    res, pkg, bench = _run(tmp_path, traced)
    json.dumps(res)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    cell = run.manifest.Cell(CELL, bench, pkg)
    if traced:
        # no profiler on the CPU: the per-layer metrics have nothing to read
        assert [m["name"] for m in cell.per_layer] == [
            "allpairs_device_ms_per_pass", "allpairs_roofline_pct"]
        assert res["metrics"] == {}
    else:
        assert set(res["metrics"]) == {"body_updates_per_s.allpairs",
                                       "setup_s"}
        assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_caught(tmp_path, fault):
    res, _, _ = _run(tmp_path, make_system=faults.program_with(
        faults.FAULTS[fault]), seed=3)
    assert not res["correct"], res["checks"]


def test_control_is_not_correct(tmp_path):
    res, _, _ = _run(tmp_path, make_system=control.Control, seed=11)
    assert not res["correct"]
    assert res["checks"]["dv_p99"]["value"] > \
        res["checks"]["dv_p99"]["limit"]


def _marked_case():
    """The launch case's two calls, each one all-pairs pass: the first
    call's three launches in an ``allpairs`` phase; of the second's, the
    copy in one, its kernels in ``kick_drift`` and ``kick``."""
    return _launch_case(), [("allpairs", 0.05, 0.35),
                            ("kick_drift", 0.55, 0.65),
                            ("allpairs", 0.65, 0.75), ("kick", 0.75, 0.85)]


def _slice_state(n_alive=3, capacity=5):
    alive = torch.zeros(capacity, dtype=torch.bool)
    alive[:n_alive] = True
    pos = torch.zeros((capacity, 2))
    return pos, pos, torch.ones(capacity), alive


def _reader(name):
    cell = run.manifest.Cell(CELL)
    return cell.reader(name)


def test_the_readers_on_synthetic_spans(monkeypatch):
    tr, phases = _marked_case()
    monkeypatch.setattr(spans, "_profiling", lambda: _Program(phases))
    ctx = _ctx(tr, slice_calls=2, steps=1)
    ctx.config = {"integrator": "kdk_reuse"}
    ctx.slice_state = _slice_state()
    # tree_kernel, the memset and regular_fft; the copy DtoH
    spent = 0.10 + 0.02 + 0.08 + 0.01
    assert _reader("allpairs_device_ms_per_pass")(ctx) == pytest.approx(
        1e3 * spent / 2)
    w = allpairs_work.pair_work(3, 3, 2)
    want = 100.0 * 4 * work.bound_s(w["flops"], w["bytes"]) / spent
    assert readers.passes(ctx) == 4
    assert _reader("allpairs_roofline_pct")(ctx) == pytest.approx(want)


@pytest.mark.parametrize("case", ["no_allpairs_mark", "older_program",
                                  "no_trace"])
def test_the_readers_read_none_without_allpairs_marks(monkeypatch, case):
    tr, phases = _marked_case()
    program = _Program([("build", 0.05, 0.25), ("kick", 0.55, 0.85)])
    if case == "older_program":
        program = None
    monkeypatch.setattr(spans, "_profiling", lambda: program)
    ctx = _ctx(None if case == "no_trace" else tr)
    ctx.config = {"integrator": "kdk_reuse"}
    ctx.slice_state = _slice_state()
    assert allpairs_work.device_s(ctx) is None
    assert _reader("allpairs_device_ms_per_pass")(ctx) is None
    assert _reader("allpairs_roofline_pct")(ctx) is None


@pytest.mark.parametrize("n_alive,capacity,dim", [(995_123, 1 << 20, 2),
                                                  (3, 5, 2), (7, 16, 3)])
def test_the_frozen_count_is_the_programs_at_the_alive_counts(
        n_alive, capacity, dim):
    from tpu_nbody_torch.ops import forces

    assert allpairs_work.pair_work(n_alive, n_alive, dim) == \
        forces.pair_work(n_alive, n_alive, dim)
    alive = torch.zeros(capacity, dtype=torch.bool)
    alive[:n_alive] = True
    ctx = SimpleNamespace(slice_state=(torch.zeros((capacity, dim)), None,
                                       None, alive))
    assert allpairs_work.pass_work(ctx) == forces.pair_work(n_alive, n_alive,
                                                            dim)


@pytest.mark.parametrize("dim,flops,source_bytes", [(2, 13, 12), (3, 18, 16)])
def test_the_frozen_count_by_dim(dim, flops, source_bytes):
    """A pair's flops, and each source's position and mass read once (x,
    y, m in 2D; x, y, z, m in 3D, 16 B), each target's position read and
    its acceleration written once: the 3D cell's roofline reads this
    count with no code of its own."""
    w = allpairs_work.pair_work(50_001, 50_001, dim)
    assert w["pairs"] == 50_001 ** 2
    assert w["flops"] == flops * 50_001 ** 2
    assert w["bytes"] == 50_001 * (source_bytes + 2 * 4 * dim)
