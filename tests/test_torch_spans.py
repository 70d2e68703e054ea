"""The program's phase marks and call records (tpu_nbody_torch.profiling's
Recorder) on the CPU: off by default, the vocabulary of each step in order
under the profiler and under the operator's switch, no effect on the
state, a bounded buffer, and the profiler's clock."""

import bisect
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_nbody_torch import profiling
from tpu_nbody_torch.config import Params, SimConfig
from tpu_nbody_torch.engine import Engine
from tpu_nbody_torch.models import scenes3d
from tpu_nbody_torch.ops import render

torch.set_num_threads(2)

PM_CFG = dict(capacity=2048, mesh_level=10, mesh_band=64, mesh_rescue=4,
              mesh_switch="poly4", pm_resort_every=4, mesh_chunk=2048)
# the subcycled sorted carry: carried grids refreshed every 2nd step, the
# 2 heaviest bodies summed directly, and a re-sort that permutes the grids
SUB_CFG = dict(PM_CFG, pm_mesh_every=2, pm_heavy_cap=2, pm_resort_every=2)
BH_CFG = dict(capacity=256, max_depth=7, group_chunk=16, approx_cap=1024,
              direct_body_cap=2048, frontier_cap=512, leaf_list_cap=256,
              group_cap=16)
LONG = ["deposit", "fft", "fd", "interp"]
SHORT = ["band", "select", "rescue"]
PM_PASS = LONG + SHORT
BH_PASS = ["build", "groups", "lists", "evaluate", "assemble"]


def _engine(kind):
    """An engine of ``kind``: "pm" (the sorted carry), "pm_sub" (the
    subcycled sorted carry), "pm_kdk" (the generic pm step), "allpairs",
    "allpairs3d" (euler, dim=3), a bh traversal ("dense", "hier"), or
    "dense_kdk" / "dense_strict" (kdk; kdk_reuse with strict parity)."""
    if kind in ("pm", "pm_sub", "pm_kdk"):
        cfg = SUB_CFG if kind == "pm_sub" else PM_CFG
        eng = Engine(SimConfig(**cfg), Params.default(), solver="pm",
                     integrator="kdk" if kind == "pm_kdk" else "kdk_reuse",
                     device="cpu")
        eng.reset_default_scene(n1=1500, n2=400)
    elif kind == "allpairs":
        eng = Engine(SimConfig(capacity=256), solver="allpairs",
                     integrator="kdk_reuse", device="cpu")
        eng.reset_default_scene(n1=150, n2=50)
    elif kind == "allpairs3d":
        eng = Engine(SimConfig(capacity=256, dim=3), solver="allpairs",
                     integrator="euler", device="cpu")
        eng.set_bodies(*scenes3d.generate_sphere(eng.generator, 200))
    else:
        traversal, _, how = kind.partition("_")
        eng = Engine(SimConfig(bh_traversal=traversal, **BH_CFG),
                     solver="bh",
                     integrator="kdk" if how == "kdk" else "kdk_reuse",
                     strict_parity=how == "strict", device="cpu")
        eng.reset_default_scene(n1=150, n2=50)
    eng.step(1)              # grows any cap before the call under test
    return eng


def _expected(kind, n):
    """The phase names of one step(n) call from the sorted state."""
    if kind in ("pm", "pm_sub"):
        cfg = SUB_CFG if kind == "pm_sub" else PM_CFG
        # a carried grid's long range is one "interp"
        force = ["interp"] + SHORT if kind == "pm_sub" else PM_PASS
        out = ["hats", "sort"] + force
        for i in range(n):
            out += ["kick_drift"] + force + ["kick", "merge"]
            if (i + 1) % cfg["pm_resort_every"] == 0:
                out.append("resort")
        return out + ["unsort", "stats"]
    if kind == "pm_kdk":
        force = ["sort"] + PM_PASS + ["unsort"]
        out = ["hats"]
        for _ in range(n):
            out += (["kick_drift"] + force) * 2 + ["kick", "merge"]
        return out + ["stats"]
    force = ["allpairs"] if kind.startswith("allpairs") else BH_PASS
    if kind in ("allpairs3d", "dense_kdk"):      # no seed pass
        passes = 2 if kind == "dense_kdk" else 1
        out = []
        for _ in range(n):
            out += (["kick_drift"] + force) * passes + ["kick", "merge"]
        return out + ["stats"]
    out = list(force)
    for _ in range(n):
        out += ["kick_drift"] + force + ["kick", "merge"]
    return out + ["stats"]


@pytest.fixture(autouse=True)
def _fresh_recorder():
    profiling.RECORDER.clear()
    prev = profiling.set_recording(False)
    yield
    profiling.set_recording(prev)
    profiling.RECORDER.clear()


def test_off_by_default_a_step_keeps_its_call_record_alone():
    eng = _engine("pm")
    profiling.RECORDER.clear()
    t0 = time.time_ns()
    eng.step(3)
    t1 = time.time_ns()
    assert not profiling.RECORDER.active()
    assert profiling.phases() == [] and len(profiling.RECORDER.marks) == 0
    (rec,) = profiling.call_records()
    assert t0 <= rec.t_enter <= rec.t_sync_start <= rec.t_sync_end <= t1
    assert rec.steps == 3 and rec.rounds == 0 and rec.profiled is False


@pytest.mark.parametrize("how", ["profiler", "switch"])
@pytest.mark.parametrize("kind", ["pm", "dense", "hier", "allpairs", "pm_kdk",
                                  "pm_sub", "dense_kdk", "dense_strict",
                                  "allpairs3d"])
def test_a_step_marks_its_phases_in_order(kind, how):
    eng = _engine(kind)
    profiling.RECORDER.clear()
    n = 5 if kind in ("pm", "pm_sub") else 2
    t0 = time.time_ns()
    if how == "profiler":
        with profile(activities=[ProfilerActivity.CPU]):
            assert profiling.RECORDER.active()
            eng.step(n)
    else:
        profiling.set_recording(True)
        eng.step(n)
    t1 = time.time_ns()
    ph = profiling.phases()
    assert [p[0] for p in ph] == _expected(kind, n)
    names = [m[0] for m in profiling.RECORDER.marks]
    assert names[0] == "start" and names.count("start") == 1
    assert all(a[2] == b[1] for a, b in zip(ph, ph[1:]))     # contiguous
    assert all(p[1] <= p[2] for p in ph)
    (rec,) = profiling.call_records()
    assert t0 <= rec.t_enter <= profiling.RECORDER.marks[0][1]
    assert ph[-1][1] <= rec.t_sync_start <= rec.t_sync_end <= ph[-1][2] <= t1
    assert rec.profiled is True and rec.steps == n
    # the engine's recorder never counts pairs: the hier kernel keeps its
    # plain variant whether tracing is on or off
    assert getattr(profiling.RECORDER, "pairs", None) is None


@pytest.mark.parametrize("kind", ["pm", "hier", "allpairs", "pm_kdk", "pm_sub",
                                  "dense_kdk", "dense_strict",
                                  "allpairs3d"])
def test_the_state_is_bit_identical_with_the_recorder_on_and_off(kind):
    out = []
    for on in (False, True):
        eng = _engine(kind)
        profiling.set_recording(on)
        eng.step(4)
        profiling.set_recording(False)
        out.append(eng.state)
    for a, b in zip(*out):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


def test_render_marks_its_two_phases():
    st = _engine("pm").state
    profiling.RECORDER.clear()
    profiling.set_recording(True)
    fb = render.render_frame(st.pos, st.vel, st.mass, st.alive, width=96,
                             height=32, mode="speed")
    img = render.to_uint8(fb)
    assert img.dtype == torch.uint8
    assert [p[0] for p in profiling.phases()] == ["render", "to_uint8"]
    assert [m[0] for m in profiling.RECORDER.marks] == [
        "start", "render", "start", "to_uint8"]
    assert profiling.call_records() == []


def test_the_buffers_stay_within_their_bounds():
    rec = profiling.Recorder(marks=10, calls=3)
    for i in range(8):
        rec("start")
        rec("a")
        rec("b")
        rec.record_call(i, [(i, i + 1)], 1, False)
    assert len(rec.marks) == 10 and len(rec.calls) == 3
    assert [c.t_enter for c in rec.calls] == [5, 6, 7]
    # the oldest call lost its "start": its phases are dropped, the rest
    # are whole
    ph = rec.phases()
    assert [p[0] for p in ph] == ["a", "b"] * 3
    assert profiling.RECORDER.marks.maxlen == profiling.MARKS_KEPT
    assert profiling.RECORDER.calls.maxlen == profiling.CALLS_KEPT


def test_the_engines_buffer_keeps_the_newest_call_records(monkeypatch):
    monkeypatch.setattr(profiling, "RECORDER",
                        profiling.Recorder(marks=16, calls=2))
    eng = _engine("pm")
    profiling.set_recording(True)
    for n in (1, 2, 3):
        eng.step(n)
    assert [r.steps for r in profiling.call_records()] == [2, 3]
    assert len(profiling.RECORDER.marks) == 16


def test_a_retune_redo_counts_its_rounds():
    cfg = SimConfig(**{**BH_CFG, "leaf_list_cap": 8, "direct_body_cap": 8})
    eng = Engine(cfg, solver="bh", integrator="kdk_reuse", device="cpu")
    eng.reset_default_scene(n1=150, n2=50)
    profiling.set_recording(True)
    eng.step(1)
    (rec,) = profiling.call_records()
    assert rec.rounds >= 1
    names = [p[0] for p in profiling.phases()]
    assert names.count("stats") == rec.rounds + 1
    assert [m[0] for m in profiling.RECORDER.marks].count("start") == 1


def test_cpu_ops_lie_inside_their_program_phase_on_the_trace_clock(
        tmp_path):
    """profiling.trace writes the phases as ``program`` X events; every
    operator the CPU profiler records inside a step lies inside the phase
    the rule puts around it (Unix ns after the trace's base), and the
    rule's base is the one the trace file states."""
    eng = _engine("pm")
    with profiling.trace(str(tmp_path), device="cpu"):
        with torch.profiler.record_function("caller"):
            eng.step(4)
    assert not profiling.RECORDER.on
    data = json.loads((tmp_path / "trace.json").read_text())
    events = data["traceEvents"]
    prog = sorted((e for e in events if e.get("cat") == "program"),
                  key=lambda e: e["ts"])
    assert [e["name"] for e in prog] == _expected("pm", 4)
    ph = profiling.phases()
    assert [e["ts"] for e in prog] == [
        profiling.trace_us(a, data.get("baseTimeNanoseconds")) for _, a, _
        in ph]
    if "baseTimeNanoseconds" in data:
        assert data["baseTimeNanoseconds"] == profiling.trace_base_ns(
            ph[0][1])
    starts = [e["ts"] for e in prog]
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "cpu_op"
           and prog[0]["ts"] <= e["ts"] <= prog[-1]["ts"] + prog[-1]["dur"]]
    assert len(ops) > 100
    seen = set()
    for e in ops:
        p = prog[bisect.bisect_right(starts, e["ts"]) - 1]
        assert p["ts"] <= e["ts"] and \
            e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-3, (e, p)
        seen.add((e["name"], p["name"]))
    assert ("aten::fft_rfft", "fft") in seen
    assert ("aten::argsort", "sort") in seen
    caller = [e for e in events if e.get("name") == "caller"
              and e.get("ph") == "X"]
    assert caller and caller[0]["ts"] <= prog[0]["ts"]
