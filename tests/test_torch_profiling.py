"""tpu_nbody_torch.profiling on the CPU: the cases of tests/test_profiling.py
with the same interface, and trace writing its file."""

import json
import time

import pytest
import torch

from tpu_nbody import profiling as jprofiling
from tpu_nbody_torch import profiling, state as tstate

torch.set_num_threads(2)


def test_phase_timer_accumulates():
    pt, jpt = profiling.PhaseTimer(), jprofiling.PhaseTimer()
    for _ in range(3):
        with pt("work") as h, jpt("work"):
            x = torch.arange(16.0) * 2
            time.sleep(0.01)
            h["result"] = x
    with pt("other", result=(x, x)):
        pass
    assert pt.counts["work"] == jpt.counts["work"] == 3
    assert pt.totals["work"] >= 0.03
    report = pt.report().splitlines()
    assert report[0].startswith("work: ") and report[1].startswith("other: ")
    assert report[0].endswith("ms/call x3")
    # same format as the JAX package's report
    assert jpt.report().split(":")[0] == "work"
    assert len(report[0].split()) == len(jpt.report().split())


def test_phase_timer_times_a_failing_phase():
    pt = profiling.PhaseTimer()
    with pytest.raises(RuntimeError, match="boom"):
        with pt("bad"):
            raise RuntimeError("boom")
    assert pt.counts["bad"] == 1


def test_meter_rate():
    m = profiling.Meter()
    assert m.tick() == 0.0
    m._t0 = time.time() - 2.0  # force window rollover
    rate = m.tick(499)
    assert 200 < rate < 300  # 500 units over ~2s
    assert m.tick(1) == rate  # holds until the next window


def test_sync_takes_tensors_and_containers():
    x = torch.arange(1024.0)
    profiling.sync(x)
    profiling.sync({"a": x * 2})
    profiling.sync([None, (x,)])
    profiling.sync(tstate.empty_state(4, 3, device="cpu"))
    with pytest.raises(TypeError, match="no tensor"):
        profiling.sync("text")


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "deep" / "trace"
    with profiling.trace(str(log_dir), device="cpu") as prof:
        x = torch.ones((64, 64)) @ torch.ones((64, 64))
    assert float(x[0, 0]) == 64.0
    data = json.loads((log_dir / "trace.json").read_text())
    assert len(data["traceEvents"]) > 0
    assert any("mm" in e.key or "matmul" in e.key
               for e in prof.key_averages())


def test_trace_does_not_swallow_exceptions(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with profiling.trace(str(tmp_path / "t"), device="cpu"):
            1 / 0


def test_trace_raises_without_the_card_it_is_asked_for(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with profiling.trace(str(tmp_path / "t")):
            pass
    assert not (tmp_path / "t").exists()
