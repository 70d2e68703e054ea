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


class _HostEvent:
    """Stands in for torch.cuda.Event on the CPU: a host clock."""

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


def test_timed_ms_and_event_clock(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    calls = []
    ms = profiling.timed_ms(lambda: (calls.append(1), time.sleep(0.002)),
                            reps=3)
    assert len(calls) == 5 and 2.0 <= ms < 1000.0     # 2 warm-ups, 3 timed
    clock = profiling.EventClock()
    clock("start")
    time.sleep(0.002)
    clock("a")
    clock("b")
    time.sleep(0.002)
    clock("a")
    out = clock.ms()
    assert set(out) == {"a", "b"} and out["a"] >= 4.0 and out["b"] >= 0.0


def test_bounds_take_the_larger_time():
    ops = profiling.bounds(dict(flops=67e9, bytes=3.35e6), 2.0)
    assert ops["bound_by"] == "operations"
    assert ops["bound_ms"] == pytest.approx(1.0)
    assert ops["pct_of_bound"] == pytest.approx(50.0)
    assert "rsqrt_floor_ms" not in ops
    mem = profiling.bounds(dict(flops=0, bytes=3.35e9, pairs=16 * 132e6),
                           4.0, n_sm=132, max_clock_hz=1e6)
    assert mem["bound_by"] == "bytes"
    assert mem["bound_ms"] == pytest.approx(1.0)
    assert mem["rsqrt_floor_ms"] == pytest.approx(1e3)


def test_card_info_reads_the_power_limit_or_says_not_read(monkeypatch):
    import subprocess

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev: "card")

    class Done:
        returncode = 0
        stdout = "NVIDIA H100 80GB HBM3, 700.00 W\n"

    monkeypatch.setattr(subprocess, "run", lambda *a, **k: Done())
    info = profiling.card_info("cuda:0")
    assert info == dict(name="card", smi="NVIDIA H100 80GB HBM3, 700.00 W",
                        power_limit="700.00 W")

    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(subprocess, "run", missing)
    info = profiling.card_info("cuda:0")
    assert info == dict(name="card", smi=None,
                        power_limit="power limit not read")


def _trace_file(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_trace_device_spans_keep_the_cards_operations(tmp_path):
    """Kernels, memsets and copies, by start; host ops, runtime calls and
    instant events are left out."""
    path = _trace_file(tmp_path, [
        dict(ph="X", cat="cpu_op", name="aten::add", ts=0, dur=50),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=1,
             dur=3),
        dict(ph="X", cat="kernel", name="k2", ts=30, dur=5),
        dict(ph="X", cat="gpu_memset", name="Memset (Device)", ts=10, dur=2),
        dict(ph="i", cat="kernel", name="marker", ts=12),
        dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", ts=40, dur=1.5),
    ])
    spans = profiling.trace_device_spans(path)
    assert [e["name"] for e in spans] == ["Memset (Device)", "k2",
                                          "Memcpy DtoH"]
    assert spans[1] == dict(name="k2", cat="kernel", ts=30.0, dur=5.0)


@pytest.mark.parametrize("spans,window,want", [
    ([], (0, 10), 0.0),
    ([(0, 4), (2, 3), (10, 1)], (-1e9, 1e9), 6.0),     # overlap merged
    ([(0, 4), (2, 3), (10, 1)], (3, 10.5), 2.5),       # clipped
    ([(5, 1), (0, 2), (1, 1)], (-1e9, 1e9), 3.0),      # out of order
])
def test_busy_us_is_the_union_in_the_window(spans, window, want):
    ev = [dict(name="k", cat="kernel", ts=float(a), dur=float(d))
          for a, d in spans]
    assert profiling.busy_us(ev, *window) == pytest.approx(want)
