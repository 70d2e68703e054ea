"""The window's and the trace's arithmetic on synthetic numbers."""

import json

import pytest

from nbody_bench import stats, trace


def test_rate_and_percentile():
    assert stats.rate(1000, 4.0) == 250.0
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == pytest.approx(95.05)
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile(vals, 0) == 1 and stats.percentile(vals, 100) == 100


def test_union_and_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.union(spans) == pytest.approx(3.0)
    assert stats.union(spans, 1.5, 3.5) == pytest.approx(1.0)
    assert stats.gaps(spans, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0),
                                            (4.0, 5.0)]


def _event(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_reading(tmp_path):
    spin = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    ev = [_event("cudaLaunchKernel", "cuda_runtime", t, 2, c)
          for c, t in ((1, 0), (2, 98), (3, 100), (4, 198))]      # marks
    ev += [_event(spin, "kernel", t + 2, 1, c)
           for c, t in ((1, 0), (2, 98), (3, 100), (4, 198))]
    ev += [_event("cudaLaunchKernel", "cuda_runtime", 5, 3, 10),
           _event("cudaLaunchKernel", "cuda_runtime", 52, 3, 11),
           _event("cudaStreamSynchronize", "cuda_runtime", 85, 45),
           _event("cudaMemsetAsync", "cuda_runtime", 135, 3, 12),
           _event("cudaLaunchKernel", "cuda_runtime", 165, 3, 13),
           _event("k1", "kernel", 20, 30, 10), _event("k2", "kernel", 70, 20, 11),
           _event("Memset (Device)", "gpu_memset", 150, 10, 12),
           _event("k1", "kernel", 180, 10, 13)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = trace.parse(str(path))
    assert [(m.start, m.end) for m in tr.marks] == [
        (0.0, pytest.approx(100e-6)), (pytest.approx(100e-6),
                                       pytest.approx(200e-6))]
    assert tr.window_s() == pytest.approx(200e-6)
    assert tr.busy_s() == pytest.approx(70e-6)     # the marks left out
    assert len(tr.device_in_slice()) == 4
    # call 1: its last launch ends at 55; call 2: at 168
    assert trace.enqueue_s(tr) == pytest.approx(55e-6 + 68e-6)
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0] == ["k1", pytest.approx(40e-6)]
    idle = dict(bd["idle_gaps"])
    assert idle["host, then k1"] == pytest.approx(40e-6)     # 0..20, 160..180
    assert idle["host, then k2"] == pytest.approx(20e-6)
    assert idle["host in cudaStreamSynchronize"] == pytest.approx(60e-6)
    assert sum(idle.values()) == pytest.approx(130e-6)
