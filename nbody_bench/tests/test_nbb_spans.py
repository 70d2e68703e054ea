"""The program-mark readers (``nbody_bench/spans.py``) on synthetic traces,
phases and call records."""

from types import SimpleNamespace

import pytest

from nbody_bench import spans, stats
from nbody_bench.trace import Span, Trace

UNIT = spans.TRACE_BASE_S * 1_000_000_000
BASE = 227 * UNIT          # a trace base: a multiple of Kineto's unit


def _ns(t):
    """Trace seconds as the program's Unix ns."""
    return BASE + round(t * 1e9)


class _Program:
    """Stands in for tpu_nbody_torch.profiling."""

    def __init__(self, phases=(), records=()):
        self._phases = [(n, _ns(a), _ns(b)) for n, a, b in phases]
        self._records = list(records)

    def phases(self):
        return list(self._phases)

    def call_records(self):
        return list(self._records)


def _rec(t_enter, s0, s1, steps=20, profiled=False):
    return SimpleNamespace(t_enter=t_enter, t_sync_start=s0, t_sync_end=s1,
                           steps=steps, rounds=0, profiled=profiled)


def _ctx(tr=None, calls=0, slice_calls=2, steps=20):
    return SimpleNamespace(trace=tr, window=SimpleNamespace(
        calls=calls, slice_calls=slice_calls, steps_per_call=steps))


def _use(monkeypatch, program):
    monkeypatch.setattr(spans, "_profiling", lambda: program)


def test_the_clock_rule_is_the_programs(monkeypatch):
    from tpu_nbody_torch import profiling

    t = BASE + 123_456_789_012
    assert spans.trace_s(t) == pytest.approx(123.456789012, abs=1e-12)
    assert spans.trace_s(t) == pytest.approx(profiling.trace_us(t) * 1e-6,
                                             abs=1e-12)
    assert profiling.trace_base_ns(t) == BASE
    _use(monkeypatch, _Program([("b", 2.0, 3.0), ("a", 1.0, 2.0)]))
    assert [p[0] for p in spans.program_phases()] == ["a", "b"]


def test_an_older_program_reads_none(monkeypatch):
    _use(monkeypatch, None)
    tr = Trace([Span("k", 0.0, 1.0)], [Span("cudaLaunchKernel", 0, 0.1)],
               [], [Span("call", 0.0, 2.0)], 0.0, 2.0)
    assert spans.program_phases() is None
    assert spans.window_calls(_ctx(tr, calls=3)) is None
    assert spans.idle_ms(_ctx(tr), ("engine",), 40) is None
    assert spans.device_ms_per_pass(_ctx(tr), "tree") is None


def test_the_window_calls_are_its_last_unprofiled_records(monkeypatch):
    recs = [_rec(0, 5, 6, steps=2)]                  # set-up
    recs += [_rec(10 * i, 10 * i + 3, 10 * i + 4, profiled=i in (2, 3))
             for i in range(1, 7)]
    _use(monkeypatch, _Program(records=recs))
    got = spans.window_calls(_ctx(calls=5))
    assert [r.t_enter for r in got] == [40, 50, 60]
    assert [r.t_enter for r in spans.window_calls(_ctx(calls=6))] == [
        10, 40, 50, 60]
    assert spans.window_calls(_ctx(calls=9)) is None     # records lost
    assert spans.window_calls(_ctx(calls=0)) is None
    # 3 x 3 ns of enqueue and 3 x 1 of wait over 60 steps, in ms
    assert spans.host_ms_per_step(got, "t_enter", "t_sync_start") == \
        pytest.approx(9e-6 / 60)
    assert spans.host_ms_per_step(got, "t_sync_start", "t_sync_end") == \
        pytest.approx(3e-6 / 60)
    assert spans.host_ms_per_step([], "t_enter", "t_sync_start") is None


def _idle_case():
    # device busy [0, 1], [2, 3], [3.5, 6], [6.25, 7]; slice [0, 8]
    dev = [Span("k", a, b) for a, b in
           ((0.0, 1.0), (2.0, 3.0), (3.5, 6.0), (6.25, 7.0))]
    tr = Trace(dev, [], [], [Span("call", 0.0, 7.5)], 0.0, 8.0)
    phases = [("sort", 0.0, 1.75), ("fft", 1.75, 3.125),  # gap 1-2: sort
              ("band", 3.125, 6.5),                    # gaps 3-3.5, 6-6.25
              ("mystery", 6.5, 7.25)]                  # gap 7-8: middle 7.5
    return tr, phases


def test_the_idle_split_adds_up_to_the_slice_idle_time():
    tr, phases = _idle_case()
    split = spans.idle_by_layer(tr, phases)
    assert split["engine"] == 1.0             # the gap (1, 2): middle 1.5
    assert split["short range"] == 0.5 + 0.25
    assert split[None] == 1.0                 # (7, 8): middle 7.5, no phase
    assert "long range" not in split
    idle = tr.window_s() - tr.busy_s()
    assert sum(split.values()) == idle == 2.75
    gaps = stats.gaps([(s.start, s.end) for s in tr.device], tr.t0, tr.t1)
    assert sum(b - a for a, b in gaps) == idle


def test_idle_ms_reads_the_layers_asked_for(monkeypatch):
    tr, phases = _idle_case()
    _use(monkeypatch, _Program(phases))
    ctx = _ctx(tr, slice_calls=2, steps=20)
    assert spans.idle_ms(ctx, ("engine",), spans.steps_in_slice(ctx)) == \
        pytest.approx(1e3 * 1.0 / 40)
    assert spans.idle_ms(ctx, ("short range", "engine"), 2) == \
        pytest.approx(1e3 * 1.75 / 2)
    assert spans.idle_ms(ctx, ("render",), 2) == 0.0
    # a name outside the layers keeps its own key: in no layer read here
    assert spans.idle_by_layer(tr, phases).get("mystery") is None


def _launch_case():
    """Two traced calls of three launches each, and one harness launch
    between them, all on one stream."""
    launch = [Span("cudaLaunchKernel", 0.10, 0.11),
              Span("cudaMemsetAsync", 0.20, 0.21),
              Span("cuLaunchKernel", 0.30, 0.31),
              Span("cudaLaunchKernel", 0.50, 0.51),        # the harness's
              Span("cudaLaunchKernel", 0.60, 0.62),
              Span("cuLaunchKernel", 0.605, 0.615),        # inside: same
              Span("cudaMemcpyAsync", 0.70, 0.71),
              Span("cudaLaunchKernel", 0.80, 0.81)]
    dev = [Span("tree_kernel", 0.12, 0.22),
           Span("Memset (Device)", 0.22, 0.24),
           Span("regular_fft", 0.32, 0.40),
           Span("reduce", 0.52, 0.53),
           Span("assemble_kernel", 0.63, 0.66),
           Span("Memcpy DtoH (Device -> Pageable)", 0.72, 0.73),
           Span("evaluate_kernel", 0.82, 0.92)]
    marks = [Span("call", 0.05, 0.35), Span("call", 0.55, 0.85)]
    return Trace(dev, launch, launch, marks, 0.05, 0.95)


def test_launches_pair_with_device_operations_in_order():
    tr = _launch_case()
    pairs = spans.paired(tr)
    assert [(l.name, d.name) for l, d in pairs] == [
        ("cudaLaunchKernel", "tree_kernel"),
        ("cudaMemsetAsync", "Memset (Device)"),
        ("cuLaunchKernel", "regular_fft"),
        ("cudaLaunchKernel", "assemble_kernel"),
        ("cudaMemcpyAsync", "Memcpy DtoH (Device -> Pageable)"),
        ("cudaLaunchKernel", "evaluate_kernel")]
    phases = [("build", 0.05, 0.25), ("groups", 0.25, 0.35),
              ("assemble", 0.55, 0.65), ("kick", 0.65, 0.75)]
    split = spans.device_by_layer(tr, phases)
    assert split["tree"] == pytest.approx(0.12)       # kernel and memset
    assert split["traverse"] == pytest.approx(0.08)
    assert split["evaluate"] == pytest.approx(0.03)
    assert split["engine"] == pytest.approx(0.01)
    assert split[None] == pytest.approx(0.10)         # after the phases
    assert spans.count_in_slice(tr, phases, "build") == 1


@pytest.mark.parametrize("fault", ["extra_op", "lost_op", "kind",
                                   "lost_launch"])
def test_a_count_mismatch_of_any_kind_reads_none(fault):
    tr = _launch_case()
    dev, launches = list(tr.device), list(tr.launches)
    if fault == "extra_op":
        dev.append(Span("late", 0.95, 0.96))
    elif fault == "lost_op":
        dev.pop(3)
    elif fault == "kind":
        dev[1] = Span("kernel_not_memset", 0.22, 0.24)
    else:
        launches.pop(0)
    bad = tr._replace(device=dev, launches=launches)
    assert spans.paired(bad) is None
    assert spans.device_by_layer(bad, [("build", 0.0, 1.0)]) is None


def test_operations_whose_recorded_starts_cross_keep_their_launches():
    tr = _launch_case()
    dev = list(tr.device)
    # the memset's recorded start lands before the kernel it follows
    dev[0], dev[1] = Span("Memset (Device)", 0.118, 0.119), \
        Span("tree_kernel", 0.12, 0.22)
    pairs = spans.paired(tr._replace(device=dev))
    assert [(l.name, d.name) for l, d in pairs[:2]] == [
        ("cudaLaunchKernel", "tree_kernel"),
        ("cudaMemsetAsync", "Memset (Device)")]


def test_device_ms_per_pass(monkeypatch):
    tr = _launch_case()
    _use(monkeypatch, _Program([("build", 0.05, 0.25),
                                ("groups", 0.25, 0.35),
                                ("build", 0.55, 0.65),
                                ("evaluate", 0.65, 0.85)]))
    ctx = _ctx(tr)
    assert spans.device_ms_per_pass(ctx, "tree") == pytest.approx(
        1e3 * (0.12 + 0.03) / 2)
    assert spans.device_ms_per_pass(ctx, "evaluate") == pytest.approx(
        1e3 * (0.01 + 0.10) / 2)
    _use(monkeypatch, _Program([("groups", 0.25, 0.35)]))
    assert spans.device_ms_per_pass(ctx, "traverse") is None  # no build
