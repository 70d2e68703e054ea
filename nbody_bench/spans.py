"""The program's own phase marks and call records, read beside the trace.

``tpu_nbody_torch.profiling`` keeps them: each ``Engine.step`` call's
record (its entry, the start and end of its one host sync, its steps,
retune rounds, and whether the recorder was active), and, while a
``torch.profiler`` session runs, a mark at the end of each phase of the
step, of ``render_frame`` and of ``to_uint8``. A phase runs from the
previous mark of its call to its own. The marks are stamped with the
host clock the profiler writes into its Chrome trace: Unix nanoseconds,
written as microseconds after a base that Kineto rounds down to a
multiple of ``TRACE_BASE_S`` seconds, so :func:`program_phases` puts them
on the axis of :class:`nbody_bench.trace.Trace` with no fitted offset.

A program without these functions (an older build) gives None from every
reader here: the metric is left out of the line, nothing raises.
"""

from __future__ import annotations

import bisect

from nbody_bench import stats

TRACE_BASE_S = 7_889_238

# each phase name of the program, by the layer of PERF.md that owns it
LAYERS = {
    "engine": ("hats", "sort", "kick_drift", "kick", "merge", "resort",
               "unsort", "stats"),
    "long range": ("deposit", "fft", "fd", "interp"),
    "short range": ("band", "select", "rescue"),
    "tree": ("build",),
    "traverse": ("groups", "lists"),
    "evaluate": ("evaluate", "assemble"),
    "render": ("render", "to_uint8"),
}
LAYER_OF = {name: layer for layer, names in LAYERS.items() for name in names}
# the layers of Engine.step's own phases (every one but the render's)
STEP_LAYERS = tuple(layer for layer in LAYERS if layer != "render")


def _profiling():
    """The program's ``profiling`` module, if it keeps marks and call
    records; else None."""
    try:
        from tpu_nbody_torch import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, f) for f in ("phases", "call_records")):
        return None
    return profiling


def trace_s(t_ns: int) -> float:
    """A program time (Unix ns) in seconds on the Chrome trace's axis."""
    unit = TRACE_BASE_S * 1_000_000_000
    return (t_ns - t_ns // unit * unit) * 1e-9


def program_phases():
    """(name, start, end) of the program's phases in trace seconds, by
    start; None where the program keeps none."""
    prof = _profiling()
    if prof is None:
        return None
    return sorted(((name, trace_s(a), trace_s(b))
                   for name, a, b in prof.phases()), key=lambda p: p[1])


def window_calls(ctx):
    """The call records of the window's calls that the profiler did not
    see: the last ``window.calls`` records, less the profiled ones. None
    where the program keeps no records or fewer than the window made."""
    prof = _profiling()
    if prof is None:
        return None
    recs = prof.call_records()
    n = ctx.window.calls
    if n == 0 or len(recs) < n:
        return None
    return [r for r in recs[-n:] if not r.profiled]


def host_ms_per_step(records, begin: str, end: str):
    """Σ(end − begin) of the records' fields, in ms, over Σ steps."""
    if not records:
        return None
    ns = sum(getattr(r, end) - getattr(r, begin) for r in records)
    return 1e-6 * ns / sum(r.steps for r in records)


class _Phases:
    """Finds the phase that holds a time (phases of one process never
    overlap)."""

    def __init__(self, phases):
        self.phases = phases
        self.starts = [p[1] for p in phases]

    def at(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.phases[i][2] >= t:
            return self.phases[i][0]
        return None


def idle_by_layer(tr, phases) -> dict:
    """The device's idle time in the traced slice by the layer of the
    program phase that holds each gap's middle: seconds by layer, a phase
    name outside :data:`LAYERS` under its own name, and the gaps in no
    phase under None. The values add up to the slice's idle time."""
    find = _Phases(phases)
    out = {}
    for a, b in stats.gaps([(s.start, s.end) for s in tr.device], tr.t0,
                           tr.t1):
        name = find.at(0.5 * (a + b))
        key = None if name is None else LAYER_OF.get(name, name)
        out[key] = out.get(key, 0.0) + (b - a)
    return out


def _kind(name: str, launch: bool) -> str:
    """What a runtime call enqueues, or what a device operation is."""
    for word in ("Memset", "Memcpy"):
        if (word in name) if launch else name.startswith(word):
            return word
    return "kernel"


def _outermost(spans) -> list:
    """The spans (by start) that no earlier span holds: a ``cuLaunchKernel``
    made inside a ``cudaLaunchKernel`` is the same launch."""
    out, end = [], -float("inf")
    for s in spans:
        if s.end <= end:
            continue
        out.append(s)
        end = s.end
    return out


def paired(tr):
    """(launch, device operation) of each launch inside a traced call. The
    program runs on one stream, so the k-th launch of a kind (kernel,
    memset, copy) in the trace enqueued the k-th device operation of that
    kind; matching each kind apart keeps two operations of different
    kinds whose recorded starts tie or cross in the same pair. None where
    the trace's launches and device operations differ in number for any
    kind: an operation or a launch is missing, and no call's count can be
    trusted."""
    launches = _outermost(tr.launches)
    ops = {}
    for op in tr.device:
        ops.setdefault(_kind(op.name, False), []).append(op)
    rank, seen = [], {}
    for launch in launches:
        kind = _kind(launch.name, True)
        rank.append((kind, seen.get(kind, 0)))
        seen[kind] = seen.get(kind, 0) + 1
    if seen != {kind: len(v) for kind, v in ops.items()}:
        return None
    starts = [s.start for s in launches]
    out = []
    for m in tr.marks:
        i0 = bisect.bisect_left(starts, m.start)
        i1 = bisect.bisect_right(starts, m.end)
        out += [(launches[i], ops[kind][k])
                for i, (kind, k) in zip(range(i0, i1), rank[i0:i1])]
    return out


def device_by_layer(tr, phases):
    """Device seconds of the operations launched in the traced calls, by
    the layer of the phase that holds each launch's start (None: in no
    phase); None where :func:`paired` finds the counts differ."""
    pairs = paired(tr)
    if pairs is None:
        return None
    find = _Phases(phases)
    out = {}
    for launch, op in pairs:
        name = find.at(launch.start)
        key = None if name is None else LAYER_OF.get(name, name)
        out[key] = out.get(key, 0.0) + (op.end - op.start)
    return out


def count_in_slice(tr, phases, name: str) -> int:
    """Phases called ``name`` that end inside the traced slice."""
    return sum(1 for p in phases if p[0] == name and tr.t0 <= p[2] <= tr.t1)


def _traced(ctx):
    tr = ctx.trace
    if tr is None or not tr.marks or not tr.device_in_slice():
        return None
    phases = program_phases()
    if not phases:
        return None
    return tr, phases


def idle_ms(ctx, layers, per: int):
    """Idle ms of the slice in the phases of ``layers``, over ``per``."""
    got = _traced(ctx)
    if got is None or per <= 0:
        return None
    split = idle_by_layer(*got)
    return 1e3 * sum(split.get(layer, 0.0) for layer in layers) / per


def device_ms_per_pass(ctx, layer: str):
    """Device ms of the operations launched in ``layer``'s phases, per
    tree build (``build`` phase) in the slice."""
    got = _traced(ctx)
    if got is None:
        return None
    tr, phases = got
    passes = count_in_slice(tr, phases, "build")
    split = device_by_layer(tr, phases)
    if split is None or passes == 0:
        return None
    return 1e3 * split.get(layer, 0.0) / passes


def steps_in_slice(ctx) -> int:
    return ctx.window.slice_calls * ctx.window.steps_per_call
