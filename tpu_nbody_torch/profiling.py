"""Tracing / profiling helpers (port of tpu_nbody.profiling).

The reference's only performance instrumentation is a wall-clock FPS counter
(``NBodyPanel.kt:361-368``, ``gpu/GPU.kt:721-726``). Here:

* :func:`sync` — wait for the device work that feeds a tensor.
* :class:`PhaseTimer` — named host-side phase timing, synchronising with
  the device at each phase's exit (PyTorch returns before the card
  finishes, so a host clock without that measures the enqueue).
* :class:`Meter` — the FPS counter generalized to body-updates/sec.
* :func:`trace` — context manager around ``torch.profiler`` that writes a
  Chrome trace, with the program's phases, into a directory;
  :func:`trace_device_spans` reads the device operations back from it,
  :func:`busy_us` their busy time in a window, and :func:`device_ops`
  names the operations one call enqueues.
* :class:`Recorder` — the port's phase marks on the profiler's clock and a
  record of every ``Engine.step`` call (:data:`RECORDER`,
  :func:`set_recording`, :func:`phases`, :func:`call_records`,
  :func:`trace_us`); with ``events=True`` device time by phase.
* :func:`timed_ms` — device time of one call by CUDA events.
* :func:`bounds` — the least time the card could take for a piece of work
  (:data:`PEAK_FLOPS`, :data:`PEAK_BYTES`), and :func:`card_info`, the
  card's name and power limit to print beside every time.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import tempfile
import time
from collections import defaultdict, deque
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

# Published peaks of one NVIDIA H100 SXM at its full 700 W power limit
# (NVIDIA's data sheet): a card set below it runs slower under load.
PEAK_FLOPS = 67e12      # float32 outside the tensor cores, flop/s
PEAK_BYTES = 3.35e12    # HBM3, bytes/s
RSQRT_PER_CLK_SM = 16   # rsqrt results a clock per SM (the SFU rate)
LEAD_CYCLES = 4_000_000  # device_ms's spin kernel, about 2 ms on an H100
# Chrome-trace categories of the card's own operations
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        for item in x:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def sync(x) -> None:
    """Wait until the device work feeding ``x`` (a tensor, or a tuple, list,
    dict or state of them) is done: ``torch.cuda.synchronize`` on the first
    tensor's device. A CPU tensor is complete when it exists."""
    t = _first_tensor(x)
    if t is None:
        raise TypeError(f"sync: no tensor in {type(x).__name__}")
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class PhaseTimer:
    """Accumulates wall time per named phase, with device sync at exits.

    >>> pt = PhaseTimer()
    >>> with pt("force") as h:
    ...     h["result"] = accel(...)   # sync'd on exit
    >>> pt.report()
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str, result=None):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            out = holder.get("result", result)
            if out is not None:
                sync(out)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {tot * 1e3:.1f} ms total, "
                         f"{tot / n * 1e3:.2f} ms/call x{n}")
        return "\n".join(lines)


class Meter:
    """Throughput meter: updates/sec over a sliding 1 s window (HUD FPS)."""

    def __init__(self):
        self._count = 0
        self._t0 = time.time()
        self.rate = 0.0

    def tick(self, units: int = 1) -> float:
        self._count += units
        now = time.time()
        if now - self._t0 >= 1.0:
            self.rate = self._count / (now - self._t0)
            self._count = 0
            self._t0 = now
        return self.rate


# the Chrome-trace thread that :func:`trace` writes the program's phases on
PHASE_TID = 1_000_000_000


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Profile the block with ``torch.profiler`` and write ``trace.json``,
    a Chrome trace, into ``log_dir``: host and card activity for a CUDA
    ``device`` (raising when there is no card), host activity alone for
    ``device="cpu"``, and the program's phases (the process-wide
    :class:`Recorder`, switched on for the block) as ``X`` events of
    category ``program`` on a thread of their own, on the same clock.
    Yields the profiler, whose ``key_averages()`` are readable after the
    block. A failure of the profiler or of the block propagates: nothing
    is swallowed."""
    from torch.profiler import ProfilerActivity, profile

    from .state import check_device

    activities = [ProfilerActivity.CPU]
    if check_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prev = set_recording(True)
    t0 = time.time_ns()
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        set_recording(prev)
    t1 = time.time_ns()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _write_phases(path, [p for p in phases() if p[1] >= t0 and p[2] <= t1])


def _write_phases(path: str, spans) -> None:
    """Add ``spans`` ((name, start_ns, end_ns)) to the Chrome trace at
    ``path`` as ``X`` events of category ``program``."""
    with open(path) as f:
        data = json.load(f)
    base = data.get("baseTimeNanoseconds")
    pid = os.getpid()
    events = data["traceEvents"]
    events.append(dict(ph="M", name="thread_name", pid=pid, tid=PHASE_TID,
                       args=dict(name="program phases")))
    for name, a, b in spans:
        events.append(dict(ph="X", cat="program", name=name, pid=pid,
                           tid=PHASE_TID, ts=trace_us(a, base),
                           dur=(b - a) * 1e-3))
    with open(path, "w") as f:
        json.dump(data, f)


def trace_device_spans(path: str) -> list[dict]:
    """The device operations of a Chrome trace that :func:`trace` wrote
    (categories :data:`DEVICE_CATS`: kernels, memsets, copies), each as
    ``name``, ``cat``, ``ts`` and ``dur`` in microseconds, by start."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [dict(name=e["name"], cat=e["cat"], ts=float(e["ts"]),
                  dur=float(e.get("dur", 0.0)))
             for e in events
             if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    return sorted(spans, key=lambda e: e["ts"])


def busy_us(spans, t0: float = -math.inf, t1: float = math.inf) -> float:
    """Microseconds in [t0, t1] during which at least one of ``spans``
    (:func:`trace_device_spans`) ran: the union of their intervals."""
    busy, end = 0.0, -math.inf
    for e in sorted(spans, key=lambda e: e["ts"]):
        a, b = max(e["ts"], t0, end), min(e["ts"] + e["dur"], t1)
        if b > a:
            busy += b - a
        end = max(end, min(e["ts"] + e["dur"], t1))
    return busy


# host seconds a trace of device_ops (and chip_smoke's step trace) waits
# before and after its call. The profiler drops a device operation whose
# start, moved to the host's clock, falls outside the trace's window
# ("Out-of-range" in its log); on the card, after the first seconds of
# load, that move went wrong by more than half a second, and a window
# padded by this much kept every operation.
TRACE_PAD_S = 2.0


def device_ops(fn, device="cuda") -> list[str]:
    """Names of the device operations (kernels, memsets, copies) that one
    call of ``fn()`` enqueues, in the order they ran, from a
    ``torch.profiler`` trace of that call after one untraced call; the
    trace waits :data:`TRACE_PAD_S` before and after the call. A profiler
    session leaves the host's later launches in the process slower (on the
    card a pm step read slower after one), so time nothing after it."""
    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        with trace(d, device):
            time.sleep(TRACE_PAD_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
        return [e["name"] for e in
                trace_device_spans(os.path.join(d, "trace.json"))]


def timed_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` on the current
    stream, after ``warmup`` calls; each timing waits for its end event."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return 0.5 * (times[(reps - 1) // 2] + times[reps // 2])


def device_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` with the host's
    enqueue hidden: each timing starts behind a spin kernel of
    :data:`LEAD_CYCLES` clocks (``torch.cuda._sleep``),
    so the events bracket the device work alone. :func:`timed_ms` times
    one call on an idle card, where a call shorter than the host's enqueue
    of it reads the host."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(LEAD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return 0.5 * (times[(reps - 1) // 2] + times[reps // 2])


class CallRecord(NamedTuple):
    """One ``Engine.step`` call on the recorder's clock (ns,
    ``time.time_ns``): its entry, the host's wait in its stats read (the
    last retune round's, :meth:`Engine._record_stats`), its steps, its
    retune redos and whether the recorder was active during it."""
    t_enter: int
    t_sync_start: int
    t_sync_end: int
    steps: int
    rounds: int
    profiled: bool


# the recorder's bounds: phase marks, and call records (a 20 s window of
# the frames cell makes about 360 calls)
MARKS_KEPT = 1 << 18
CALLS_KEPT = 1 << 14
# Kineto rounds a Chrome trace's ``baseTimeNanoseconds`` down to a
# multiple of this many seconds of Unix time; host events are written as
# microseconds after it
TRACE_BASE_S = 7_889_238


class Recorder:
    """Phase marks and call records: the port's one tracing system.

    Calling the recorder, ``rec(name)``, is the ``probe(name)`` protocol
    every phase site reports by: a mark ``(name, t_ns)`` at the end of a
    phase, on the host clock that ``torch.profiler`` writes into its
    Chrome trace (:func:`trace_us`). A call begins with a ``"start"``
    mark; each later mark ends a phase that runs from the previous mark
    of its call (:meth:`phases`), so a call's phases are contiguous.
    Both buffers are bounded (the oldest entries go).

    :data:`RECORDER` is the process-wide one: ``Engine.step``,
    ``render_frame`` and ``to_uint8`` ask it once a call for a probe
    (:meth:`call_probe`), which is None unless it is active: switched on
    by :func:`set_recording` or while a ``torch.profiler`` session runs.
    ``Engine.step`` also keeps a :class:`CallRecord` of every call,
    active or not.

    ``events=True`` also records a CUDA event at each mark, and
    :meth:`ms` gives the device milliseconds spent in each phase name: the
    device-time clock of ``bench`` and ``chip_smoke`` (a recorder of their
    own, never the process-wide one). A probe with a ``pairs`` method
    (``bench._PairClock``) also gets a Barnes–Hut pass's pair counts;
    the recorder has none, so tracing never switches a kernel to its
    counting variant."""

    def __init__(self, events: bool = False, marks: int = MARKS_KEPT,
                 calls: int = CALLS_KEPT):
        self.events = events
        self.on = False
        self.marks = deque(maxlen=marks)
        self.device_events = deque(maxlen=marks)
        self.calls = deque(maxlen=calls)

    def __call__(self, name: str) -> None:
        self.marks.append((name, time.time_ns()))
        if self.events:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.device_events.append(ev)

    def active(self) -> bool:
        return self.on or _autograd_profiler._is_profiler_enabled

    def call_probe(self):
        """The probe of one call: this recorder, after a ``"start"``
        mark, while it is active; else None."""
        if not self.active():
            return None
        self("start")
        return self

    def record_call(self, t_enter: int, syncs, steps: int,
                    profiled: bool) -> None:
        """Keep a call's record; ``syncs`` are the (start, end) of each
        retune round's stats read."""
        s0, s1 = syncs[-1]
        self.calls.append(CallRecord(t_enter, s0, s1, steps,
                                     len(syncs) - 1, profiled))

    def phases(self) -> list:
        """(name, start_ns, end_ns) of every phase in the buffer."""
        out, prev = [], None
        for name, t in self.marks:
            if name == "start":
                prev = t
                continue
            if prev is not None:
                out.append((name, prev, t))
            prev = t
        return out

    def ms(self) -> dict:
        """Device milliseconds spent in each phase name, summed
        (``events=True``): from each mark's CUDA event to the next."""
        evs = list(self.device_events)
        evs[-1].synchronize()
        names = [name for name, _ in self.marks]
        out = {}
        for a, b, name in zip(evs, evs[1:], names[1:]):
            if name != "start":
                out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out

    def clear(self) -> None:
        self.marks.clear()
        self.device_events.clear()
        self.calls.clear()


RECORDER = Recorder()


def set_recording(on: bool) -> bool:
    """Switch the process-wide recorder's phase marks on or off (they are
    also on while a ``torch.profiler`` session runs); returns the previous
    setting. Call records are kept either way."""
    prev, RECORDER.on = RECORDER.on, bool(on)
    return prev


def phases() -> list:
    """(name, start_ns, end_ns) of the process-wide recorder's phases."""
    return RECORDER.phases()


def call_records() -> list:
    """The process-wide recorder's :class:`CallRecord` list, oldest
    first."""
    return list(RECORDER.calls)


def trace_base_ns(t_ns: int) -> int:
    """The ``baseTimeNanoseconds`` of a Chrome trace written at ``t_ns``
    (Unix ns): Kineto's rule, rounded down to :data:`TRACE_BASE_S`."""
    s = TRACE_BASE_S * 1_000_000_000
    return t_ns // s * s


def trace_us(t_ns: int, base_ns: int | None = None) -> float:
    """A recorder time as a Chrome trace's ``ts`` (microseconds after the
    trace's base, by default :func:`trace_base_ns` of ``t_ns``)."""
    base = trace_base_ns(t_ns) if base_ns is None else base_ns
    return (t_ns - base) * 1e-3


def bounds(work: dict, ms: float, n_sm: int | None = None,
           max_clock_hz: float | None = None) -> dict:
    """The least time the card could take for ``work`` (``flops`` and
    ``bytes``: each input read once, each output written once): the larger
    of flops / :data:`PEAK_FLOPS` and bytes / :data:`PEAK_BYTES`, as
    ``bound_ms``, with ``bound_by`` ("operations" or "bytes") and the
    share of it reached in ``ms`` (``pct_of_bound``). Given the SM count
    and the highest SM clock, also ``rsqrt_floor_ms``: ``work["pairs"]``
    over the rsqrt unit's rate."""
    t_ops = work["flops"] / PEAK_FLOPS
    t_bytes = work["bytes"] / PEAK_BYTES
    bound_ms = 1e3 * max(t_ops, t_bytes)
    out = dict(bound_ms=bound_ms,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               pct_of_bound=100.0 * bound_ms / ms)
    if n_sm is not None and max_clock_hz is not None:
        out["rsqrt_floor_ms"] = 1e3 * work["pairs"] / (
            RSQRT_PER_CLK_SM * n_sm * max_clock_hz)
    return out


def card_info(device=None) -> dict:
    """``name`` (``torch.cuda.get_device_name``) and ``power_limit`` of the
    card, the limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` reports it, and that line itself as ``smi``.
    Without ``nvidia-smi`` (or when it fails) ``smi`` is None and the limit
    reads "power limit not read": no value is made up."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    name = torch.cuda.get_device_name(dev)
    smi = None
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        lines = res.stdout.strip().splitlines()
        if res.returncode == 0 and lines:
            smi = lines[min(dev.index or 0, len(lines) - 1)].strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    limit = smi.rsplit(",", 1)[-1].strip() if smi and "," in smi else None
    return dict(name=name, smi=smi,
                power_limit=limit or "power limit not read")
