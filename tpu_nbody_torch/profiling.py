"""Tracing / profiling helpers (port of tpu_nbody.profiling).

The reference's only performance instrumentation is a wall-clock FPS counter
(``NBodyPanel.kt:361-368``, ``gpu/GPU.kt:721-726``). Here:

* :func:`sync` — wait for the device work that feeds a tensor.
* :class:`PhaseTimer` — named host-side phase timing, synchronising with
  the device at each phase's exit (PyTorch returns before the card
  finishes, so a host clock without that measures the enqueue).
* :class:`Meter` — the FPS counter generalized to body-updates/sec.
* :func:`trace` — context manager around ``torch.profiler`` that writes a
  Chrome trace into a directory; :func:`trace_device_spans` reads the
  device operations back from it, :func:`busy_us` their busy time in a
  window, and :func:`device_ops` names the operations one call enqueues.
* :func:`timed_ms` and :class:`EventClock` — device time by CUDA events: of
  one call, and of the phases of one run.
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
from collections import defaultdict

import torch

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


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Profile the block with ``torch.profiler`` and write ``trace.json``,
    a Chrome trace, into ``log_dir``: host and card activity for a CUDA
    ``device`` (raising when there is no card), host activity alone for
    ``device="cpu"``. Yields the profiler, whose ``key_averages()`` are
    readable after the block. A failure of the profiler or of the block
    propagates: nothing is swallowed."""
    from torch.profiler import ProfilerActivity, profile

    from .state import check_device

    activities = [ProfilerActivity.CPU]
    if check_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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


class EventClock:
    """Device time by phase: ``clock(name)`` records a CUDA event that ends
    a phase (``"start"`` marks the beginning of the timed work), and
    ``ms()`` gives the milliseconds spent in each name, summed. Usable as
    the ``probe`` of the Barnes–Hut pass."""

    def __init__(self):
        self.marks = []

    def __call__(self, name: str):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev))

    def ms(self) -> dict:
        self.marks[-1][1].synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            if name != "start":
                out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


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
