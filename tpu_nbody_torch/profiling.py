"""Tracing / profiling helpers (port of tpu_nbody.profiling).

The reference's only performance instrumentation is a wall-clock FPS counter
(``NBodyPanel.kt:361-368``, ``gpu/GPU.kt:721-726``). Here:

* :func:`sync` — wait for the device work that feeds a tensor.
* :class:`PhaseTimer` — named host-side phase timing, synchronising with
  the device at each phase's exit (PyTorch returns before the card
  finishes, so a host clock without that measures the enqueue).
* :class:`Meter` — the FPS counter generalized to body-updates/sec.
* :func:`trace` — context manager around ``torch.profiler`` that writes a
  Chrome trace into a directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


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
