"""Run one cell of the benchmark once and print its result.

    python3 -m nbody_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start): the imports,
the CUDA context, loading or building the program's kernel library, the
configuration's scene made on the card from ``--seed``
(:mod:`nbody_bench.scene`), and the warm-up: a short ``Engine.step``
from the scene (the check's start, kept), one call of the cell's loop,
whose state is kept as a device copy, the segment's start; then from
there the traffic's ``warm_calls``
calls, and more while a call still grows a cap (the engine's retune),
which load every kernel, cuFFT plan and shape the window uses; then the
segment's start put back.

The window then runs the cell's loop (``loops/<loop>.py``) back to back
for ``--seconds``: it ends when the first call to finish after that
returns, and the card is synchronised before its clock stops. Every
``segment_steps`` steps the loop puts the segment's start back (a device
copy, between calls, counted in the window), so every run and every
build measures the same stretch of the collision. With ``--trace 1`` a
slice of whole calls near the window's start is profiled.

After the window: the check for JAX in ``sys.modules``, the memory peak,
the program freed, the metrics (``metrics/<name>.py``), then the
correctness check (:mod:`nbody_bench.check`). Standard error gets ``#``
lines (the card and its power limit, the counters, each check) and ends
with each compared number beside its limit; standard output ends with one
JSON line.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from contextlib import contextmanager, nullcontext  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import torch  # noqa: E402

from nbody_bench import check, manifest, scene, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_nbody")


def log(*parts):
    print("#", *parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run may not load,
    compared whole (``tpu_nbody_torch`` is not ``tpu_nbody``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def card_line(device) -> str:
    name = torch.cuda.get_device_name(device)
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        smi = res.stdout.strip().splitlines()
        limit = smi[0].rsplit(",", 1)[-1].strip() if smi else "not read"
    except (OSError, subprocess.TimeoutExpired):
        limit = "not read"
    return f"card {name}, power limit {limit}"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Events:
    """CUDA events around named parts of the traced calls."""

    def __init__(self, on: bool, device):
        self.on = on and device.type == "cuda"
        self.pairs = {}

    @contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        yield
        b.record()
        self.pairs.setdefault(name, []).append((a, b))

    def ms(self, name: str) -> list:
        return [a.elapsed_time(b) for a, b in self.pairs.get(name, [])]


def set_up(cell, seed: int, device, make_system):
    """Build the system, load the scene, warm up. Returns (system, the
    kept start call, the segment's start, the warm-up's calls)."""
    sysm = make_system(cell.config, device, cell.workload)
    pos, vel, mass = scene.make(cell.config, seed, device)
    sysm.load(pos, vel, mass)
    before = check.copy_state(sysm.eng.state)
    n = int(cell.workload["check"]["start_steps"])
    sysm.eng.step(n)
    first = check.Kept(-1, n, before, check.copy_state(sysm.eng.state), None)
    k = cell.loop.steps(cell.traffic)
    cell.loop.call(sysm.eng, cell.traffic, nullcontext)
    start = check.copy_state(sysm.eng.state)
    calls, most = 0, int(cell.traffic["segment_steps"]) // k
    while calls < most:
        tuning = sysm.tuning()
        cell.loop.call(sysm.eng, cell.traffic, nullcontext)
        calls += 1
        if calls >= int(cell.traffic["warm_calls"]) and \
                sysm.tuning() == tuning:
            break
    sysm.eng.state = restored(sysm.eng.state, start)
    _sync(device)
    return sysm, first, start, calls


def restored(state, start):
    """A fresh device copy of the segment's start as the engine's state."""
    pos, vel, mass, alive = (t.clone() for t in start)
    return state._replace(pos=pos, vel=vel, mass=mass, alive=alive)


def window(cell, sysm, start, seconds: float, traced: bool, seed: int,
           device):
    """Run the loop for ``seconds``; returns the window's record."""
    eng, loop, traffic = sysm.eng, cell.loop, cell.traffic
    k = loop.steps(traffic)
    segment = int(traffic["segment_steps"])
    sample = check.Reservoir(int(cell.workload["check"]["calls"]), seed)
    events = Events(traced, device)
    upd = torch.zeros((), dtype=torch.int64, device=device)
    rec = SimpleNamespace(durations=[], attempted=0, failed=0, retunes=0,
                          restores=0, profiler=None, trace=None,
                          slice_state=None, slice_calls=0, events=events)
    done = 0

    def one(probe=nullcontext, marked=nullcontext):
        nonlocal done, upd
        if done + k > segment:
            eng.state = restored(eng.state, start)
            done = 0
            rec.restores += 1
        slot = sample.slot()
        before = check.copy_state(eng.state) if slot is not None else None
        tuning = sysm.tuning()
        upd = upd + eng.state.alive.sum() * k
        rec.attempted += 1
        t = time.perf_counter()
        try:
            with marked():
                out = loop.call(eng, traffic, probe)
        except Exception:
            rec.failed += 1
            traceback.print_exc(file=sys.stderr)
            return
        rec.durations.append(time.perf_counter() - t)
        done += k
        if sysm.tuning() != tuning:
            rec.retunes += 1
        if slot is not None:
            sample.kept[slot] = check.Kept(rec.attempted - 1, k, before,
                                           check.copy_state(eng.state), out)

    t0 = time.perf_counter()
    while True:
        if traced and rec.attempted == 1:
            # the slice; on the CPU (the tests) it runs unprofiled
            rec.slice_state = check.copy_state(eng.state)
            cuda = device.type == "cuda"
            with (trace.profiled(lambda: _sync(device)) if cuda
                  else nullcontext([])) as got:
                for _ in range(int(traffic["trace_calls"])):
                    one(events, trace.mark if cuda else nullcontext)
                    rec.slice_calls += 1
            rec.profiler = got[0] if got else None
        else:
            one()
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    rec.seconds = time.perf_counter() - t0
    rec.body_updates = int(upd)
    rec.calls = len(rec.durations)
    rec.steps_per_call = k
    rec.kept = sample.kept
    return rec


def read_metrics(cell, ctx, wanted) -> dict:
    out = {}
    for m in wanted:
        value = cell.reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(workload: str, seed: int, seconds: float, traced: bool,
        device="cuda", make_system=None, bench=None,
        pkg=manifest.PKG) -> dict:
    """One run of ``workload``; returns the result line as a dict (the
    CLI prints it). ``make_system`` builds the system under test (default:
    the program, :class:`nbody_bench.system.Program`); the tests and the
    control put another in its place, and the tests read the cell's files
    from a copy of this package at ``pkg``."""
    from nbody_bench.system import Program

    cell = manifest.Cell(workload, bench, pkg)
    device = torch.device(device)
    sysm, first, start, warm = set_up(cell, seed, device,
                                      make_system or Program)
    setup_s = time.perf_counter() - T_PROCESS
    log(f"set-up {setup_s:.3f} s, {warm} warm-up calls; {sysm.counters()}")
    rec = window(cell, sysm, start, seconds, traced, seed, device)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules loaded that the run may not load: "
                         f"{found}")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    log(f"window {rec.seconds:.3f} s: {rec.calls} calls of "
        f"{rec.steps_per_call} steps, {rec.attempted} attempted, "
        f"{rec.failed} failed, {rec.restores} segment restores, "
        f"{rec.retunes} retunes; {sysm.counters()}")
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    if device.type == "cuda":
        log(card_line(device))
    render_ms = rec.events.ms("render")
    if rec.profiler is not None:
        rec.trace = trace.read(rec.profiler)
        rec.profiler = None
    del sysm
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ctx = SimpleNamespace(cell=cell, config=cell.config,
                          traffic=cell.traffic, window=rec, setup_s=setup_s,
                          trace=rec.trace, slice_state=rec.slice_state,
                          render_ms=render_ms)
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = read_metrics(cell, ctx, wanted)
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": kind, "count": cell.chips,
                "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": rec.attempted,
              "failed": rec.failed, "metrics": metrics, "device": dev_info}
    if traced and rec.trace is not None:
        dev_info["busy_s"] = rec.trace.busy_s()
        dev_info["window_s"] = rec.trace.window_s()
        result["breakdown"] = trace.breakdown(rec.trace)
    render_cfg = {key: cell.traffic[key] for key in check.RENDER_KEYS
                  if key in cell.traffic}
    kept = [first] + [kk for kk in rec.kept if kk is not None]
    t = time.perf_counter()
    ok, numbers, details = check.judge(kept, cell.config, cell.workload,
                                       render_cfg, seed, device)
    for d in details:
        log("check", json.dumps(d))
    log(f"reference check {time.perf_counter() - t:.3f} s")
    result["correct"] = bool(ok and rec.failed == 0)
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in numbers.items()}
    for name, (v, lim) in numbers.items():
        print(f"{name} {v!r} limit {lim!r}", file=sys.stderr)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest.benchmark()
    chips = next((int(w["chips"]) for w in bench["workloads"]
                  if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"nbody_bench: needs {chips} CUDA device(s); "
              f"cuda available={torch.cuda.is_available()}, count="
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; the benchmark never runs on the CPU", file=sys.stderr)
        return 2
    import tpu_nbody_torch  # noqa: F401  (fails without the program)

    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 bench=bench)
    found = forbidden_modules()
    if found:
        print(f"nbody_bench: loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
