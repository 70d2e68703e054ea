#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tpu_nbody_torch) on one NVIDIA GPU.

    python3 chip_smoke.py    # the full check, one card

Drives the port's paths as a user calls them, at full size, on the two-disk
collision scene at N = 1,000,000 (capacity 2^20, seed 3; n1 = 800,000,
n2 = 200,000):

* pm_main: the P3M solver with kdk_reuse and persistent Hilbert-sorted
  state on the bench configuration of bench.py, Engine.step(20) once to
  warm up and twice timed, then the force error after the run;
* allpairs_engine (path A): solver="allpairs" with kdk_reuse, as
  ``bench.py --solver allpairs`` runs it, step(2) to warm up and step(3)
  timed; then kdk and euler at N = 65,536, step(4) each;
* pm_subcycled (path B): the main path's configuration plus heavy-direct
  F_long (pm_heavy_cap=16) and F_long subcycling (pm_mesh_every=4), run as
  the main path, then the fresh-pass force error;
* pm_knobs (path C): one fresh force pass of the initial scene for each
  remaining P3M knob (heavy-direct, TSC, NGP, interlace, two-tier rescue),
  each with its sampled force error and its time; a 2-step subcycled run
  with extrapolation; the run-compressed deposits against the plain one.

On the way it

1. requires a CUDA card (exits non-zero otherwise) and prints its name and
   power limit as nvidia-smi reports them;
2. builds the hand-written kernels from tpu_nbody_torch/csrc with nvcc and
   prints each kernel's registers, failing on any register spill;
3. holds the band kernel against its plain torch version on the sorted
   scene (S = 128 poly4 and exp4, S = 256 and 1024 poly4, and S = 128 on a
   capacity that is not a multiple of the bodies a CTA covers) and
4. the all-pairs kernel against its plain version (8192 bodies in 2D and
   3D, 4096 targets x 2^20 sources, and the all-pairs engine's 2^20 x 2^20
   on 4096 sampled rows), each within 1e-5 of the largest magnitude,
   timing both with CUDA events (median of 10 timings of one call on an
   idle card, after 2 warm-ups; 5 at the engine's shape), and checks that
   the all-pairs kernel gives the same bits on a second call;
5. sets every launch count to 0 just before each path and reads it just
   after, checking the launches each path must make (one band launch per
   P3M force pass, one all-pairs launch per all-pairs force pass), finite
   state and no growth of n_alive;
6. measures the force error against the exact all-pairs kernel on 4096
   sampled alive bodies (tpu_nbody_torch.accuracy), failing where a mean
   is over its limit.

The kernels line gives, per kernel, ``launches`` (the main path's run: the
three step(20) calls for the band kernel, the force error after them for
the all-pairs kernel) and ``launches_by_path``. Each kernel's bound_ms is
the larger of its flops over the float32 peak and its bytes over the memory
rate (pair_work in its module); rsqrt_floor_ms is its pairs over the rsqrt
unit's rate (16 a clock per SM at the card's highest SM clock), a second
floor beside it.

It prints one JSON line describing the kernels, then, as its last line,
{"ok": true, "device": {...}}. Any failure raises and exits non-zero
without that line. It imports nothing of jax or of tpu_nbody.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

N = 1_000_000       # bodies of the two-disk scene
N_SMALL = 65_536    # bodies of the kdk and euler all-pairs runs
STEPS = 20          # steps per Engine.step call of the P3M paths
TOL = 1e-5          # kernel vs plain: max |diff| <= TOL * max |plain|
ERR_LIMIT = 5e-4    # mean relative force error of P3M vs exact
SAMPLES = 4096      # bodies sampled for the exact force error
PEAK_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores, 700 W
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
RSQRT_PER_CLK_SM = 16
DEVICE = "cuda"     # the card (a CPU rehearsal of the control flow
                    # patches this and the sizes above)
# the bench configuration (bench.py:244-294)
CFG = dict(mesh_level=12, mesh_ny=2048, mesh_split=2.5, mesh_band=128,
           mesh_rescue=8, mesh_chunk=16384, mesh_switch="poly4",
           pm_resort_every=8)
SUBCYCLED = dict(pm_heavy_cap=16, pm_mesh_every=4)
# path C: SimConfig overrides of the main path's configuration, one fresh
# force pass each
KNOBS = {"heavy_direct": dict(pm_heavy_cap=16), "tsc": dict(mesh_order=3),
         "ngp": dict(mesh_order=1), "interlace": dict(mesh_interlace=True),
         "two_tier": dict(mesh_rescue=4, mesh_rescue_hot=16,
                          mesh_rescue_hot_cap=128)}


def _timed_ms(fn, reps=10):
    """Median of ``reps`` CUDA-event timings of ``fn()``, after 2 warm-ups."""
    import torch
    for _ in range(2):
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


def _check_close(name, got, want):
    """Max |got - want|, failing above TOL of max |want| or on non-finite
    values."""
    import torch
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not (err <= TOL * scale and torch.isfinite(got).all()):
        raise AssertionError(f"{name}: disagrees with the plain version: "
                             f"max|diff| {err:.3e} > {TOL} x {scale:.3e}")
    return err, scale


def _compare(name, kernel_fn, plain_fn):
    """Run kernel and plain version once, check agreement, time both."""
    import torch
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    err, scale = _check_close(name, got, want)
    ms = _timed_ms(kernel_fn)
    plain_ms = _timed_ms(plain_fn)
    print(f"{name}: max|diff| {err:.3e} (max|a| {scale:.3e}) kernel "
          f"{ms:.4f} ms plain {plain_ms:.4f} ms", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def _bounds(work, ms, n_sm, max_clock_hz):
    """bound_ms, what bounds it, the share of it reached in ``ms``, and the
    rsqrt unit's floor, for pair_work ``work``."""
    t_ops = work["flops"] / PEAK_FLOPS
    t_bytes = work["bytes"] / PEAK_BYTES
    bound_ms = 1e3 * max(t_ops, t_bytes)
    return dict(bound_ms=bound_ms,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                pct_of_bound=100.0 * bound_ms / ms,
                rsqrt_floor_ms=1e3 * work["pairs"] / (
                    RSQRT_PER_CLK_SM * n_sm * max_clock_hz))


class Paths:
    """Launch counts per path: every count is set to 0 just before a path
    and read just after it."""

    def __init__(self):
        self.counts = {}

    def run(self, path, fn, need=()):
        """Run ``fn()`` as ``path``; fail if a kernel named in ``need`` was
        not launched in it."""
        import torch
        from tpu_nbody_torch.ops import band, forces
        band.LAUNCHES = 0
        forces.LAUNCHES = 0
        out = fn()
        torch.cuda.synchronize()
        self.counts[path] = {"band": band.LAUNCHES,
                             "allpairs": forces.LAUNCHES}
        for name in need:
            if self.counts[path][name] < 1:
                raise AssertionError(f"{path}: the {name} kernel was never "
                                     f"launched")
        return out

    def of(self, kernel):
        return {p: c[kernel] for p, c in self.counts.items()}


def _engine(cfg, params, dev, n, **kw):
    """An Engine on the two-disk scene of ``n`` bodies (seed 3)."""
    from tpu_nbody_torch.engine import Engine
    eng = Engine(cfg, params, seed=3, device=dev, **kw)
    n2 = n // 5
    eng.reset_default_scene(n1=n - n2, n2=n2)
    return eng


def _run_steps(eng, calls, steps, per_call, kernel):
    """``calls`` Engine.step(steps) calls, the first a warm-up; checks
    ``per_call`` launches of ``kernel`` in each, finite state and no growth
    of n_alive. Returns the fastest timed call's seconds and n_alive."""
    import torch
    from tpu_nbody_torch.ops import band, forces
    mod = {"band": band, "allpairs": forces}[kernel]
    n0 = int(eng.state.n_alive())
    times = []
    for rep in range(calls):
        before = mod.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step(steps[rep])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if mod.LAUNCHES - before != per_call(steps[rep]):
            raise AssertionError(
                f"{kernel} kernel launched {mod.LAUNCHES - before} times in "
                f"step({steps[rep]}), expected {per_call(steps[rep])}")
        if rep:
            times.append(dt / steps[rep])
        print(f"  step({steps[rep]}) {'warm-up' if rep == 0 else 'timed'}: "
              f"{dt:.3f} s", flush=True)
    st = eng.state
    n1 = int(st.n_alive())
    if not all(bool(torch.isfinite(x).all()) for x in (st.pos, st.vel,
                                                        st.mass)):
        raise AssertionError("state is not finite after the run")
    if n1 > n0:
        raise AssertionError(f"n_alive grew: {n0} -> {n1}")
    return min(times), n0, n1


def _report_run(name, eng, sec_per_step, n0, n1):
    import torch
    print(f"{name}: {1e3 * sec_per_step:.2f} ms/step, "
          f"{n1 / sec_per_step:.1f} body-updates/s, n_alive {n0} -> {n1}, "
          f"last_rescue_need {eng.last_rescue_need}, last_rescue_hot "
          f"{eng.last_rescue_hot}, last_mesh_oob {eng.last_mesh_oob}, "
          f"last_heavy_need {eng.last_heavy_need}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)


def _force_error(name, st, cfg, params, g, limit=None):
    """The sampled force error of one fresh pass with ``cfg``'s knobs."""
    from tpu_nbody_torch import accuracy
    e = accuracy.sampled_force_error(st, cfg, params, SAMPLES, g)
    print(f"{name}: force error vs exact ({e['samples']} sampled bodies): "
          f"mean {e['mean']:.3e} p50 {e['p50']:.3e} p99 {e['p99']:.3e} max "
          f"{e['max']:.3e} (rescue_need {e['rescue_need']}, rescue_hot "
          f"{e['rescue_hot']})", flush=True)
    if limit is not None and not e["mean"] <= limit:
        raise AssertionError(f"{name}: mean force error {e['mean']:.3e} > "
                             f"{limit:.3e}")
    return e


def _pass_ms(st, cfg, params, dev):
    """CUDA-event time of one fresh pm_accel pass with ``cfg``'s knobs, the
    kernel hats precomputed as the engine precomputes them (median of 3)."""
    from tpu_nbody_torch import engine
    accel = engine.make_pm_accel(cfg, dev)
    kernel = accel.prepare(params)
    return _timed_ms(lambda: accel(st.pos, st.mass, st.alive, params,
                                   kernel=kernel), reps=3)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2

    from tpu_nbody_torch.config import Params, SimConfig
    from tpu_nbody_torch.kernels import _build
    from tpu_nbody_torch.ops import band, forces, mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    max_clock_hz = 1e6 * float(clk.stdout.strip().splitlines()[0])
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"{n_sm} SMs, highest SM clock {max_clock_hz / 1e6:.0f} MHz",
          flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    t_start = time.perf_counter()

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.last_build['seconds']:.1f} s, "
          f"cached={_build.last_build['cached']})", flush=True)
    report = _build.ptxas_report(_build.last_build["log"])
    for k in report:
        print(f"  ptxas: {k['name']}: {k['registers']} registers, "
              f"{k['spill_bytes']} bytes spilled")
    if not report or any(k["spill_bytes"] for k in report):
        raise AssertionError("a kernel spills registers (or ptxas printed "
                             "no report)")

    # -- scene --------------------------------------------------------------
    cap = 1 << (N - 1).bit_length()
    cfg = SimConfig(capacity=cap, **CFG)
    params = Params.default(theta=0.5)
    eng = _engine(cfg, params, dev, N, solver="pm", integrator="kdk_reuse")
    ox, oy = cfg.root_center
    origin = (ox - cfg.root_half, oy - cfg.root_half)
    side = 2.0 * cfg.root_half
    nw, ny, grid, grid_y, h, a, morigin = mesh._pm_geometry(
        origin, side, cfg.mesh_level, cfg.mesh_ny, cfg.mesh_split)
    st0 = eng.state
    spos, smass, _, _ = mesh._hilbert_sort(st0.pos, st0.mass, st0.alive,
                                           origin, side)
    spos, smass = spos.contiguous(), smass.contiguous()
    print(f"scene: N={int(st0.n_alive())} capacity={cap}", flush=True)

    # -- band kernel vs plain ---------------------------------------------
    results = {}
    ragged = N - 1      # not a multiple of the B S = 1024 bodies of a CTA
    for switch, S, n in (("poly4", 128, cap), ("exp4", 128, cap),
                         ("poly4", 256, cap), ("poly4", 1024, cap),
                         ("poly4", 128, ragged)):
        p_, m_ = spos[:n], smass[:n]
        r = _compare(
            f"band {switch} S={S} cap={n}",
            lambda: band.band_short_range(p_, m_, params.soft2, a,
                                          band=S, chunk=cfg.mesh_chunk,
                                          switch=switch),
            lambda: band.band_short_range_ref(p_, m_, params.soft2, a,
                                              band=S, chunk=cfg.mesh_chunk,
                                              switch=switch))
        if (switch, S, n) == (cfg.mesh_switch, cfg.mesh_band, cap):
            plan = band._band_plan(cap, S)
            results["band"] = dict(
                r, **_bounds(band.pair_work(cap, S, switch), r["ms"], n_sm,
                             max_clock_hz),
                plan=dict(T=plan.T, B=plan.B, threads=plan.threads,
                          smem=plan.smem))

    # -- all-pairs kernel vs plain ----------------------------------------
    g = torch.Generator(device=dev).manual_seed(11)
    for dim in (2, 3):
        p = torch.rand((8192, dim), generator=g, device=dev) * 1000.0
        m = torch.rand((8192,), generator=g, device=dev) * 10.0 + 0.1
        _compare(f"allpairs {dim}D 8192 bodies",
                 lambda: forces.accel_allpairs(p, m, params.G, params.soft2),
                 lambda: forces.accel_allpairs_ref(p, m, params.G,
                                                   params.soft2))
    live_mass = torch.where(st0.alive, st0.mass, 0.0)
    tgt = st0.pos[:4096].contiguous()
    r = _compare(
        f"allpairs 2D 4096 targets x {cap} sources",
        lambda: forces.accel_allpairs(st0.pos, live_mass, params.G,
                                      params.soft2, targets=tgt),
        lambda: forces.accel_allpairs_ref(st0.pos, live_mass, params.G,
                                          params.soft2, targets=tgt))
    first = forces.accel_allpairs(st0.pos, live_mass, params.G, params.soft2,
                                  targets=tgt)
    second = forces.accel_allpairs(st0.pos, live_mass, params.G,
                                   params.soft2, targets=tgt)
    if not torch.equal(first, second):
        raise AssertionError("allpairs: two calls on the same inputs differ")
    print("allpairs: two calls give the same bits", flush=True)
    ap_plan = forces._card_plan(4096, cap, 2, dev)
    results["allpairs"] = dict(
        r, **_bounds(forces.pair_work(4096, cap, 2), r["ms"], n_sm,
                     max_clock_hz),
        plan=dict(T=forces.T, blocks=ap_plan.blocks, splits=ap_plan.splits))

    # the all-pairs engine's shape: every body a target (plain version on
    # sampled rows only: all 2^20 rows would take about a minute)
    rows = torch.randperm(cap, generator=g, device=dev)[:SAMPLES]
    full = forces.accel_allpairs(st0.pos, live_mass, params.G, params.soft2)
    want = forces.accel_allpairs_ref(st0.pos, live_mass, params.G,
                                     params.soft2,
                                     targets=st0.pos[rows].contiguous())
    torch.cuda.synchronize()
    err, scale = _check_close("allpairs engine shape", full[rows], want)
    eng_ms = _timed_ms(lambda: forces.accel_allpairs(
        st0.pos, live_mass, params.G, params.soft2), reps=5)
    eng_plan = forces._card_plan(cap, cap, 2, dev)
    eng_bound = _bounds(forces.pair_work(cap, cap, 2), eng_ms, n_sm,
                        max_clock_hz)
    results["allpairs"]["engine_shape"] = dict(
        targets=cap, sources=cap, ms=eng_ms, max_abs_err_sampled=err,
        blocks=eng_plan.blocks, splits=eng_plan.splits, **eng_bound)
    print(f"allpairs 2D {cap} targets x {cap} sources: max|diff| {err:.3e} "
          f"on {SAMPLES} sampled rows (max|a| {scale:.3e}), kernel "
          f"{eng_ms:.2f} ms, bound {eng_bound['bound_ms']:.2f} ms "
          f"({eng_bound['pct_of_bound']:.1f}%), rsqrt floor "
          f"{eng_bound['rsqrt_floor_ms']:.2f} ms, plan {eng_plan.blocks} "
          f"blocks x {eng_plan.splits} splits", flush=True)
    del tgt, first, second, full, want

    # -- force error of the initial scene (the JAX package's measurement
    #    point: mean 1.70e-4 for this config at N=1M) -----------------------
    paths = Paths()
    paths.run("force_error_step0",
                     lambda: _force_error("pm_main step 0", st0, cfg, params,
                                          g),
                     need=("band", "allpairs"))

    # -- main path ----------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    sec, n0, n1 = paths.run(
        "pm_main", lambda: _run_steps(eng, 3, [STEPS] * 3, lambda s: s + 1,
                                      "band"), need=("band",))
    _report_run("pm_main", eng, sec, n0, n1)
    main_sec = sec
    hud = eng.stats()
    print(f"stats: step {int(hud['step'])} n_alive {int(hud['n_alive'])} "
          f"total_mass {float(hud['total_mass']):.1f} kinetic "
          f"{float(hud['kinetic']):.6e}", flush=True)
    paths.run("pm_main_force_error",
              lambda: _force_error(f"pm_main step {int(hud['step'])}",
                                   eng.state, cfg, params, g, ERR_LIMIT),
              need=("allpairs",))
    del eng

    # -- path A: the exact all-pairs engine ---------------------------------
    print(f"path A: solver='allpairs', kdk_reuse, N={N}", flush=True)
    ap = _engine(cfg, params, dev, N, solver="allpairs",
                 integrator="kdk_reuse")
    torch.cuda.reset_peak_memory_stats()
    sec, n0, n1 = paths.run(
        "allpairs_engine", lambda: _run_steps(ap, 2, [2, 3], lambda s: s + 1,
                                              "allpairs"),
        need=("allpairs",))
    _report_run(f"allpairs_engine kdk_reuse N={N}", ap, sec, n0, n1)
    del ap
    small = SimConfig(capacity=N_SMALL, **CFG)
    for integrator, per_step in (("kdk", 2), ("euler", 1)):
        e = _engine(small, params, dev, N_SMALL, solver="allpairs",
                    integrator=integrator)
        sec, n0, n1 = paths.run(
            f"allpairs_{integrator}",
            lambda: _run_steps(e, 2, [4, 4], lambda s: per_step * s,
                               "allpairs"), need=("allpairs",))
        _report_run(f"allpairs_engine {integrator} N={N_SMALL}", e, sec, n0,
                    n1)

    # -- path B: heavy-direct + F_long subcycling ---------------------------
    print(f"path B: the main path's configuration with {SUBCYCLED}",
          flush=True)
    cfg_b = dataclasses.replace(cfg, **SUBCYCLED)
    sub = _engine(cfg_b, params, dev, N, solver="pm", integrator="kdk_reuse")
    torch.cuda.reset_peak_memory_stats()
    sec, n0, n1 = paths.run(
        "pm_subcycled", lambda: _run_steps(sub, 3, [STEPS] * 3,
                                           lambda s: s + 1, "band"),
        need=("band",))
    _report_run("pm_subcycled", sub, sec, n0, n1)
    print(f"pm_subcycled against pm_main in this run: "
          f"{1e3 * sec:.2f} against {1e3 * main_sec:.2f} ms/step", flush=True)
    paths.run("pm_subcycled_force_error",
              lambda: _force_error("pm_subcycled fresh pass after the run",
                                   sub.state, cfg_b, params, g, ERR_LIMIT),
              need=("band", "allpairs"))
    del sub

    # -- path C: one fresh force pass per remaining knob --------------------
    print("path C: one fresh force pass of the initial scene per knob",
          flush=True)

    def knobs():
        # every knob on the same sampled bodies, so the means compare
        # pairwise
        out = {}
        for name, over in {"cic": {}, **KNOBS}.items():
            c = dataclasses.replace(cfg, **over)
            same = torch.Generator(device=dev).manual_seed(12)
            e = _force_error(f"  {name}", st0, c, params, same)
            e["ms"] = _pass_ms(st0, c, params, dev)
            print(f"  {name}: {e['ms']:.2f} ms a pass", flush=True)
            out[name] = e
        return out

    errs = paths.run("pm_knobs", knobs, need=("band", "allpairs"))
    cic = errs["cic"]["mean"]
    checks = {
        "heavy_direct": errs["heavy_direct"]["mean"] <= 1.05 * cic,
        "tsc": errs["tsc"]["mean"] <= ERR_LIMIT,
        "ngp": (errs["ngp"]["max"] < float("inf")
                and errs["ngp"]["mean"] > cic),
        "interlace": errs["interlace"]["mean"] <= ERR_LIMIT,
        "two_tier": errs["two_tier"]["mean"] <= ERR_LIMIT,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"path C: {bad} missed their limits: "
                             f"{ {k: errs[k]['mean'] for k in bad} } "
                             f"(cic mean {cic:.3e})")

    cfg_x = dataclasses.replace(cfg, pm_heavy_cap=16, pm_mesh_every=2,
                                pm_mesh_extrapolate=True)
    ex = _engine(cfg_x, params, dev, N, solver="pm", integrator="kdk_reuse")
    paths.run("pm_extrapolate",
              lambda: _run_steps(ex, 2, [2, 2], lambda s: s + 1, "band"),
              need=("band",))
    print("  pm_mesh_extrapolate: two step(2) calls, state finite",
          flush=True)
    del ex

    # the deposit modes on the Hilbert-sorted scene, as the engine deposits
    base, w = mesh._cic_cells(spos, morigin, h, nw, 2, ny=ny)

    def deposit(mode=False):
        return mesh._deposit_packed(smass, base, w, nw, grid,
                                    run_compress=mode, ny=ny, grid_y=grid_y)

    plain = deposit()
    dep = {"plain": _timed_ms(deposit)}
    for mode in (True, 8):
        _check_close(f"deposit run_compress={mode}", deposit(mode), plain)
        dep[str(mode)] = _timed_ms(lambda: deposit(mode))
    print(f"  deposit (Hilbert-sorted bodies): plain {dep['plain']:.3f} ms, "
          f"run_compress=True {dep['True']:.3f} ms, run_compress=8 "
          f"{dep['8']:.3f} ms; both within {TOL} of max rho", flush=True)

    launches = {"band": paths.counts["pm_main"]["band"],
                "allpairs": paths.counts["pm_main_force_error"]["allpairs"]}
    kernels = [
        dict(name="band_short_range", route="cuda",
             source="tpu_nbody_torch/csrc/band.cu",
             replaces="tpu_nbody/ops/band_pallas.py:43",
             launches=launches["band"], launches_by_path=paths.of("band"),
             library_ms=None, **results["band"]),
        dict(name="allpairs", route="cuda",
             source="tpu_nbody_torch/csrc/allpairs.cu",
             replaces="tpu_nbody/ops/forces.py:47",
             launches=launches["allpairs"],
             launches_by_path=paths.of("allpairs"), library_ms=None,
             **results["allpairs"]),
    ]
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
