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
  with extrapolation; the run-compressed deposits against the plain one;
* bh_engine (path D): solver="bh" with kdk_reuse and the hier traversal on
  the configuration of ``bench.py --solver bh``: step(2) to warm up and
  settle the cap retune, tighten_caps(), step(2) again if the caps
  changed, step(3) timed; then no cap overflowing, the force error of a
  fresh pass, one pass timed by phase, the traversal needs on three scenes
  at N = 1,000,000, and at N = 65,536 a pass at theta = 1e-3 against the
  all-pairs kernel and dense against hier;
* sphere3d (path E): the reference GPU demo, the 3D sphere scene under
  exact all-pairs forces (the kernel's 3D instantiation) and semi-implicit
  Euler. Once as ``python -m tpu_nbody_torch.examples.sphere3d_demo`` runs
  it (50,000 satellites and the central body, 90 frames of one step,
  430 x 180, the orbiting camera, GIF written to a temporary directory),
  and once at a size that loads the card: 2^20 bodies through
  ``Engine(SimConfig(capacity=2**20, dim=3), ..., solver="allpairs",
  integrator="euler")``, step(1) to warm up and step(3) timed, n_alive
  unchanged, momentum and centre of mass conserved, then one frame at
  3440 x 1440. A PhaseTimer times its phases;
* render: that frame and a frame of the main path's stepped N = 1M state
  (the 2400 x 800 world at 1200 x 400, speed and classic colors) are not
  all black, agree between two renders and with the same splat on the CPU
  (the additive sums before the clip, within RENDER_TOL of the brightest
  pixel; the 3D projection within 1e-3 px), timed with CUDA events; a
  render_movie of the main path's configuration (8 frames of 4 steps)
  leaves uint8 frames on the card that differ from first to last;
* drift: ``tpu_nbody_torch.examples.drift_benchmark`` for solver="allpairs"
  at n = 2000, 10,000 steps of dt = 1e-4 with kdk_reuse and merging off,
  failing where the relative energy or L_z drift is above DRIFT_LIMIT.

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
   on 4096 sampled rows, in 2D on the two-disk scene and in 3D on path E's
   sphere, and in 3D all 50,001 x 50,001 rows of the state the demo ended
   in, a shape that fills no thread, block or source tile and takes the
   split-source plan), each within 1e-5 of the largest magnitude; the 3D
   sphere shapes also row by row, within 1e-5 of the larger of the row's own
   magnitude and the median row's, and with the central body's mass set to
   0, where the largest magnitude is the satellites' own, timing both with CUDA events (median of 10 timings of one call on an
   idle card, after 2 warm-ups; 5 at the engine's shape), and checks that
   the all-pairs kernel gives the same bits on a second call (2D and 3D);
5. sets every launch count to 0 just before each path and reads it just
   after, checking the launches each path must make (one band launch per
   P3M force pass, one all-pairs launch per all-pairs force pass), finite
   state and no growth of n_alive;
6. measures the force error against the exact all-pairs kernel on 4096
   sampled alive bodies (tpu_nbody_torch.accuracy), failing where a mean
   is over its limit.

The kernels line gives, per kernel, ``launches`` (for the band kernel the
main path's three step(20) calls; for the all-pairs kernel path E's run at
2^20 bodies, the path it carries: the P3M main path launches it only in
the force error after its steps) and ``launches_by_path``. Barnes–Hut launches neither
kernel in its steps (its pair math is plain torch); path D's counts are the
all-pairs launches of its force-error measurements. Each kernel's bound_ms is
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
import os
import subprocess
import sys
import tempfile
import time

N = 1_000_000       # bodies of the two-disk scene
N_SMALL = 65_536    # bodies of the kdk and euler all-pairs runs
STEPS = 20          # steps per Engine.step call of the P3M paths
TOL = 1e-5          # kernel vs plain: max |diff| <= TOL * max |plain|
ERR_LIMIT = 5e-4    # mean relative force error of P3M vs exact
# The same of Barnes–Hut at theta = 0.5. The monopole error grows with N at
# a fixed group size (both packages agree on it for the same bodies): about
# 5e-4 at N = 65,536 and 6.3e-4 at N = 1M, where the JAX package's records
# quote 3.6e-4 without a size.
BH_ERR_LIMIT = 8e-4
BH_OPEN_TOL = 1e-3  # theta = 1e-3 opens every cell: max relative error
BH_HIER_TOL = 2e-5  # hier vs dense: max |diff| <= this * max |dense|
SAMPLES = 4096      # bodies sampled for the exact force error
N_SPHERE = 50_000   # satellites of the 3D demo at its own size
SPHERE_FRAMES = 90  # its frames, one step each
SPHERE_VIEW = (430, 180)    # its frame, width x height
BIG_VIEW = (3440, 1440)     # the frame of the 2^20-body sphere
MAIN_VIEW = (1200, 400)     # the frame of the 2400 x 800 two-disk world
RENDER_TOL = 1e-4   # splat sums: max |diff| <= this * the brightest pixel
MOMENTUM_TOL = 1e-4  # path E: |p - p0| <= this * sum m |v|
COM_TOL = 1e-2      # path E: |com - (com0 + t p0 / M)| in px
DRIFT_LIMIT = 1e-3  # relative energy and L_z drift of the all-pairs run
DRIFT_ARGS = ["--solver", "allpairs", "--n", "2000", "--steps", "10000",
              "--report-every", "2500", "--dt", "1e-4", "--integrator",
              "kdk_reuse"]
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
# path D: the Barnes–Hut caps of ``bench.py --solver bh`` (bench.py:244-265)
BH_CFG = dict(max_depth=14, group_chunk=64, approx_cap=1024,
              direct_body_cap=16384, frontier_cap=1024, leaf_list_cap=2048,
              bh_hier_cand_caps=(131072, 32768, 4096), group_cap=2080,
              node_capacity=1 << 20)
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


class PhaseClock:
    """Device time by phase: ``clock(name)`` marks the end of a phase
    (``"start"`` the beginning of the timed work), and ``ms()`` gives the
    milliseconds spent in each name, summed."""

    def __init__(self):
        self.marks = []

    def __call__(self, name):
        import torch
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev))

    def ms(self):
        self.marks[-1][1].synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            if name != "start":
                out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def _rel_err(got, want):
    return (got - want).norm(dim=1) / (want.norm(dim=1) + 1e-9)


def _path_d(paths, cfg, params, dev, st0):
    """Barnes–Hut end to end at N = 1M, then its checks (module
    docstring). Returns the timed seconds a step. Its force errors draw
    their samples from a generator of their own: how far the main path's
    measurements advance theirs depends on that run's n_alive."""
    import torch
    from tpu_nbody_torch import accuracy, state as state_lib
    from tpu_nbody_torch.config import SimConfig
    from tpu_nbody_torch.models import scenes
    from tpu_nbody_torch.ops import forces

    print(f"path D: solver='bh', kdk_reuse, hier, N={N}, {BH_CFG}",
          flush=True)
    g = torch.Generator(device=dev).manual_seed(13)
    bh = _engine(cfg, params, dev, N, solver="bh", integrator="kdk_reuse")
    torch.cuda.reset_peak_memory_stats()

    def run():
        n0 = int(bh.state.n_alive())
        for label, n in (("warm-up", 2), ("after tighten_caps", 2),
                         ("timed", 3)):
            if label == "after tighten_caps":
                changed = bh.tighten_caps()
                print(f"  tighten_caps: changed={changed} {bh.caps}",
                      flush=True)
                if not changed:
                    continue
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bh.step(n)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            print(f"  step({n}) {label}: {dt:.3f} s; caps {bh.caps}",
                  flush=True)
        return dt / 3, n0, int(bh.state.n_alive())

    sec, n0, n1 = paths.run("bh_engine", run)
    if any(paths.counts["bh_engine"].values()):
        raise AssertionError(f"Barnes–Hut steps launched a kernel: "
                             f"{paths.counts['bh_engine']}")
    st = bh.state
    if not all(bool(torch.isfinite(x).all()) for x in (st.pos, st.vel,
                                                        st.mass)):
        raise AssertionError("bh: state is not finite after the run")
    if n1 > n0:
        raise AssertionError(f"bh: n_alive grew: {n0} -> {n1}")
    if bh.last_stats.overflowed(bh.caps.as_dict()):
        raise AssertionError(f"bh: a cap still overflows after the retune: "
                             f"{bh.last_stats} against {bh.caps}")
    print(f"bh_engine: {1e3 * sec:.2f} ms/step, {n1 / sec:.1f} "
          f"body-updates/s, n_alive {n0} -> {n1}, last_heavy_need "
          f"{bh.last_heavy_need}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"  caps {bh.caps}", flush=True)
    print(f"  last_stats {bh.last_stats}", flush=True)

    # force error of a fresh pass of the initial scene (the JAX package's
    # measurement point), from the engine's caps, against the exact
    # all-pairs kernel
    def bh_error():
        e = accuracy.sampled_force_error(st0, cfg, params, SAMPLES, g,
                                         solver="bh", caps=bh.caps)
        print(f"bh step 0: force error vs exact "
              f"({e['samples']} sampled bodies): mean {e['mean']:.3e} p50 "
              f"{e['p50']:.3e} p99 {e['p99']:.3e} max {e['max']:.3e}",
              flush=True)
        if not e["mean"] <= BH_ERR_LIMIT:
            raise AssertionError(f"bh: mean force error {e['mean']:.3e} > "
                                 f"{BH_ERR_LIMIT:.3e}")
    paths.run("bh_force_error", bh_error, need=("allpairs",))

    # one pass of the stepped state by phase (device events); the force
    # error's pass has warmed the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clock = PhaseClock()
    accuracy.fitted_bh_pass(st.pos, st.mass, st.alive, cfg, params, bh.caps,
                            probe=clock)
    ms = clock.ms()
    print(f"bh pass by phase (ms): tree build {ms['build']:.2f}, groups "
          f"{ms['groups']:.2f}, hier lists {ms['lists']:.2f}, partner "
          f"flatten {ms['flatten']:.2f}, pair evaluation "
          f"{ms['evaluate']:.2f}, assembly {ms['assemble']:.2f}, total "
          f"{sum(ms.values()):.2f}; peak memory of the pass "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del bh

    # the needs of one pass on three scenes at N = 1M, caps grown to fit
    # (the lists are built and measured; no pair block is evaluated)
    def needs(name, stt):
        _, need, caps = accuracy.fitted_bh_pass(
            stt.pos, stt.mass, stt.alive, cfg, params, evaluate=False)
        print(f"bh needs at N={N}, {name}: cand_need {need.cand_need} "
              f"leaf_need {need.leaf_need} direct_need {need.direct_need} "
              f"node_need {need.node_need} group_need {need.group_need} "
              f"group_size_need {need.group_size_need}; fitted {caps}",
              flush=True)

    sg = torch.Generator(device=dev).manual_seed(3)
    needs("two-disk", st0)
    for name, pvm in (
            ("uniform cloud", scenes.make_uniform_cloud(sg, N)),
            ("4-galaxy merger", scenes.multi_galaxy_merger(sg, n_total=N))):
        needs(name, state_lib.from_arrays(*pvm, cfg.capacity, device=dev))

    # N = 65,536: theta = 1e-3 opens every cell, so BH is the exact sum;
    # and the dense traversal against hier
    small = SimConfig(capacity=N_SMALL)
    e = _engine(small, params, dev, N_SMALL, solver="bh")
    s = e.state
    live_mass = torch.where(s.alive, s.mass, 0.0)

    def open_all():
        acc, need, caps = accuracy.fitted_bh_pass(
            s.pos, s.mass, s.alive, small, params.replace(theta=1e-3))
        exact = forces.accel_allpairs(s.pos, live_mass, params.G,
                                      params.soft2)
        rel = float(_rel_err(acc, exact)[s.alive].max())
        print(f"bh theta=1e-3 N={N_SMALL} vs the all-pairs kernel: max "
              f"relative error {rel:.3e} (direct_need {need.direct_need}, "
              f"leaf_need {need.leaf_need})", flush=True)
        if not rel <= BH_OPEN_TOL:
            raise AssertionError(f"bh at theta=1e-3 is not the exact sum: "
                                 f"{rel:.3e} > {BH_OPEN_TOL}")
    paths.run("bh_open_all", open_all, need=("allpairs",))

    def small_error():
        e = accuracy.sampled_force_error(s, small, params, SAMPLES, g,
                                         solver="bh")
        print(f"bh theta={params.theta} N={N_SMALL} (dense): force error "
              f"mean {e['mean']:.3e} p99 {e['p99']:.3e}", flush=True)
    paths.run("bh_small_force_error", small_error, need=("allpairs",))

    accs = {}
    for trav in ("dense", "hier"):
        c = dataclasses.replace(small, bh_traversal=trav)
        accs[trav], _, _ = accuracy.fitted_bh_pass(s.pos, s.mass, s.alive, c,
                                                   params)
    diff = float((accs["hier"] - accs["dense"]).abs().max())
    scale = float(accs["dense"].abs().max())
    print(f"bh dense vs hier N={N_SMALL}: max|diff| {diff:.3e} (max|a| "
          f"{scale:.3e})", flush=True)
    if not diff <= BH_HIER_TOL * scale:
        raise AssertionError(f"bh: hier disagrees with dense: {diff:.3e} > "
                             f"{BH_HIER_TOL} x {scale:.3e}")
    return sec


def _check_rows(name, got, want):
    """Row by row: |got_i - want_i| <= TOL x max(|want_i|, the median
    |want|). A scene whose largest row is far above the typical one (the
    bodies next to a heavy centre) leaves the max-norm check of
    ``_check_close`` loose on the typical row; this one is not."""
    import torch
    size = want.norm(dim=1)
    rel = (got - want).norm(dim=1) / torch.maximum(size, size.median())
    worst = float(rel.max())
    if not worst <= TOL:
        raise AssertionError(f"{name}: row {int(rel.argmax())} disagrees "
                             f"with the plain version: {worst:.3e} of its "
                             f"own size > {TOL}")
    return worst


def _allpairs_3d_shape(name, pos, mass, params, rows, n_sm, max_clock_hz):
    """The all-pairs kernel's 3D instantiation at one of path E's shapes,
    every body of a sphere scene a target: against the plain version on the
    target rows ``rows`` (None: all of them) in the max norm and row by row,
    once more with the central body's mass set to 0 (the max norm is then
    the satellites' own), the same bits on a second call, timed, with its
    bounds and its launch plan."""
    import torch
    from tpu_nbody_torch.ops import forces
    n = pos.shape[0]
    tgt = pos if rows is None else pos[rows].contiguous()
    n_rows = tgt.shape[0]

    def pick(a):
        return a if rows is None else a[rows]

    def kernel(m):
        return forces.accel_allpairs(pos, m, params.G, params.soft2)

    def plain(m):
        return forces.accel_allpairs_ref(pos, m, params.G, params.soft2,
                                         targets=tgt)

    full, want = kernel(mass), plain(mass)
    torch.cuda.synchronize()
    err, scale = _check_close(name, pick(full), want)
    row_err = _check_rows(name, pick(full), want)
    if not torch.equal(full, kernel(mass)):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    satellites = torch.where(mass == mass.max(), 0.0, mass)
    sat_err, sat_scale = _check_close(f"{name}, satellites alone",
                                      pick(kernel(satellites)),
                                      plain(satellites))
    del full, want
    ms = _timed_ms(lambda: kernel(mass), reps=5)
    plan = forces._card_plan(n, n, 3, pos.device)
    bound = _bounds(forces.pair_work(n, n, 3), ms, n_sm, max_clock_hz)
    print(f"{name}: max|diff| {err:.3e} on {n_rows} rows (max|a| "
          f"{scale:.3e}), worst row {row_err:.3e} of its own size, "
          f"satellites alone {sat_err:.3e} (max|a| {sat_scale:.3e}), two "
          f"calls give the same bits, kernel {ms:.3f} ms, bound "
          f"{bound['bound_ms']:.3f} ms ({bound['pct_of_bound']:.1f}%), rsqrt "
          f"floor {bound['rsqrt_floor_ms']:.3f} ms, plan {plan.blocks} "
          f"blocks x {plan.splits} splits", flush=True)
    return dict(targets=n, sources=n, ms=ms, rows_checked=n_rows,
                max_abs_err_sampled=err, max_row_rel_err=row_err,
                max_abs_err_satellites=sat_err, blocks=plan.blocks,
                splits=plan.splits, **bound)


def _gif_frame_count(raw: bytes) -> int:
    """The image count of a GIF89a file with a 256-entry global color
    table, walking its blocks."""
    if raw[:6] != b"GIF89a" or raw[10] != 0xF7:
        raise AssertionError("not a GIF89a file with a 256-entry table")
    i, frames = 13 + 768, 0

    def skip_sub_blocks(i):
        while raw[i]:
            i += 1 + raw[i]
        return i + 1

    while raw[i] != 0x3B:
        if raw[i] == 0x21:          # extension: label, then sub-blocks
            i = skip_sub_blocks(i + 2)
        elif raw[i] == 0x2C:        # image: descriptor, code size, data
            frames += 1
            i = skip_sub_blocks(i + 11)
        else:
            raise AssertionError(f"GIF: unknown block {raw[i]:#x} at {i}")
    if i != len(raw) - 1:
        raise AssertionError("GIF: bytes after the trailer")
    return frames


def _check_splat(name, bodies, view, mode="speed", gain=1.0):
    """One frame of ``bodies`` = (pos2, vel, mass, alive) on the card: the
    additive splat rendered twice and once more on the CPU from the same
    arrays (the pixel indices are then equal and only the order of the
    adds differs), each within RENDER_TOL of the brightest pixel; the
    clipped frame not all black; render_frame timed with CUDA events."""
    import torch
    from tpu_nbody_torch.ops import render
    kw = dict(width=view["width"], height=view["height"],
              view_x=view.get("view_x", 0.0), view_y=view.get("view_y", 0.0),
              zoom=view.get("zoom", 1.0), mode=mode,
              speed_scale=view["speed_scale"], gain=gain)
    sums = [render._splat_sum(*bodies, size_base=1.0, size_mass_scale=0.0,
                              **kw) for _ in range(2)]
    cpu = render._splat_sum(*[x.cpu() for x in bodies], size_base=1.0,
                            size_mass_scale=0.0, **kw)
    peak = float(cpu.max())
    again = float((sums[0] - sums[1]).abs().max())
    host = float((sums[0].cpu() - cpu).abs().max())
    frame = render.to_uint8(render.render_frame(*bodies, **kw))
    lit = int((frame.sum(dim=2) > 0).sum())
    if not (frame.device == bodies[0].device and lit > 0
            and torch.isfinite(sums[0]).all()):
        raise AssertionError(f"{name}: the frame is black, not finite or "
                             f"not on the bodies' device")
    if not (again <= RENDER_TOL * peak and host <= RENDER_TOL * peak):
        raise AssertionError(
            f"{name}: splat sums differ: two renders {again:.3e}, card "
            f"against CPU {host:.3e} > {RENDER_TOL} x {peak:.3e}")
    levels = int((frame.cpu().int() - render.to_uint8(
        torch.clamp(cpu, 0.0, 1.0)).int()).abs().max())
    if levels > 1:
        raise AssertionError(f"{name}: uint8 frame {levels} levels from "
                             f"the CPU's")
    ms = _timed_ms(lambda: render.render_frame(*bodies, **kw))
    print(f"render {name} {kw['width']}x{kw['height']} {mode}: {ms:.3f} ms, "
          f"{lit} lit pixels, brightest sum {peak:.1f}, two renders differ "
          f"by {again:.3e}, card against CPU {host:.3e}, uint8 within "
          f"{levels}", flush=True)
    return ms


def _moments(st):
    """Float64 momentum, centre of mass, total mass and sum m |v| of a
    state, as CPU tensors."""
    m = st.mass.double()
    p = (m[:, None] * st.vel.double()).sum(0)
    mv = (m * st.vel.double().norm(dim=1)).sum()
    com = (m[:, None] * st.pos.double()).sum(0) / m.sum()
    return p.cpu(), com.cpu(), float(m.sum()), float(mv)


def _path_e(paths, params3, dev, bodies, n_sm, max_clock_hz):
    """The 3D demo at its own size and at 2^20 bodies (module docstring).
    ``bodies`` is the 2^20-body sphere. Returns the numbers it measured."""
    import torch
    from tpu_nbody_torch import profiling, viewer
    from tpu_nbody_torch.config import SimConfig
    from tpu_nbody_torch.engine import Engine
    from tpu_nbody_torch.examples import sphere3d_demo
    from tpu_nbody_torch.ops import render

    pt = profiling.PhaseTimer()
    out = {}
    w, h = SPHERE_VIEW
    print(f"path E: the 3D demo, {N_SPHERE} satellites + the centre, "
          f"{SPHERE_FRAMES} frames at {w}x{h}", flush=True)

    def demo():
        with tempfile.TemporaryDirectory() as tmp:
            eng, frames = sphere3d_demo.simulate(
                N_SPHERE, SPHERE_FRAMES, 1, w, h, device=dev, timer=pt)
            with pt("gif"):
                path = os.path.join(tmp, "sphere.gif")
                viewer.write_gif(path, list(frames.cpu().numpy()), fps=25)
            with open(path, "rb") as f:
                raw = f.read()
        return eng, frames, raw

    eng, frames, raw = paths.run("sphere3d_demo", demo, need=("allpairs",))
    count = _gif_frame_count(raw)
    st = eng.state
    if paths.counts["sphere3d_demo"] != {"band": 0,
                                         "allpairs": SPHERE_FRAMES}:
        raise AssertionError(f"sphere3d_demo: launches "
                             f"{paths.counts['sphere3d_demo']}, expected "
                             f"{SPHERE_FRAMES} all-pairs and no band")
    if not (frames.device.type == dev.type and frames.dtype == torch.uint8
            and tuple(frames.shape) == (SPHERE_FRAMES, h, w, 3)
            and count == SPHERE_FRAMES and int(frames[0].sum()) > 0
            and not torch.equal(frames[0], frames[-1])
            and int(st.n_alive()) == N_SPHERE + 1 and st.dim == 3
            and all(bool(torch.isfinite(x).all()) for x in (st.pos, st.vel))):
        raise AssertionError(f"sphere3d_demo: bad frames or state "
                             f"({count} GIF frames, {tuple(frames.shape)})")
    out["demo_ms_per_frame"] = 1e3 * (pt.totals["step"]
                                      + pt.totals["render"]) / SPHERE_FRAMES
    print(f"sphere3d_demo: {out['demo_ms_per_frame']:.3f} ms/frame (step "
          f"{1e3 * pt.totals['step'] / SPHERE_FRAMES:.3f} + render "
          f"{1e3 * pt.totals['render'] / SPHERE_FRAMES:.3f}, each ended by "
          f"a synchronize), GIF {len(raw)} bytes, {count} frames, written "
          f"in {pt.totals['gif']:.2f} s", flush=True)
    # the kernel at the demo's own shape, on the state the demo ended in:
    # N_SPHERE + 1 bodies is no multiple of a thread's T targets, of a
    # block or of a source tile, and the heavy centre is the last row
    n_demo = N_SPHERE + 1
    out["demo_shape_3d"] = _allpairs_3d_shape(
        f"allpairs 3D {n_demo} targets x {n_demo} sources",
        st.pos, torch.where(st.alive, st.mass, 0.0), params3, None, n_sm,
        max_clock_hz)
    if out["demo_shape_3d"]["splits"] < 2:
        raise AssertionError("allpairs 3D at the demo's shape: expected the "
                             "split-source plan")
    del eng, frames, st

    # -- the size that loads the card ---------------------------------------
    cap = bodies[0].shape[0]
    print(f"path E: Engine(SimConfig(capacity={cap}, dim=3), solver="
          f"'allpairs', integrator='euler'), merging off", flush=True)
    big = Engine(SimConfig(capacity=cap, dim=3), params3, solver="allpairs",
                 integrator="euler", device=dev)
    big.set_bodies(*bodies)
    p0, com0, total, mv = _moments(big.state)
    torch.cuda.reset_peak_memory_stats()
    with pt("engine3d step(1) + step(3)") as hold:
        sec, n0, n1 = paths.run(
            "sphere3d_engine", lambda: _run_steps(big, 2, [1, 3],
                                                  lambda s: s, "allpairs"),
            need=("allpairs",))
        hold["result"] = big.state
    if paths.counts["sphere3d_engine"] != {"band": 0, "allpairs": 4}:
        raise AssertionError(f"sphere3d_engine: launches "
                             f"{paths.counts['sphere3d_engine']}, expected "
                             f"4 all-pairs and no band")
    if n1 != n0 or n0 != cap:
        raise AssertionError(f"sphere3d_engine: n_alive {n0} -> {n1}, "
                             f"expected {cap} (merging is off)")
    _report_run(f"sphere3d_engine euler N={cap}", big, sec, n0, n1)
    p1, com1, _, _ = _moments(big.state)
    t = 4 * params3.dt
    dp = float((p1 - p0).norm())
    dcom = float((com1 - (com0 + t * p0 / total)).norm())
    hud = big.stats(potential=False)
    print(f"sphere3d_engine: |p - p0| {dp:.3e} against sum m|v| {mv:.3e} "
          f"({dp / mv:.3e}), |com - (com0 + t p0 / M)| {dcom:.3e} px; "
          f"stats com {hud['com'].tolist()} momentum "
          f"{hud['momentum'].tolist()} Lz "
          f"{float(hud['angular_momentum_z']):.6e}", flush=True)
    if hud["com"].shape != (3,) or hud["momentum"].shape != (3,):
        raise AssertionError("sphere3d_engine: stats are not 3-vectors")
    if not (dp <= MOMENTUM_TOL * mv and dcom <= COM_TOL):
        raise AssertionError(f"sphere3d_engine: momentum or centre of mass "
                             f"not conserved: {dp / mv:.3e}, {dcom:.3e} px")
    out.update(ms_per_step=1e3 * sec, body_updates_per_s=n1 / sec)

    # -- one frame of it at full size: the projection against the CPU's,
    #    then the splat from the card's screen coordinates
    bw, bh_ = BIG_VIEW
    st = big.state
    with pt("render 3D frame + checks") as hold:
        cam = dict(width=bw, height=bh_, cam_angle=0.25 * 0.016 * 4)
        pos2 = render._project_3d(st.pos, st.mass, st.alive, **cam)
        pos2_cpu = render._project_3d(st.pos.cpu(), st.mass.cpu(),
                                      st.alive.cpu(), **cam)
        dproj = float((pos2.cpu() - pos2_cpu).abs().max())
        if not dproj <= 1e-3:
            raise AssertionError(f"3D projection: card against CPU "
                                 f"{dproj:.3e} px > 1e-3")
        print(f"3D projection {bw}x{bh_}: card against CPU {dproj:.3e} px",
              flush=True)
        view = dict(width=bw, height=bh_, speed_scale=1.0 / 10_000.0)
        out["splat_ms"] = _check_splat(
            f"sphere N={cap}", (pos2, st.vel, st.mass, st.alive), view,
            gain=0.6)
        fb = render.render_frame_3d(st.pos, st.vel, st.mass, st.alive,
                                    gain=0.6, **cam)
        if int((fb.sum(dim=2) > 0).sum()) == 0:
            raise AssertionError("render_frame_3d: the frame is black")
        out["frame3d_ms"] = _timed_ms(lambda: render.render_frame_3d(
            st.pos, st.vel, st.mass, st.alive, gain=0.6, **cam))
        hold["result"] = fb
    print(f"render_frame_3d N={cap} {bw}x{bh_}: {out['frame3d_ms']:.3f} ms "
          f"(centre of mass, projection and splat)", flush=True)
    print("path E phases (host clock, a synchronize at each exit):\n  "
          + pt.report().replace("\n", "\n  "), flush=True)
    return out


def _render_main(paths, cfg, params, dev, st0, stepped):
    """Frames of the main path: the stepped N = 1M state in both color
    modes, and a render_movie of 8 frames x 4 single steps from the
    initial scene (each single step a seed pass and a step of the
    sorted-carry P3M loop)."""
    import torch
    from tpu_nbody_torch import engine
    from tpu_nbody_torch.ops import render
    w, h = MAIN_VIEW
    zoom = w / cfg.world_w
    view = dict(width=w, height=h, zoom=zoom,
                view_y=-(h / zoom - cfg.world_h) / 2, speed_scale=1.0 / 300.0)
    bodies = (stepped.pos, stepped.vel, stepped.mass, stepped.alive)
    out = {mode: _check_splat(f"pm_main N={int(stepped.n_alive())}", bodies,
                              view, mode=mode)
           for mode in ("speed", "classic")}

    step_once = engine.make_step_fn(cfg, engine.Caps.from_config(cfg), "pm",
                                    "kdk_reuse", False, 64, device=dev)

    def movie():
        t0 = time.perf_counter()
        final, frames = render.render_movie(
            st0, params, lambda s, p: step_once(s, p, n_steps=1)[0],
            n_frames=8, steps_per_frame=4, mode="speed", **view)
        torch.cuda.synchronize()
        return final, frames, time.perf_counter() - t0

    final, frames, sec = paths.run("render_movie_pm", movie, need=("band",))
    if paths.counts["render_movie_pm"] != {"band": 64, "allpairs": 0}:
        raise AssertionError(f"render_movie_pm: launches "
                             f"{paths.counts['render_movie_pm']}, expected "
                             f"64 band (two passes a single step)")
    if not (frames.device.type == dev.type and frames.dtype == torch.uint8
            and tuple(frames.shape) == (8, h, w, 3)
            and int(final.step) == 32 and int(frames[0].sum()) > 0
            and not torch.equal(frames[0], frames[-1])):
        raise AssertionError("render_movie_pm: bad frames")
    changed = int((frames[0] != frames[-1]).any(dim=2).sum())
    print(f"render_movie pm N={N}: 8 frames x 4 steps in {sec:.2f} s, "
          f"uint8 {tuple(frames.shape)} on {frames.device}, {changed} pixels "
          f"differ between the first and the last frame", flush=True)
    return out


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

    # the same in 3D, at path E's shape and on its scene
    from tpu_nbody_torch.models import scenes3d
    params3 = Params.default(merge_min_dist=0.0)    # the GPU demo's physics
    sphere = scenes3d.generate_sphere(
        torch.Generator(device=dev).manual_seed(1), cap - 1)
    results["allpairs"]["engine_shape_3d"] = _allpairs_3d_shape(
        f"allpairs 3D {cap} targets x {cap} sources", sphere[0], sphere[2],
        params3, torch.randperm(cap, generator=g, device=dev)[:SAMPLES],
        n_sm, max_clock_hz)

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
    main_state = eng.state
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
    ap_sec = sec
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

    # -- path D: Barnes–Hut -------------------------------------------------
    bh_sec = _path_d(paths, SimConfig(capacity=cap, **CFG, **BH_CFG), params,
                     dev, st0)
    # -- path E: the 3D demo, then the renders of the main path -------------
    e = _path_e(paths, params3, dev, sphere, n_sm, max_clock_hz)
    del sphere
    render_ms = _render_main(paths, cfg, params, dev, st0, main_state)
    print(f"ms/step in this run: bh {1e3 * bh_sec:.2f}, allpairs "
          f"{1e3 * ap_sec:.2f}, pm_main {1e3 * main_sec:.2f}, sphere3d "
          f"{e['ms_per_step']:.2f}", flush=True)

    # -- drift of the exact solver ------------------------------------------
    from tpu_nbody_torch.examples import drift_benchmark
    print(f"drift: drift_benchmark {' '.join(DRIFT_ARGS)}", flush=True)
    drift = paths.run("drift_allpairs",
                      lambda: drift_benchmark.main(DRIFT_ARGS),
                      need=("allpairs",))
    print(f"drift_allpairs: |dE|/|E0| "
          f"{drift['value']:.3e}, |dLz|/|Lz0| {drift['Lz_drift']:.3e}, "
          f"{drift['elapsed_s']:.1f} s", flush=True)
    if not (drift["value"] <= DRIFT_LIMIT
            and drift["Lz_drift"] <= DRIFT_LIMIT):
        raise AssertionError(f"drift above {DRIFT_LIMIT}: energy "
                             f"{drift['value']:.3e}, Lz "
                             f"{drift['Lz_drift']:.3e}")

    results["allpairs"]["demo_shape_3d"] = e["demo_shape_3d"]
    results["allpairs"]["engine_shape_3d"].update(
        path_e_ms_per_step=e["ms_per_step"],
        path_e_body_updates_per_s=e["body_updates_per_s"])
    launches = {"band": paths.counts["pm_main"]["band"],
                "allpairs": paths.counts["sphere3d_engine"]["allpairs"]}
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
    print(f"render ms: 3D frame {e['frame3d_ms']:.3f} (splat alone "
          f"{e['splat_ms']:.3f}), pm_main speed {render_ms['speed']:.3f}, "
          f"classic {render_ms['classic']:.3f}; sphere3d_demo "
          f"{e['demo_ms_per_frame']:.3f} ms/frame", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
