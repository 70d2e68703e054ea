#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tpu_nbody_torch) on one NVIDIA GPU.

    python3 chip_smoke.py    # the full check, one card

Drives the port's main path as a user calls it, at full size: the P3M
solver with kdk_reuse and persistent Hilbert-sorted state on the two-disk
collision scene at N = 1,000,000 (capacity 2^20, the bench configuration of
bench.py), Engine.step(20) once to warm up and twice timed. On the way it

1. requires a CUDA card (exits non-zero otherwise) and prints its name and
   power limit as nvidia-smi reports them;
2. builds the hand-written kernels from tpu_nbody_torch/csrc with nvcc and
   prints each kernel's registers, failing on any register spill;
3. holds the band kernel against its plain torch version on the sorted
   scene (S = 128 poly4 and exp4, S = 256 and 1024 poly4, and S = 128 on a
   capacity that is not a multiple of the bodies a CTA covers) and
4. the all-pairs kernel against its plain version (8192 bodies in 2D and
   3D, 4096 targets x 2^20 sources), each within 1e-5 of the largest
   magnitude, timing both with CUDA events (median of 10 timings of one
   call on an idle card, after 2 warm-ups), and checks that the all-pairs
   kernel gives the same bits on a second call;
5. runs the main path with the band launch count set to 0 first, and
   checks one band launch per force pass, finite state and no growth of
   n_alive;
6. measures the port's force error against the exact all-pairs kernel on
   4096 sampled alive bodies, on the initial scene and after the run
   (fails above a mean of 5e-4 after the run), with the all-pairs launch
   count set to 0 just before the measurement after the run.

Each launch count in the kernels line covers only the run it describes:
the band count the three step(20) calls, the all-pairs count the force
error after them. Each kernel's bound_ms is the larger of its flops over
the float32 peak and its bytes over the memory rate (pair_work in its
module); rsqrt_floor_ms is its pairs over the rsqrt unit's rate (16 a
clock per SM at the card's highest SM clock), a second floor beside it.

It prints one JSON line describing the kernels, then, as its last line,
{"ok": true, "device": {...}}. Any failure raises and exits non-zero
without that line. It imports nothing of jax or of tpu_nbody.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

N = 1_000_000       # bodies of the two-disk scene
STEPS = 20          # steps per Engine.step call
TOL = 1e-5          # kernel vs plain: max |diff| <= TOL * max |plain|
ERR_LIMIT = 5e-4    # mean relative force error of P3M vs exact
SAMPLES = 4096      # bodies sampled for the exact force error
PEAK_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores, 700 W
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
RSQRT_PER_CLK_SM = 16


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


def _compare(name, kernel_fn, plain_fn):
    """Run kernel and plain version once, check agreement, time both."""
    import torch
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not (err <= TOL * scale and torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel disagrees with plain version: "
                             f"max|diff| {err:.3e} > {TOL} x {scale:.3e}")
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


def _force_error(st, cfg, params, origin, side, samples, g):
    """Mean and p99 of |a_pm - a_exact| / |a_exact| over ``samples``
    alive bodies of state ``st``: the port's P3M force pass against the
    exact all-pairs kernel on those targets from every alive source."""
    import torch
    from tpu_nbody_torch.ops import forces, mesh
    acc, pm_stats = mesh.pm_accel(
        st.pos, st.mass, st.alive, params.G, params.soft2, origin, side,
        mesh_level=cfg.mesh_level, split_cells=cfg.mesh_split,
        band=cfg.mesh_band, chunk=cfg.mesh_chunk, rescue_k=cfg.mesh_rescue,
        mesh_ny=cfg.mesh_ny, return_stats=True, switch=cfg.mesh_switch)
    alive_idx = torch.nonzero(st.alive).flatten()
    pick = torch.randperm(alive_idx.shape[0], generator=g,
                          device=alive_idx.device)
    idx = alive_idx[pick[:samples]]
    exact = forces.accel_allpairs(st.pos, torch.where(st.alive, st.mass, 0.0),
                                  params.G, params.soft2,
                                  targets=st.pos[idx].contiguous())
    rel = (acc[idx] - exact).norm(dim=1) / (exact.norm(dim=1) + 1e-9)
    return (float(rel.mean()), float(torch.quantile(rel, 0.99)),
            idx.shape[0], int(pm_stats["rescue_need"]))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2

    from tpu_nbody_torch.config import Params, SimConfig
    from tpu_nbody_torch.engine import Engine
    from tpu_nbody_torch.kernels import _build
    from tpu_nbody_torch.ops import band, forces, mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
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

    # -- scene (the bench config, bench.py:244-294) --------------------------
    cap = 1 << (N - 1).bit_length()
    cfg = SimConfig(capacity=cap, mesh_level=12, mesh_ny=2048,
                    mesh_split=2.5, mesh_band=128, mesh_rescue=8,
                    mesh_chunk=16384, mesh_switch="poly4",
                    pm_resort_every=8)
    params = Params.default(theta=0.5)
    eng = Engine(cfg, params, solver="pm", integrator="kdk_reuse", seed=3,
                 device=dev)
    n2 = N // 5
    eng.reset_default_scene(n1=N - n2, n2=n2)
    ox, oy = cfg.root_center
    origin = (ox - cfg.root_half, oy - cfg.root_half)
    side = 2.0 * cfg.root_half
    *_, a, _ = mesh._pm_geometry(origin, side, cfg.mesh_level, cfg.mesh_ny,
                                 cfg.mesh_split)
    st = eng.state
    spos, smass, _, _ = mesh._hilbert_sort(st.pos, st.mass, st.alive,
                                           origin, side)
    spos, smass = spos.contiguous(), smass.contiguous()
    print(f"scene: N={int(st.n_alive())} capacity={cap}", flush=True)

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
    live_mass = torch.where(st.alive, st.mass, 0.0)
    tgt = st.pos[:4096].contiguous()
    r = _compare(
        f"allpairs 2D 4096 targets x {cap} sources",
        lambda: forces.accel_allpairs(st.pos, live_mass, params.G,
                                      params.soft2, targets=tgt),
        lambda: forces.accel_allpairs_ref(st.pos, live_mass, params.G,
                                          params.soft2, targets=tgt))
    first = forces.accel_allpairs(st.pos, live_mass, params.G, params.soft2,
                                  targets=tgt)
    second = forces.accel_allpairs(st.pos, live_mass, params.G,
                                   params.soft2, targets=tgt)
    if not torch.equal(first, second):
        raise AssertionError("allpairs: two calls on the same inputs differ")
    print("allpairs: two calls give the same bits", flush=True)
    ap_plan = forces._card_plan(4096, cap, 2, dev)
    results["allpairs"] = dict(
        r, **_bounds(forces.pair_work(4096, cap, 2), r["ms"], n_sm,
                     max_clock_hz),
        plan=dict(T=forces.T, blocks=ap_plan.blocks, splits=ap_plan.splits))
    del spos, smass, tgt, live_mass, first, second

    # -- force error of the initial scene (the JAX package's measurement
    #    point: mean 1.70e-4 for this config at N=1M) -----------------------
    mean0, p99_0, ns0, need0 = _force_error(st, cfg, params, origin, side,
                                            SAMPLES, g)
    print(f"force error at step 0 vs exact ({ns0} sampled bodies): mean "
          f"{mean0:.3e} p99 {p99_0:.3e} (rescue_need {need0})", flush=True)

    # -- main path ----------------------------------------------------------
    n0 = int(eng.state.n_alive())
    torch.cuda.reset_peak_memory_stats()
    times = []
    band.LAUNCHES = 0
    for rep in range(3):                       # warm-up, then two timed
        before = band.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step(STEPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if band.LAUNCHES - before != STEPS + 1:
            raise AssertionError(f"band kernel launched "
                                 f"{band.LAUNCHES - before} times in "
                                 f"step({STEPS}), expected {STEPS + 1}")
        if rep:
            times.append(dt)
        print(f"step({STEPS}) {'warm-up' if rep == 0 else 'timed'}: "
              f"{dt:.3f} s", flush=True)
    launches = {"band": band.LAUNCHES}
    st = eng.state
    n1 = int(st.n_alive())
    finite = all(bool(torch.isfinite(x).all()) for x in (st.pos, st.vel,
                                                         st.mass))
    if not finite:
        raise AssertionError("state is not finite after the run")
    if n1 > n0:
        raise AssertionError(f"n_alive grew: {n0} -> {n1}")
    dt = min(times)
    print(f"main path: {1e3 * dt / STEPS:.2f} ms/step, "
          f"{n1 * STEPS / dt:.1f} body-updates/s, n_alive {n0} -> {n1},"
          f" last_rescue_need {eng.last_rescue_need}, last_mesh_oob "
          f"{eng.last_mesh_oob}, last_heavy_need {eng.last_heavy_need}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    hud = eng.stats()
    print(f"stats: step {int(hud['step'])} n_alive {int(hud['n_alive'])} "
          f"total_mass {float(hud['total_mass']):.1f} kinetic "
          f"{float(hud['kinetic']):.6e}", flush=True)

    # -- force error after the run, against the exact all-pairs kernel -----
    forces.LAUNCHES = 0
    mean, p99, ns, need = _force_error(st, cfg, params, origin, side,
                                       SAMPLES, g)
    launches["allpairs"] = forces.LAUNCHES
    print(f"force error at step {int(hud['step'])} vs exact ({ns} sampled "
          f"bodies): mean {mean:.3e} p99 {p99:.3e} (rescue_need {need})",
          flush=True)
    if not mean <= ERR_LIMIT:
        raise AssertionError(f"mean force error {mean:.3e} > {ERR_LIMIT}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} kernel never launched in its run")

    kernels = [
        dict(name="band_short_range", route="cuda",
             source="tpu_nbody_torch/csrc/band.cu",
             replaces="tpu_nbody/ops/band_pallas.py:43",
             launches=launches["band"], library_ms=None, **results["band"]),
        dict(name="allpairs", route="cuda",
             source="tpu_nbody_torch/csrc/allpairs.cu",
             replaces="tpu_nbody/ops/forces.py:47",
             launches=launches["allpairs"], library_ms=None,
             **results["allpairs"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
