"""Benchmark: body-updates/s of the port on one NVIDIA GPU (port of the
JAX package's ``bench.py``).

    python -m tpu_nbody_torch.bench                      # P3M, N = 1,000,000
    python -m tpu_nbody_torch.bench --solver allpairs
    python -m tpu_nbody_torch.bench --solver bh --steps 2 --repeats 3
    python -m tpu_nbody_torch.bench --small --device cpu  # a CPU smoke run

Runs the JAX bench's configuration (:func:`bench_config`) on the two-disk
galaxy collision scaled to N bodies (n1 = N - N//5, n2 = N//5, seed 3,
merging on) and prints ONE JSON line on stdout:

    {"metric": "...", "value": N, "unit": "bodies/s", "vs_baseline": N}

``value`` is alive bodies x steps / the median seconds of ``--repeats``
timed ``Engine.step(steps)`` calls after a warm-up. On the card each
repeat is bracketed by CUDA events and ends in ``torch.cuda.synchronize()``;
host-clock runs of the main path spread over 100.83-121.64 ms/step between
runs on one H100, hence device events and a median. The host clock of the
same repeats is printed beside it on stderr. A ``kdk_reuse`` ``step(n)``
pays its seed force pass (n + 1 passes for n steps), as in the JAX bench.
``vs_baseline`` divides by the Kotlin reference's derived CPU rate,
:data:`BASELINE_UPDATES_PER_SEC` (``BASELINE.md``).

The metric names the force error of the bench's own final state:
:func:`tpu_nbody_torch.accuracy.sampled_force_error` over 4096 alive bodies
(256 with ``--small``) drawn by a generator seeded 3, against exact
all-pairs forces: mean and p99 for every solver, with θ for Barnes–Hut,
"exact" for all-pairs. It also names the device, so a CPU rate never
carries the card's metric name.

Everything else goes to stderr as ``#`` lines: the card's name and power
limit, ms/step median [min-max], warm-up seconds, the final caps, the pm
rescue need or the Barnes–Hut needs, and, unless ``--no-phases``, the
per-phase table (:func:`print_phases`), which is measured on the card only.

Barnes–Hut: before the warm-up the caps are fitted to the scene by
lists-only passes (:func:`~tpu_nbody_torch.accuracy.fitted_bh_pass` with
``evaluate=False``) from :func:`bench_config`'s, then tightened to the
needs of the last of them (:meth:`~tpu_nbody_torch.engine.Caps.tightened`):
the grown caps, at least twice each need, made a pass three times slower
than tight ones on one H100 at N = 1M. The warm-up is then the JAX
bench's (``step(steps)``, ``tighten_caps()``, ``step(steps)`` again if
they changed). A retune inside a timed repeat raises.

Not ported from the JAX bench: its ``step_stream`` switch, worker wait and
retry-then-shrink loop, which work around its TPU backend; a failure
raises. It runs on the card unless ``--device cpu`` is given, and raises
"CUDA is not available" without one.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time

import torch

from tpu_nbody_torch import accuracy, engine, profiling
from tpu_nbody_torch import state as state_lib
from tpu_nbody_torch.config import Params, SimConfig
from tpu_nbody_torch.engine import Engine
from tpu_nbody_torch.ops import band, forces, mesh
from tpu_nbody_torch.ops import merge as merge_ops

# The Kotlin reference's derived interactive throughput (BASELINE.md:
# N = 12,500 at an assumed 60 FPS on a desktop CPU), the JAX bench's
# denominator of vs_baseline.
BASELINE_UPDATES_PER_SEC = 7.5e5
SEED = 3
SAMPLES = 4096          # bodies sampled for the force error
SAMPLES_SMALL = 256     # the same with --small
PHASE_REPS = 5          # CUDA-event timings a phase, after 2 warm-ups
_TAPS = {1: 1, 2: 4, 3: 9}            # cells a body touches
_PICK_BYTES = 13                      # a rescue partner: int64, score, flag
_F32, _C64 = 4, 8                     # bytes


def bench_config(n: int, solver: str, small: bool) -> SimConfig:
    """The JAX bench's ``SimConfig`` for ``n`` bodies (``bench.py``'s
    ``run_once``), field for field, less ``bh_stream_split``, which the
    port has no use for."""
    cap = 1 << (n - 1).bit_length()
    big_bh = solver == "bh" and not small
    return SimConfig(
        capacity=cap,
        max_depth=11 if small else 14,
        group_chunk=16 if small else 64,
        approx_cap=1024 if big_bh else 512,
        direct_body_cap=16384 if big_bh else 1024,
        frontier_cap=1024 if big_bh else 512,
        leaf_list_cap=2048 if big_bh else 256,
        bh_hier_cand_caps=(131072, 32768, 4096),
        group_cap=2080 if big_bh else 0,
        node_capacity=(1 << 20) if big_bh else 0,
        mesh_level=10 if small else 12,
        mesh_ny=0 if small else 2048,
        mesh_split=4.0 if small else 2.5,
        mesh_band=256 if small else 128,
        mesh_rescue=4 if small else 8,
        mesh_chunk=min(16384, cap),
        mesh_switch="poly4",
    )


def _fft_flops(points: int, real: bool) -> float:
    """5 N log2 N for a complex transform of N points, half for a real
    one."""
    return (2.5 if real else 5.0) * points * math.log2(points)


def phase_work(cfg: SimConfig, n: int, heavy_cap: int = 64,
               select_groups: int = 0, heavy_need: int | None = None,
               interp_cells: int | None = None,
               rescue_pairs: int | None = None) -> dict:
    """Flops and bytes of each P3M phase of the bench at ``cfg`` with ``n``
    alive bodies, counted from the shapes alone (pure Python) but for the
    selection's ``select_groups`` and the rescue's ``rescue_pairs``, which
    the caller counts: each input
    byte read once and each output byte written once, whatever the code
    reads again. Per call of the phase: the table scales the re-sort by
    1/``pm_resort_every`` and the kernel hats by 1/steps. Dead bodies sort
    behind the alive ones and carry no work. The band row is
    :func:`band.pair_work` of the ``n`` sorted bodies; the rescue is two
    rows: its selection (``rescue_select``: the block rows and boxes, then
    the box tests the selection kernel needs, :func:`mesh.select_work` of
    every block against every block with ``select_groups`` near groups of
    32 blocks, the kernel's counter; the bodies read once, the rows, boxes
    and the k partner indices, flags and scores written once) and its pair
    sum (``rescue_pairs``, the rescue kernel: the pairs the data needs,
    ``rescue_pairs`` from :func:`band.rescue_cutoff_pairs`, or, where None,
    the n·k·S of the ``mesh_rescue`` partner blocks of S bodies that each
    body's block holds, at the band's flops a pair, the rows and indices
    read once and the accelerations written once); the merge, a
    distance test of every body against each of min(``heavy_need``,
    ``heavy_cap``) heavies (:func:`merge.merge_work`: the tests the data
    needs; ``heavy_need`` None counts every slot), the bodies read and
    written once; the interpolation reads fx and fy at the
    ``interp_cells`` distinct cells the bodies touch
    (:func:`mesh.interp_work`; None counts the whole windows). The
    deposit is the fresh pass's block (:func:`mesh.deposit_work`): each
    body's cells and K products and adds into the ``occ`` rows of the
    padded grid the FFT reads, the block written once (its zeros
    included); the FFT convolution reads the
    occupied density rows and the potential kernel and writes the
    potential rows the stencil keeps; the FD gradient reads those rows at
    the nw + 7 + reach columns the stencil touches and writes fx and fy.
    The sort counts no arithmetic: it is integer work, bounded by its
    bytes."""
    nw = 1 << cfg.mesh_level
    ny = cfg.mesh_ny or nw
    grid = 2 * nw
    grid_y = grid if ny == nw else 2 * ny
    cols = grid // 2 + 1                    # rfft columns
    K = _TAPS[cfg.mesh_order]
    reach = 1 if cfg.mesh_order == 3 else 0
    mx, my = nw + 1 + reach, ny + 1 + reach  # force-grid window
    occ = ny + 2 + reach                     # rho rows holding mass
    kept = ny + 7 + reach                    # potential rows of the stencil
    S, k = cfg.mesh_band, cfg.mesh_rescue
    blocks = -(-n // S)
    pair_flops = band._PAIR_FLOPS[cfg.mesh_switch]
    body_in = n * (2 * _F32 + _F32 + 1)      # pos, mass, alive
    acc_out = n * 2 * _F32
    weights = n * (_F32 + K * _F32)          # base cell and K weights
    fgrid = 2 * mx * my * _F32               # fx and fy
    if rescue_pairs is None:
        rescue_pairs = n * k * S
    conv = (occ * _fft_flops(grid, True) + kept * _fft_flops(grid, True)
            + 2 * cols * _fft_flops(grid_y, False) + 6 * grid_y * cols)
    hats = (2 * _fft_flops(grid_y * grid, True) + 20 * grid_y * grid
            + 26 * grid_y * cols)
    return {
        "sort": dict(flops=0, bytes=body_in + body_in + n * 8),
        "deposit": mesh.deposit_work(n, K, occ * grid),
        "fft": dict(flops=conv,
                    bytes=occ * grid * _F32 + grid_y * cols * _C64
                    + kept * grid * _F32),
        "fd": mesh.fd_work(my, mx),
        "interp": dict(flops=2 * (2 * K - 1) * n,
                       bytes=(fgrid if interp_cells is None
                              else 2 * _F32 * interp_cells)
                       + weights + acc_out),
        "band": band.pair_work(n, S, cfg.mesh_switch),
        "rescue_select": dict(flops=mesh.select_work(
                                  blocks, blocks, k, select_groups,
                                  boxes=blocks)["flops"],
                              bytes=body_in + blocks * (S * 3 + 4) * _F32
                              + blocks * k * _PICK_BYTES),
        "rescue_pairs": dict(pairs=rescue_pairs,
                             flops=rescue_pairs * pair_flops,
                             bytes=n * 3 * _F32 + blocks * k * _PICK_BYTES
                             + acc_out),
        "merge": merge_ops.merge_work(
            n, heavy_cap if heavy_need is None else heavy_need, heavy_cap),
        "kernel_hats": dict(flops=hats, bytes=3 * grid_y * cols * _C64),
    }


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_repeats(eng: Engine, steps: int, repeats: int):
    """``repeats`` timed ``eng.step(steps)`` calls: (device ms or None on
    the CPU, host ms), one each a call. Raises if a call retuned a cap."""
    dev = eng.device
    cuda = dev.type == "cuda"
    dev_ms, host_ms = [], []
    for r in range(repeats):
        caps, heavy = eng.caps, eng.merge_heavy_cap
        _sync(dev)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        eng.step(steps)
        if cuda:
            end.record()
        _sync(dev)
        host_ms.append(1e3 * (time.perf_counter() - t0))
        if cuda:
            dev_ms.append(start.elapsed_time(end))
        if eng.caps != caps or eng.merge_heavy_cap != heavy:
            raise RuntimeError(
                f"timed repeat {r}: a retune ran inside it (caps {caps} -> "
                f"{eng.caps}, merge_heavy_cap {heavy} -> "
                f"{eng.merge_heavy_cap}); the warm-up did not settle them")
    return (dev_ms if cuda else None), host_ms


def _spread(ms: list, steps: int) -> tuple:
    """(median, min, max) ms a step."""
    return (statistics.median(ms) / steps, min(ms) / steps,
            max(ms) / steps)


def _label(solver: str, theta: float, err: dict) -> str:
    e = f"force err mean {err['mean']:.2g} p99 {err['p99']:.2g}"
    if solver == "bh":
        return f"theta={theta}, {e}"
    if solver == "allpairs":
        return f"exact, {e}"
    return e


def run(args) -> dict:
    """Build the engine, warm up, time the repeats and measure the force
    error (module docstring). Returns the report :func:`main` prints."""
    dev = state_lib.check_device(args.device)
    cfg = bench_config(args.n, args.solver, args.small)
    params = Params.default(theta=args.theta)
    eng = Engine(cfg, params, solver=args.solver, integrator=args.integrator,
                 seed=SEED, device=dev)
    n2 = args.n // 5
    eng.reset_default_scene(n1=args.n - n2, n2=n2)

    warmup = []         # (what, seconds) of each part of the warm-up

    def part(what, fn):
        t = time.perf_counter()
        before = eng.caps, eng.merge_heavy_cap
        fn()
        _sync(dev)
        if what.startswith("step") and (eng.caps,
                                         eng.merge_heavy_cap) != before:
            what += " (retuned)"
        warmup.append((what, time.perf_counter() - t))

    t0 = time.perf_counter()
    if args.solver == "bh":
        st = eng.state

        def fit():
            _, need, caps = accuracy.fitted_bh_pass(
                st.pos, st.mass, st.alive, cfg, params, eng.caps,
                evaluate=False)
            eng.set_caps(caps.tightened(need))
        part("lists-only cap fit", fit)
    part(f"step({args.steps})", lambda: eng.step(args.steps))
    if args.solver == "bh" and eng.tighten_caps():
        part(f"step({args.steps}) after tighten_caps",
             lambda: eng.step(args.steps))
    warmup_s = time.perf_counter() - t0

    dev_ms, host_ms = _timed_repeats(eng, args.steps, args.repeats)
    ms = _spread(dev_ms or host_ms, args.steps)
    n_alive = int(eng.state.n_alive())
    rate = n_alive / (ms[0] * 1e-3)
    g = torch.Generator(device=dev).manual_seed(SEED)
    err = accuracy.sampled_force_error(
        eng.state, cfg, params, SAMPLES_SMALL if args.small else SAMPLES, g,
        solver=args.solver, caps=eng.caps if args.solver == "bh" else None)
    result = {
        "metric": f"body-updates/sec (N={n_alive}, solver={args.solver}, "
                  f"{_label(args.solver, args.theta, err)}, merge on, "
                  f"device={dev.type})",
        "value": round(rate, 1),
        "unit": "bodies/s",
        "vs_baseline": round(rate / BASELINE_UPDATES_PER_SEC, 2),
    }
    return dict(result=result, engine=eng, n_alive=n_alive,
                ms_per_step=ms, host_ms_per_step=_spread(host_ms, args.steps),
                warmup_s=warmup_s, warmup_parts=warmup, force_error=err,
                card=profiling.card_info(dev) if dev.type == "cuda" else None)


def _report(args, rep: dict, file):
    eng, err = rep["engine"], rep["force_error"]
    card = rep["card"]
    print(f"# device={eng.device.type}"
          + (f" card={card['name']} power limit={card['power_limit']}"
             if card else ""), file=file)
    med, lo, hi = rep["ms_per_step"]
    how = "CUDA events" if card else "host clock, the CPU"
    print(f"# solver={args.solver} integrator={args.integrator} "
          f"N={rep['n_alive']} capacity={eng.cfg.capacity} "
          f"steps={args.steps} repeats={args.repeats} ms/step median "
          f"{med:.3f} [{lo:.3f}-{hi:.3f}] ({how})", file=file)
    if card:
        hm, hl, hh = rep["host_ms_per_step"]
        print(f"# host clock of the same repeats: ms/step median {hm:.3f} "
              f"[{hl:.3f}-{hh:.3f}]", file=file)
    print(f"# warmup={rep['warmup_s']:.2f}s ("
          + ", ".join(f"{what} {sec:.2f} s"
                      for what, sec in rep["warmup_parts"])
          + f") caps={eng.caps} merge_heavy_cap={eng.merge_heavy_cap}",
          file=file)
    if args.solver == "pm":
        print(f"# last_rescue_need={eng.last_rescue_need} (mesh_rescue "
              f"{eng.cfg.mesh_rescue}) last_mesh_oob={eng.last_mesh_oob} "
              f"last_heavy_need={eng.last_heavy_need}", file=file)
    if args.solver == "bh":
        print(f"# bh needs {eng.last_stats}", file=file)
    print(f"# force error vs exact ({err['samples']} sampled bodies, seed "
          f"{SEED}): mean {err['mean']:.4e} p50 {err['p50']:.4e} p99 "
          f"{err['p99']:.4e} max {err['max']:.4e}", file=file, flush=True)


class _PairClock(profiling.Recorder):
    """A recorder with a CUDA event at each mark that also sums the
    Barnes–Hut pass's pair counts."""

    def __init__(self):
        super().__init__(events=True)
        self.padded = []
        self.needed = []

    def pairs(self, padded, needed):
        self.padded.append(padded)
        self.needed.append(needed)


def _pm_phases(eng: Engine, steps: int) -> tuple:
    """(rows, note) of the P3M phases: (name, ms, work, scale) of each, run
    alone on the Hilbert-sorted state, and a line on the rescue's pairs.
    The rescue is its selection (the block rows and boxes and the
    selection kernel) and its base tier's pair kernel; a two-tier rescue's
    hot tier (``mesh_rescue_hot``, off in the bench's configuration) adds
    no selection and has no pair row. The pair row's bound counts the
    pairs within 2a (:func:`band.rescue_cutoff_pairs`); the note sets them
    beside the pairs of the sub-tiles the kernel walks
    (:func:`band.rescue_near_tiles`, its counter) and gives the plain
    version's time."""
    cfg, params, st, dev = eng.cfg, eng.params, eng.state, eng.device
    origin, side = engine._root(cfg)
    nw, ny, grid, grid_y, h, a, morigin = mesh._pm_geometry(
        origin, side, cfg.mesh_level, cfg.mesh_ny, cfg.mesh_split)
    order, S = cfg.mesh_order, cfg.mesh_band
    chunk = min(cfg.mesh_chunk, cfg.capacity)
    reach = 1 if order == 3 else 0
    spos, smass, salive, _ = mesh._hilbert_sort(st.pos, st.mass, st.alive,
                                                origin, side)
    kernel = engine._kernel_hats(cfg, params, dev)
    rho, base, w = mesh.deposit_cells(spos, smass, morigin, h, nw, grid,
                                      order, ny=ny, grid_y=grid_y)

    def fft():
        return mesh._conv_potential(rho, kernel[2], ny, grid, grid_y,
                                    extra=reach)

    pw = fft()
    fx, fy = mesh._fd_gradient(pw, h, nw, ny, reach)
    # the rescue's two halves, on the masses the pass gives it (dead at 0)
    live_mass = torch.where(salive, smass, 0.0)
    sel = mesh._rescue_select(spos, live_mass, salive, a, band=S,
                              k=cfg.mesh_rescue, chunk=chunk,
                              count_groups=True)
    tid = torch.arange(sel.rows.shape[0], device=dev)
    pvalid = sel.mval > 0
    rescue_args = (sel.rows, tid, sel.rows, sel.midx, pvalid)
    needed = band.rescue_cutoff_pairs(*rescue_args, a, cfg.mesh_switch)
    near = band.rescue_near_tiles(*rescue_args, params.soft2, a,
                                  cfg.mesh_switch)
    every = int(pvalid.sum()) * S * S
    plain_ms = profiling.timed_ms(lambda: band.rescue_pair_sum_ref(
        *rescue_args, params.soft2, a, cfg.mesh_switch, chunk=sel.cb),
        reps=1, warmup=0)
    note = (f"# rescue pairs: {near.pairs:.4e} walked by the rescue kernel "
            f"({near.tiles} sub-tile pairs) against {needed:.4e} needed "
            f"within 2a"
            + (f" ({near.pairs / needed:.3f}x)" if needed else "")
            + f"; {every:.4e} in the valid partner blocks; the plain "
            f"version {plain_ms:.4f} ms (one call)")
    K = max(1, cfg.pm_resort_every)
    _, heavy_need = merge_ops.merge_bodies(st, params,
                                           heavy_cap=eng.merge_heavy_cap)
    work = phase_work(cfg, int(st.n_alive()), eng.merge_heavy_cap,
                      select_groups=int(sel.groups),
                      heavy_need=int(heavy_need),
                      interp_cells=mesh.interp_work(
                          base, w.shape[1], nw, fx.shape[1])["cells"],
                      rescue_pairs=needed)
    phases = [
        (f"hilbert sort (/{K} steps)", "sort", 1.0 / K,
         lambda: mesh._hilbert_sort(st.pos, st.mass, st.alive, origin,
                                    side)),
        (f"cells + deposit {_TAPS[order]} taps (kernel)", "deposit", 1.0,
         lambda: mesh.deposit_cells(spos, smass, morigin, h, nw, grid,
                                    order, ny=ny, grid_y=grid_y)),
        ("FFT convolution", "fft", 1.0, fft),
        ("FD gradient (kernel)", "fd", 1.0,
         lambda: mesh._fd_gradient(pw, h, nw, ny, reach)),
        ("interpolation (kernel)", "interp", 1.0,
         lambda: mesh._interp_packed(fx, fy, base, w, nw, ny=ny)),
        (f"band S={S} (kernel)", "band", 1.0,
         lambda: band.band_short_range(spos, smass, params.soft2, a,
                                       band=S, chunk=chunk,
                                       switch=cfg.mesh_switch)),
        (f"rescue select k={cfg.mesh_rescue} (kernel)", "rescue_select",
         1.0,
         lambda: mesh._rescue_select(spos, live_mass, salive, a, band=S,
                                     k=cfg.mesh_rescue, chunk=chunk)),
        (f"rescue pairs k={cfg.mesh_rescue} (kernel)", "rescue_pairs", 1.0,
         lambda: band.rescue_pair_sum(*rescue_args, params.soft2, a,
                                      cfg.mesh_switch, chunk=sel.cb)),
        ("merge (kernel)", "merge", 1.0,
         lambda: merge_ops.merge_bodies(st, params,
                                        heavy_cap=eng.merge_heavy_cap)),
        (f"kernel hats (/{steps} steps)", "kernel_hats", 1.0 / steps,
         lambda: engine._kernel_hats(cfg, params, dev)),
    ]
    return [(name, profiling.timed_ms(fn, reps=PHASE_REPS), work[key], scale)
            for name, key, scale, fn in phases], note


def bh_kernel(cfg) -> str:
    """The hand kernel that evaluates a Barnes–Hut pass of ``cfg``: the
    hier traversal's ``bh_hier``, or the dense and bfs ``bh_pairs``."""
    return ("bh_hier" if engine._resolve_traversal(cfg) == "hier"
            else "bh_pairs")


def _bh_phases(eng: Engine, steps: int) -> tuple:
    """(rows, pairs computed, pairs needed) of one Barnes–Hut pass at the
    engine's caps, timed by phase with CUDA events. The evaluate row names
    the kernel of the pass's traversal; the pairs computed are the pair
    slots the dense blocks evaluate (padding included) or the pairs the
    hier kernel's CTAs walk (its own counter)."""
    st, n = eng.state, int(eng.state.n_alive())
    clock = _PairClock()
    _, need, _ = accuracy.fitted_bh_pass(st.pos, st.mass, st.alive, eng.cfg,
                                         eng.params, eng.caps, probe=clock)
    ms = clock.ms()
    needed = int(torch.stack(clock.needed).sum()) if clock.needed else 0
    padded = sum(int(x) for x in clock.padded)
    nodes = need.node_need * 14 * _F32       # the node table's rows
    body_in = n * (2 * _F32 + _F32 + 1)
    rows_out = n * 4 * _F32                  # the sorted body rows
    work = {
        "build": dict(flops=0, bytes=body_in + nodes + rows_out),
        "groups": dict(flops=0, bytes=nodes + need.group_need * 25),
        "lists": dict(flops=0, bytes=nodes + need.group_need * 16),
        "evaluate": dict(pairs=needed,
                         flops=needed * forces._PAIR_FLOPS[2],
                         bytes=rows_out + nodes + n * 2 * _F32),
        "assemble": dict(flops=0, bytes=2 * n * 2 * _F32 + n * _F32),
    }
    names = {"evaluate": f"evaluate ({bh_kernel(eng.cfg)} kernel)"}
    rows = [(names.get(name, name), ms[name], work[name], 1.0)
            for name in work if name in ms]
    return rows, padded, needed


def _allpairs_phases(eng: Engine, steps: int) -> list:
    st, params = eng.state, eng.params
    n = int(st.n_alive())
    live = torch.where(st.alive, st.mass, 0.0)
    ms = profiling.timed_ms(lambda: forces.accel_allpairs(
        st.pos, live, params.G, params.soft2), reps=PHASE_REPS)
    return [(f"all-pairs kernel ({st.capacity} x {st.capacity} slots)", ms,
             forces.pair_work(n, n, 2), 1.0)]


def print_phases(eng: Engine, step_ms: float, steps: int,
                 file=None) -> list | None:
    """The per-phase table on ``file``, the port of the JAX bench's
    ``print_roofline``. Each phase runs alone on the bench's final state
    and is timed with CUDA events (median of :data:`PHASE_REPS` after 2
    warm-ups; Barnes–Hut: the phases of one pass). Each row gives its ms,
    its bound (:func:`profiling.bounds` of its work: :func:`phase_work` for
    pm, ``forces.pair_work`` for all-pairs) and the share of the bound it
    reaches; then the sum against the median step and the useful flops
    against the card's float32 peak. Returns the rows as dicts, or None
    without a card: phase times come only from the card. ``file``
    defaults to ``sys.stderr``."""
    file = file or sys.stderr
    if eng.device.type != "cuda":
        print("# per-phase table: not measured without a card "
              f"(device={eng.device.type})", file=file, flush=True)
        return None
    return _phase_table(eng, step_ms, steps, file,
                        profiling.card_info(eng.device))


def _phase_table(eng: Engine, step_ms: float, steps: int, file,
                 card: dict) -> list:
    """The table of :func:`print_phases` on the engine's device."""
    extra = ""
    if eng.solver == "pm":
        rows, extra = _pm_phases(eng, steps)
        what = ("each P3M phase alone on the Hilbert-sorted final state, "
                f"median of {PHASE_REPS} after 2 warm-ups")
    elif eng.solver == "bh":
        rows, padded, needed = _bh_phases(eng, steps)
        what = "the phases of one Barnes–Hut pass at the final caps"
        how = ("walked by the bh_hier kernel" if bh_kernel(eng.cfg)
               == "bh_hier" else "(padding included)")
        extra = (f"# pairs evaluated {padded:.4e} {how} "
                 f"against {needed:.4e} needed"
                 + (f" ({padded / needed:.2f}x)" if needed else ""))
    else:
        rows = _allpairs_phases(eng, steps)
        what = (f"the all-pairs force pass, median of {PHASE_REPS} after 2 "
                f"warm-ups")
    print(f"# per-phase table ({what}; CUDA events; bound: the larger of "
          f"flops / {profiling.PEAK_FLOPS / 1e12:.0f} TFLOP/s and bytes / "
          f"{profiling.PEAK_BYTES / 1e12:.2f} TB/s; {card['name']}, power "
          f"limit {card['power_limit']}):", file=file)
    out, total, useful = [], 0.0, 0.0
    for name, ms, work, scale in rows:
        scaled = dict(flops=work["flops"] * scale,
                      bytes=work["bytes"] * scale)
        b = profiling.bounds(scaled, ms * scale)
        total += ms * scale
        useful += scaled["flops"]
        out.append(dict(name=name, ms=ms * scale, **scaled, **b))
        print(f"#   {name:34s} {ms * scale:10.4f} ms  bound "
              f"{b['bound_ms']:9.5f} ms ({b['bound_by']:10s}) "
              f"{b['pct_of_bound']:7.3f}% of bound", file=file)
    print(f"#   {'sum of phases':34s} {total:10.4f} ms  against the median "
          f"step {step_ms:.4f} ms (the rest: kick, drift, the stats read, "
          f"launch gaps, and the seed pass a kdk_reuse step(n) adds)",
          file=file)
    achieved = useful / (step_ms * 1e-3)
    print(f"# useful flops {useful:.4e} a step -> {achieved / 1e12:.4f} "
          f"TFLOP/s = {100.0 * achieved / profiling.PEAK_FLOPS:.4f}% of the "
          f"{profiling.PEAK_FLOPS / 1e12:.0f} TFLOP/s float32 peak (no phase "
          f"uses the tensor cores); power limit {card['power_limit']}",
          file=file)
    if extra:
        print(extra, file=file)
    file.flush()
    return out


def main(argv=None) -> dict:
    """Parse ``argv``, run the bench, print the JSON line on stdout and the
    rest on stderr. Returns the report: ``result`` (the JSON line as a
    dict), ``engine``, ``ms_per_step`` (median, min, max), ``warmup_s``,
    ``force_error`` and ``phases`` (None without a card or with
    ``--no-phases``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--theta", type=float, default=0.5)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--solver", default="pm",
                    choices=["pm", "bh", "allpairs"])
    ap.add_argument("--integrator", default="kdk_reuse")
    ap.add_argument("--small", action="store_true",
                    help="tiny config for CPU smoke runs")
    ap.add_argument("--no-phases", action="store_true",
                    help="skip the per-phase table (stderr)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed step(steps) calls; the median is reported")
    args = ap.parse_args(argv)
    if args.n < 2 or args.steps < 1 or args.repeats < 1:
        ap.error("--n must be at least 2, --steps and --repeats at least 1")
    if args.small:
        args.n = min(args.n, 20_000)
        args.steps = min(args.steps, 5)

    rep = run(args)
    print(json.dumps(rep["result"]), flush=True)
    _report(args, rep, sys.stderr)
    rep["phases"] = None
    if not args.no_phases:
        rep["phases"] = print_phases(rep["engine"], rep["ms_per_step"][0],
                                     args.steps)
    return rep


if __name__ == "__main__":
    main()
