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
  the configuration of ``bench.py --solver bh``, caps as configured:
  step(1) to warm up and settle the cap retune, tighten_caps(), step(1)
  timed, launching the hier kernel and no other; then no cap overflowing,
  the hier kernel on a pass at the engine's caps (below), the force error
  of a fresh pass, the traversal needs on three scenes at N = 1,000,000,
  and at N = 65,536 a pass at theta = 1e-3 against the all-pairs kernel,
  the pair kernel on the dense traversal's shape (below) and dense against
  hier (path G times Barnes–Hut by phase, from fitted caps);
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
  all black, one launch of csrc/render.cu a frame, and the kernel's splat
  agrees between two renders and with the plain splat on the CPU, sprites
  off and at SPRITE_SCALE (the additive sums before the clip, within
  RENDER_TOL of the brightest pixel; the 3D projection within 1e-3 px),
  timed with CUDA events; the kernel at the frames cell's shape (the
  world at 2400 x 800, its sprites) against its bound, the plain version
  and the 21-pass index_add_ render it replaced (``_splat_row``); a
  render_movie of the main path's configuration (8 frames of 4 steps)
  leaves uint8 frames on the card that differ from first to last;
* drift: ``tpu_nbody_torch.examples.drift_benchmark`` for solver="allpairs"
  at n = 2000, 10,000 steps of dt = 1e-4 with kdk_reuse and merging off,
  failing where the relative energy or L_z drift is above DRIFT_LIMIT;
* sharded (path F): P_RANKS ranks as threads of this process on the one
  card (``parallel.mesh.make_mesh(P_RANKS)``), every rank on its default
  stream. F1: ``ShardedEngine(solver="pm", integrator="kdk_reuse")`` on
  the main path's configuration at N = 1M, step(8) to warm up and step(8)
  timed (P band launches a force pass), its needs, the force error of one
  sharded pass of the gathered state and its difference from the
  one-device pass, one pass by phase on rank 0, the pass on one rank
  against P, the band kernel at a rank's rows plus halos; F2:
  ``merger10m --n 10000000 --devices 4 --steps 2``; F3: sharded all-pairs
  at N = 2^18, one force pass against the one-device kernel (within 1e-5
  of max |a|) and step(2) slot by slot against the one-device all-pairs
  engine (P² launches a force pass), the all-pairs kernel at a ring tile;
  F4: sharded Barnes–Hut at N = 65,536, its force error and LET needs,
  the all-pairs kernel at a LET import's shape; F5:
  ``dryrun_multichip(8)`` and one ``entry()`` step against the CPU's;
* bench (path G): ``python -m tpu_nbody_torch.bench`` in process
  (``bench.main``) three times: the default (pm at N = 1,000,000, 20
  steps), ``--solver allpairs`` and ``--solver bh --steps 2 --repeats 3``;
  each prints one JSON line with the four keys, a mean force error within
  its limit, no retune inside a timed repeat (the bench raises) and a
  per-phase table with a bound and a share of it on every row; then one
  step(20) of the pm bench's engine under ``profiling.trace``: the
  device's busy and idle shares of the step, and the host's enqueue time
  a step;
* cuda_tests: ``python -m pytest --noconftest -m cuda
  tests/test_torch_package.py tests/test_torch_rescue_kernel.py
  tests/test_torch_rescue_select.py tests/test_torch_rescue_cull.py
  tests/test_torch_bh_pairs.py
  tests/test_torch_bh_hier.py tests/test_torch_bh_lists.py
  tests/test_torch_tree_kernel.py tests/test_torch_merge_kernel.py
  tests/test_torch_interp_kernel.py tests/test_torch_deposit_kernel.py
  tests/test_torch_fd_kernel.py tests/test_torch_render_kernel.py -q``
  in a child process, which must
  pass.

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
   the rescue selection kernel against its plain version on the sorted
   scene (every block against every block at the main path's S and k,
   bit for bit: counts, needs, scores, the valid partners, near groups),
   with the union table of the block-box kernel and with the union
   kernel's, timed beside the whole selection's device, idle-card and
   host-enqueue times and its device operations; the block rows, boxes and union table kernel bit for bit
   on the same scene and on a ragged tail; the union kernel bit for bit
   against its plain version on the block boxes; the
   rescue kernel against its plain version on the same scene (the main
   path's partner choice, every block in one launch), and against itself
   without its sub-tile skip and on a repeat bit for bit, its walked
   counter against the plain count, its other launch shapes timed; the
   Barnes–Hut pair kernel against its plain version on one group of a
   dense pass at N = 65,536 (its two launches, accepted nodes and direct
   partners, cut to the group with the most nonzero masses; the kernel
   also on the whole evaluation chunk; both with the plan's splits, the
   same bits from two calls, timed a call and on the device beside one
   split), within the same 1e-5; the
   hier kernel on a pass at N = 1M with path D's caps: the pass against
   the same pass through the masked-dense route (the plain evaluation
   with the pair kernel) within 1e-5 of max |a| and with the same needs,
   its per-group counts of accepted nodes and direct bodies against the
   masks' exactly, its sums against the plain version (one run of the
   whole pass, seconds) and on the chunk with the most direct bodies,
   within the same 1e-5, timed over the whole pass; the lists kernel at
   the Barnes–Hut cell's shape (BH_CELL) against its plain version bit for
   bit, timed on the device beside its bytes bound and the plain
   version's time; the tree build at the same state against its plain
   version (every integer field and the geometry bit for bit, mass and
   centre of mass within 1e-6), timed on the device whole and without
   its ``argsort``, beside its bytes bound (``tree.build_work``) and the
   plain build's time; the interpolation
   kernel against its plain version bit for bit on the sorted scene (the
   fresh pass from the force-grid windows in CIC, NGP and TSC, and path
   B's carried table of [T | dT] lanes with frac), the CIC pass timed
   beside ``torch.nn.functional.grid_sample`` as a yardstick; the merge
   kernel against its plain version (the same alive flags and heavy_need,
   masses within MERGE_RTOL) on a synthetic scene of 2^20 bodies with
   chains of heavies and more heavies than the cap of 64, and on the main
   path's state after its steps, each call one device operation, timed
   there; the deposit kernel against
   its plain versions on the sorted scene in CIC, NGP and TSC (the cells
   of both cell entries bit for bit, rho of every entry within RHO_RTOL a
   cell and MASS_RTOL of the total: the fused entry's block of the rows
   the FFT reads and of a sharded rank's ``occ_p`` against the plain
   grid's leading rows, the entry from given cells from int32 and int64
   cells), the CIC pass timed with its block's zeroing and counted in
   device operations, beside the block's zeroing alone and ``index_add_``
   as a yardstick, and on a clustered scene against a float64 sum within
   CLUSTER_RHO_RTOL a cell; the FD-gradient kernel bit for bit on the
   potential rows of each order's deposit, timed beside ``conv2d`` as a
   yardstick; in path C the deposit in each ``run_compress`` mode against
   the plain one;
5. sets every launch count to 0 just before each path and reads it just
   after, checking the launches each path must make (one band, one
   rescue, one rescue selection, one block-box build, one interpolation,
   one deposit and one FD-gradient launch per P3M force pass, one merge
   launch set a step of an engine that merges, two rescues, two block-box
   builds and three selections a rank's pass on the sharded P3M and two
   merge launch sets a rank's step, one all-pairs launch per all-pairs
   force pass, tree, hier, lists and merge kernel launches and no other in
   the Barnes–Hut steps, and on every path one lists launch a hier pass,
   lists-only passes included, and one tree launch a tree build), finite
   state and no growth of n_alive;
6. measures the force error against the exact all-pairs kernel on 4096
   sampled alive bodies (tpu_nbody_torch.accuracy), failing where a mean
   is over its limit.

The kernels line gives, per kernel, ``launches`` (for the band, rescue,
selection, block-box, interpolation, deposit, FD-gradient and merge
kernels the main path's three step(20) calls; for the
all-pairs kernel path E's run at 2^20 bodies, the path it carries: the
P3M main path launches it only in the force error after its steps; for
the hier, lists and tree kernels path D's steps; for the pair kernel the
dense force
error at N = 65,536, the Barnes–Hut main path being hier; for the union
kernel path F1, whose export and import selections take their tables
from it, the main path's from the block-box kernel) and
``launches_by_path``, which holds path G's runs as ``bench_pm``,
``bench_allpairs`` and ``bench_bh`` (warm-up, timed repeats, force error
and phase table). The three rescue kernels, the four Barnes–Hut kernels,
the merge, the interpolation, the deposit and the FD gradient have no
Pallas original: ``replaces`` names the XLA code they stand for. The
interpolation's ``library_ms`` is ``grid_sample``'s time on the same
windows and positions, the deposit's one ``index_add_`` into the zeroed
block, the FD gradient's one ``conv2d``: yardsticks the port never calls;
the merge's is null (no PyTorch call computes it); the tree build's
repeats its plain build on the card (no PyTorch call computes it either).
Each kernel's bound_ms is the larger of its flops over the float32 peak and its
bytes over the memory rate (``pair_work``, ``rescue_pair_work`` in its
module, ``hier_pair_work`` in traverse, ``select_work`` and
``block_boxes_work`` in mesh), counted for the pairs this run's data
needs (the rescue's pairs within 2a of its valid partner blocks,
``band.rescue_cutoff_pairs``, the pair kernel's nonzero masses, the hier groups' members times
their accepted nodes and direct bodies, the selection's union box of each
target and group of 32 blocks and the members of the near groups, from
the kernels' counters, the merge's distance tests of every alive body
against min(heavy_need, cap) heavies, ``merge.merge_work``; the
interpolation's window cells its bodies touch, ``mesh.interp_work``; the
deposit's bodies, cells and the block of the rows the FFT reads,
``mesh.deposit_work``; the FD
gradient's source rows and windows, ``mesh.fd_work``);
rsqrt_floor_ms is its
pairs over the rsqrt unit's rate (16 a clock per SM at the card's highest
SM clock), a second floor beside it.

It prints one JSON line describing the kernels, then, as its last line,
{"ok": true, "device": {...}}. Any failure raises and exits non-zero
without that line. It imports nothing of jax or of tpu_nbody.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

from tpu_nbody_torch.kernels import _build
from tpu_nbody_torch.profiling import (Recorder, bounds, card_info,
                                       device_ms, device_ops, timed_ms)

N = 1_000_000       # bodies of the two-disk scene
N_SMALL = 65_536    # bodies of the kdk and euler all-pairs runs
STEPS = 20          # steps per Engine.step call of the P3M paths
TOL = 1e-5          # kernel vs plain: max |diff| <= TOL * max |plain|
# deposit kernel vs plain: each cell and the total mass within these
# relative differences (sums of positive terms, the kernel's atomics in
# another order)
RHO_RTOL = 1e-5
MASS_RTOL = 1e-6
# the deposit kernel on the clustered scene (up to ~37,000 products a cell)
# against a float64 sum of the same float32 products: each cell within this
# relative difference. The kernel's own float32 rounding read 1.0e-5 there
# against the plain float32 sum; a warp's pre-sum of 32 bodies lost from
# such a cell is 8.6e-4 of it.
CLUSTER_RHO_RTOL = 1e-4
# merge kernel vs plain: the same alive flags and heavy_need, masses within
# this relative difference (the kernel sums the gains with atomics)
MERGE_RTOL = 1e-6
MERGE_HEAVIES = 2000  # heavies of the synthetic merge scene (cap 64)
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
SPRITE_SCALE = 1e-4  # the viewer's and the frames cell's size_mass_scale
FRAMES_VIEW = (2400, 800)   # the frames cell's frame: the world at zoom 1
MOMENTUM_TOL = 1e-4  # path E: |p - p0| <= this * sum m |v|
COM_TOL = 1e-2      # path E: |com - (com0 + t p0 / M)| in px
DRIFT_LIMIT = 1e-3  # relative energy and L_z drift of the all-pairs run
DRIFT_ARGS = ["--solver", "allpairs", "--n", "2000", "--steps", "10000",
              "--report-every", "2500", "--dt", "1e-4", "--integrator",
              "kdk_reuse"]
# path F: the sharded paths, P thread ranks on the one card
P_RANKS = 4
N_F3 = 1 << 18      # bodies of the sharded all-pairs check
N_F4 = 65_536       # bodies of the sharded Barnes–Hut check
F_STEPS = 8         # steps per ShardedEngine.step call of path F1
MERGER_ARGS = ["--n", "10000000", "--devices", str(P_RANKS), "--steps", "2"]
DRYRUN_RANKS = 8
# path D: Engine.step calls (label, steps): the warm-up, then, after
# tighten_caps, the timed one
BH_STEPS = (("warm-up", 1), ("timed", 1))
# path G: the bench's command lines; the kernels each run must launch; the
# limit of its mean force error (all-pairs: the kernel against itself)
BENCH_RUNS = {
    "pm": ([], ("band", "rescue", "rescue_select", "boxes", "interp",
                "deposit", "fd", "merge", "allpairs"), ERR_LIMIT),
    "allpairs": (["--solver", "allpairs"], ("allpairs",), TOL),
    "bh": (["--solver", "bh", "--steps", "2", "--repeats", "3"],
           ("allpairs", "bh_tree", "bh_hier", "bh_lists"), BH_ERR_LIMIT),
}
# the first words of each per-phase row the bench must print
BENCH_PHASES = {
    "pm": ("hilbert sort", "cells + deposit", "FFT convolution",
           "FD gradient", "interpolation", "band", "rescue select",
           "rescue pairs", "merge", "kernel hats"),
    "allpairs": ("all-pairs kernel",),
    "bh": ("build", "groups", "lists", "evaluate (bh_hier kernel)",
           "assemble"),
}
CUDA_TESTS = [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
              "tests/test_torch_package.py",
              "tests/test_torch_rescue_kernel.py",
              "tests/test_torch_rescue_select.py",
              "tests/test_torch_rescue_cull.py",
              "tests/test_torch_bh_pairs.py", "tests/test_torch_bh_hier.py",
              "tests/test_torch_bh_lists.py",
              "tests/test_torch_tree_kernel.py",
              "tests/test_torch_merge_kernel.py",
              "tests/test_torch_interp_kernel.py",
              "tests/test_torch_deposit_kernel.py",
              "tests/test_torch_fd_kernel.py",
              "tests/test_torch_render_kernel.py", "-q"]
# the Barnes–Hut cell's configuration (its caps, groups and scene size),
# the shape of the lists kernel's line
BH_CELL = "nbody_bench/configs/collide1m_bh.json"
# hier passes of the running path (traverse._hier_accel calls, lists-only
# passes too): each launches csrc/bh_lists.cu once (``_count_hier_passes``)
HIER_PASSES = [0]
# tree builds of the running path (tree.build_tree calls; sharded ranks
# build from their threads): each launches csrc/bh_tree.cu's build once
# (``_count_builds``)
BUILDS = [0]
BUILDS_LOCK = threading.Lock()
DEVICE = "cuda"     # the card (a CPU rehearsal of the control flow
                    # patches this and the sizes above)
# the kernels every fresh P3M force pass launches once
P3M_PASS = ("band", "rescue", "rescue_select", "boxes", "interp", "deposit",
            "fd")
# merge launch sets an Engine.step(s) of the one-device engines: one a step
P3M_MERGES = {"merge": lambda s: s}
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
# the rescue kernel's target rows a lane (T), each timed at the main shape
RESCUE_SHAPES = (1, 2, 4)
# the numbers of the selection and merge designs these kernels replaced, at
# the main path's shape (PERF.md, section 6: their last final run, NVIDIA
# H100 80GB HBM3, 700 W), printed beside this run's: device ms, ms a call
# on an idle card, host enqueue ms; device launches read from their code
BEFORE_SELECT = dict(kernel_ms=0.0371, with_boxes=(
    "0.0473 ms on the device, 0.0957 a call, 0.1160 to enqueue, 3 device "
    "launches: boxes, a stats fill, the selection"))
BEFORE_MERGE = ("0.0287 ms on the device, 0.0566 a call, 6 device "
              "launches: a memset and five kernels")
# path C: SimConfig overrides of the main path's configuration, one fresh
# force pass each
KNOBS = {"heavy_direct": dict(pm_heavy_cap=16), "tsc": dict(mesh_order=3),
         "ngp": dict(mesh_order=1), "interlace": dict(mesh_interlace=True),
         "two_tier": dict(mesh_rescue=4, mesh_rescue_hot=16,
                          mesh_rescue_hot_cap=128)}


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
    ms = timed_ms(kernel_fn)
    plain_ms = timed_ms(plain_fn)
    print(f"{name}: max|diff| {err:.3e} (max|a| {scale:.3e}) kernel "
          f"{ms:.4f} ms plain {plain_ms:.4f} ms", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


class Paths:
    """Launch counts per path: every count is set to 0 just before a path
    and read just after it."""

    def __init__(self):
        self.counts = {}

    def run(self, path, fn, need=()):
        """Run ``fn()`` as ``path``; fail if a kernel named in ``need`` was
        not launched in it, the lists kernel other than once a hier pass
        or the tree kernel other than once a tree build."""
        import torch
        _build.LAUNCHES.clear()
        HIER_PASSES[0] = 0
        BUILDS[0] = 0
        out = fn()
        torch.cuda.synchronize()
        self.counts[path] = _only(**_build.LAUNCHES)
        if self.counts[path]["bh_lists"] != HIER_PASSES[0]:
            raise AssertionError(
                f"{path}: {self.counts[path]['bh_lists']} launches of the "
                f"lists kernel in {HIER_PASSES[0]} hier passes")
        if self.counts[path]["bh_tree"] != BUILDS[0]:
            raise AssertionError(
                f"{path}: {self.counts[path]['bh_tree']} launches of the "
                f"tree kernel in {BUILDS[0]} tree builds")
        for name in need:
            if self.counts[path][name] < 1:
                raise AssertionError(f"{path}: the {name} kernel was never "
                                     f"launched")
        return out

    def of(self, kernel):
        return {p: c[kernel] for p, c in self.counts.items()}


def _count_hier_passes():
    """Count every hier pass (a call of ``traverse._hier_accel``, lists-only
    passes too) in HIER_PASSES, by a wrapper installed once."""
    from tpu_nbody_torch.ops import traverse
    real = traverse._hier_accel
    if getattr(real, "counts_passes", False):
        return

    def counted(*args, **kw):
        HIER_PASSES[0] += 1
        return real(*args, **kw)

    counted.counts_passes = True
    traverse._hier_accel = counted


def _count_builds():
    """Count every tree build (a call of ``tree.build_tree``, which each
    caller reaches through the module) in BUILDS, by a wrapper installed
    once."""
    from tpu_nbody_torch.ops import tree
    real = tree.build_tree
    if getattr(real, "counts_builds", False):
        return

    def counted(*args, **kw):
        with BUILDS_LOCK:
            BUILDS[0] += 1
        return real(*args, **kw)

    counted.counts_builds = True
    tree.build_tree = counted


def _only(**counts) -> dict:
    """Launch counts that name some kernels, the others 0."""
    return {k: counts.get(k, 0) for k in _build.KERNELS}


def _engine(cfg, params, dev, n, **kw):
    """An Engine on the two-disk scene of ``n`` bodies (seed 3)."""
    from tpu_nbody_torch.engine import Engine
    eng = Engine(cfg, params, seed=3, device=dev, **kw)
    n2 = n // 5
    eng.reset_default_scene(n1=n - n2, n2=n2)
    return eng


def _run_steps(eng, calls, steps, per_call, kernels, other=None):
    """``calls`` Engine.step(steps) calls, the first a warm-up; checks
    ``per_call`` launches of each of ``kernels`` in each (and ``other``'s
    count of each kernel it names: {kernel: steps -> launches}), finite
    state and no growth of n_alive. Returns the fastest timed call's
    seconds and n_alive."""
    import torch
    n0 = int(eng.state.n_alive())
    times = []
    for rep in range(calls):
        before = _build.LAUNCHES.copy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step(steps[rep])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = _build.LAUNCHES.copy()
        want = {k: per_call for k in kernels}
        want.update(other or {})
        for kernel, fn in want.items():
            got = after[kernel] - before[kernel]
            if got != fn(steps[rep]):
                raise AssertionError(
                    f"{kernel} kernel launched {got} times in "
                    f"step({steps[rep]}), expected {fn(steps[rep])}")
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
    return timed_ms(lambda: accel(st.pos, st.mass, st.alive, params,
                                  kernel=kernel), reps=3)


def _rel_err(got, want):
    return (got - want).norm(dim=1) / (want.norm(dim=1) + 1e-9)


# calls whose device operations are counted after the bench (``_per_call``,
# ``_count_device_ops``): (name, fn, its result dict, the launches it must
# make, or a function that counts them then)
DEFERRED_OPS = []


def _per_call(name, fn, expect):
    """One call of ``fn`` as the card sees it: device ms with the host's
    enqueue hidden (``device_ms``), ms a call on an idle card
    (``timed_ms``) and the host's ms to enqueue it (host clock around the
    call, the card idle, median of 5). The device operations it enqueues
    (a profiler trace) are counted by ``_count_device_ops`` after the
    bench, into the same dict, and must be ``expect`` (or what it returns,
    called then): a profiler session leaves the host's later launches
    slower in this process."""
    import torch
    out = dict(device_ms=device_ms(fn), call_ms=timed_ms(fn))
    enq = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        enq.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    out["host_enqueue_ms"] = sorted(enq)[2]
    DEFERRED_OPS.append((name, fn, out, expect))
    return out


def _per_call_text(c, old):
    return (f"{c['device_ms']:.4f} ms on the device, {c['call_ms']:.4f} ms "
            f"a call on an idle card, {c['host_enqueue_ms']:.4f} ms to "
            f"enqueue (before the redesign: {old})")


def _count_device_ops():
    """The device operations of each ``_per_call`` call, from a profiler
    trace of one more call, after every timing of the run; fails where a
    call enqueued other than its expected count."""
    for name, fn, out, expect in DEFERRED_OPS:
        if callable(expect):
            expect = expect()
        ops = device_ops(fn)
        out.update(device_launches=len(ops), device_ops=ops)
        print(f"{name}: {len(ops)} device launches a call: "
              + ", ".join(o[:60] for o in ops), flush=True)
        if len(ops) != expect:
            raise AssertionError(f"{name}: {len(ops)} device operations a "
                                 f"call, expected {expect}: {ops}")


def _fresh_tables(table, n=16):
    """``n`` union tables with the boxes of ``table``, each with stats of
    its own, zeroed by one fill before they are handed out: a selection
    takes a table once (the timing helpers call a function 12 times)."""
    import torch
    from tpu_nbody_torch.ops import mesh
    stats = torch.zeros((n, 4), dtype=torch.int32, device=table.stats.device)
    return iter([mesh.UnionTable(table.boxes, s) for s in stats])


def _rescue_select_shape(spos, smass, salive, cfg, a):
    """The selection kernel against its plain version at the main path's
    shape: every block of the sorted scene against every block, the main
    path's k, bit for bit (counts, needs, scores on every slot, indices on
    the valid slots), with the union table the block-box kernel builds
    (the main path's) and with the wrapper's own (the union kernel, the
    sharded callers'); its near-group counter against the plain count;
    the kernel timed (CUDA events, median of 10; ``device_ms``, the
    host's enqueue hidden, since one call on an idle card is shorter than
    the wrapper's enqueue) at the plan's shape, a fresh union table a
    call, bound from ``mesh.select_work`` of the near groups the kernel's
    counter reads; then the whole selection as ``_block_rescue`` calls it
    (the boxes with their unions, then the kernel): per call its device
    ms, ms on an idle card, the host's enqueue ms and its device
    operations, beside those of the design it replaced (BEFORE_SELECT)."""
    import torch
    from tpu_nbody_torch.ops import mesh
    S, k = cfg.mesh_band, cfg.mesh_rescue
    live = torch.where(salive, smass, 0.0)
    _, bbox, table = mesh._block_boxes(spos, live, salive, S, unions=True)
    B, cb, _ = mesh._block_bounds(spos.shape[0], S, cfg.mesh_chunk)
    rcut2 = mesh._rcut2(a)
    k = min(k, B)
    want = mesh._rescue_select_ref(bbox, bbox, rcut2, k, chunk=cb,
                                   count_groups=True)
    valid = want.mval > 0
    for name, tab in (("the boxes kernel's union table", table),
                      ("the wrapper's own union table", None)):
        got = mesh.rescue_select(bbox, bbox, rcut2, k, unions=tab,
                                 count_groups=True)
        torch.cuda.synchronize()
        same = (torch.equal(got.cnt, want.cnt)
                and int(got.need) == int(want.need)
                and int(got.hot) == int(want.hot)
                and torch.equal(got.mval.view(torch.int32),
                                want.mval.view(torch.int32))
                and torch.equal(got.midx[valid], want.midx[valid]))
        if not same:
            raise AssertionError(f"rescue_select ({name}): the kernel's "
                                 f"selection differs from the plain "
                                 f"version's")
        if int(got.groups) != int(want.groups):
            raise AssertionError(f"rescue_select ({name}): the kernel "
                                 f"tested {int(got.groups)} near groups, "
                                 f"the plain count is {int(want.groups)}")
    groups = int(want.groups)
    plan = mesh._select_plan(B, k)
    # the kernel alone, on the main path's union boxes: a table serves one
    # selection, so each call takes one of a set zeroed before the timing
    def kernel(tables):
        return lambda: mesh._select_launch(bbox, bbox, rcut2, k, k, 0, None,
                                           None, plan, unions=next(tables))

    ms = device_ms(kernel(_fresh_tables(table)))
    call_ms = timed_ms(kernel(_fresh_tables(table)))
    plain_ms = timed_ms(lambda: mesh._rescue_select_ref(bbox, bbox, rcut2, k,
                                                        chunk=cb))

    def select():
        return mesh._rescue_select(spos, live, salive, a, band=S, k=k,
                                   chunk=cfg.mesh_chunk)

    whole = _per_call("the selection with its boxes", select, 2)
    out = dict(max_abs_err=float((got.mval - want.mval).abs().max()), ms=ms,
               call_ms=call_ms, plain_ms=plain_ms, blocks=B, k=k,
               need=int(want.need),
               hot=int(want.hot), valid_partner_blocks=int(valid.sum()),
               near_groups=groups,
               **bounds(mesh.select_work(B, B, k, groups, boxes=B), ms),
               with_boxes=whole, before=BEFORE_SELECT,
               plan=dict(warps=plan.warps, tile=plan.tile,
                         bufcap=plan.bufcap, smem=plan.smem,
                         ctas=mesh._select_capacity(bbox.device.index,
                                                    plan.warps, plan.smem)))
    print(f"rescue_select S={S} k={k} blocks={B}: the same bits as the "
          f"plain version with either union table (need {out['need']}, "
          f"{out['hot']} blocks over k, {out['valid_partner_blocks']} valid "
          f"slots, {groups} near groups of 32 tested in full, the kernel's "
          f"counter); kernel "
          f"{ms:.4f} ms on the device ({call_ms:.4f} ms a call on an idle "
          f"card; before the redesign {BEFORE_SELECT['kernel_ms']}), plain "
          f"{plain_ms:.4f} "
          f"ms, bound {out['bound_ms']:.5f} ms ({out['bound_by']}, "
          f"{out['pct_of_bound']:.2f}%); plan {out['plan']}; the "
          "selection with its boxes: "
          + _per_call_text(whole, BEFORE_SELECT["with_boxes"]), flush=True)
    return out


def _unions_shape(spos, smass, salive, cfg):
    """The union kernel (``mesh.select_unions``, the sharded callers'
    table) bit for bit against ``_union_boxes`` on the main path's block
    boxes, timed on the device beside its plain version; bound: the boxes
    read once, the unions and the zeroed stats written once."""
    import torch
    from tpu_nbody_torch.ops import mesh
    live = torch.where(salive, smass, 0.0)
    _, bbox = mesh._block_boxes(spos, live, salive, cfg.mesh_band)
    got = mesh.select_unions(bbox)
    want = mesh._union_boxes(bbox)
    torch.cuda.synchronize()
    if not (torch.equal(got.boxes, want)
            and got.stats.tolist() == [0, 0, 0, 0]):
        raise AssertionError("select_unions: the union table differs from "
                             "_union_boxes, or its stats are not zero")
    C = bbox.shape[0]
    ms = device_ms(lambda: mesh.select_unions(bbox))
    call_ms = timed_ms(lambda: mesh.select_unions(bbox))
    plain_ms = timed_ms(lambda: mesh._union_boxes(bbox))
    work = dict(flops=0, bytes=16 * C + 16 * -(-C // 32) + 16)
    out = dict(max_abs_err=0.0, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
               boxes=C, **bounds(work, ms))
    print(f"select_unions {C} boxes: the same bits as _union_boxes; kernel "
          f"{ms:.4f} ms on the device ({call_ms:.4f} ms a call on an idle "
          f"card), plain {plain_ms:.4f} ms, bound {out['bound_ms']:.5f} ms "
          f"({out['bound_by']}, {out['pct_of_bound']:.1f}%)", flush=True)
    return out


def _rescue_shape(spos, smass, salive, cfg, params, a, n_sm, max_clock_hz):
    """The rescue kernel against its plain version at the main path's
    shape: the partner choice of the sorted scene (``mesh._rescue_select``,
    the main path's S and k) and one launch over every block, as
    ``_block_rescue`` makes it. Under poly4 also: the same bits without the
    sub-tile skip and on a repeat; its walked counter against
    ``band.rescue_near_tiles``; the pairs walked against the pairs within
    2a (``band.rescue_cutoff_pairs``), which the bound counts; and the
    times of the other launch shapes (RESCUE_SHAPES) and of the kernel with
    the skip off, beside the plan's."""
    import torch
    from tpu_nbody_torch.ops import band, mesh
    S, switch = cfg.mesh_band, cfg.mesh_switch
    live = torch.where(salive, smass, 0.0)
    sel = mesh._rescue_select(spos, live, salive, a, band=S,
                              k=cfg.mesh_rescue, chunk=cfg.mesh_chunk)
    m = sel.rows.shape[0]
    pvalid = sel.mval > 0
    midx = sel.midx.contiguous()
    rows = (sel.rows, torch.arange(m, device=spos.device), sel.rows, midx,
            pvalid)
    args = rows + (params.soft2, a, switch)
    r = _compare(f"rescue {switch} S={S} k={sel.k} blocks={m}",
                 lambda: band.rescue_pair_sum(*args),
                 lambda: band.rescue_pair_sum_ref(*args, chunk=sel.cb))
    plan = band._rescue_plan(S, sel.k)
    walked = torch.zeros((), dtype=torch.int64, device=spos.device)
    got = band.rescue_pair_sum(*args, walked=walked)
    again = band.rescue_pair_sum(*args)
    full = band._rescue_launch(*args, plan, cull=False)
    near = band.rescue_near_tiles(*args)
    needed = band.rescue_cutoff_pairs(*rows, a, switch)
    torch.cuda.synchronize()
    if not (torch.equal(got, again) and torch.equal(got, full)):
        raise AssertionError("rescue: a repeat, or the kernel without the "
                             "sub-tile skip, gave other bits")
    if int(walked) != near.tiles:
        raise AssertionError(f"rescue: the kernel walked {int(walked)} "
                             f"sub-tile pairs, the plain count is "
                             f"{near.tiles}")
    valid = int(pvalid.sum())
    every_tile = valid * plan.G * plan.G
    if switch == "poly4" and not near.tiles < every_tile:
        raise AssertionError(f"rescue: the kernel skipped no sub-tile "
                             f"({near.tiles} of {every_tile})")
    shapes = {}
    for T in RESCUE_SHAPES:
        shape = band._rescue_plan(S, sel.k, T=T)
        shapes[f"T={T}"] = timed_ms(lambda: band._rescue_launch(*args, shape))
    nocull_ms = timed_ms(lambda: band._rescue_launch(*args, plan,
                                                     cull=False))
    work = band.rescue_pair_work(m, sel.k, S, valid, m, switch,
                                 near_pairs=needed, walked_pairs=near.pairs)
    out = dict(r, blocks=m, k=sel.k, valid_partner_blocks=valid,
               need=int(sel.need), pairs_needed=work["pairs"],
               pairs_walked=near.pairs, pairs_valid=valid * S * S,
               walked_over_needed=near.pairs / max(1, work["pairs"]),
               tiles_walked=near.tiles, tiles_valid=every_tile,
               nocull_ms=nocull_ms, shapes=shapes,
               **bounds(work, r["ms"], n_sm, max_clock_hz),
               plan=dict(T=plan.T, G=plan.G, R=plan.R, threads=plan.threads,
                         smem=plan.smem))
    print(f"  rescue: {valid} of {m * sel.k} partner slots valid; "
          f"{near.pairs} pairs walked ({near.tiles} of {every_tile} "
          f"sub-tile pairs, the kernel's counter) against {work['pairs']} "
          f"needed within 2a ({out['walked_over_needed']:.3f}x) and "
          f"{valid * S * S} in the valid blocks; the same bits without the "
          f"skip ({nocull_ms:.4f} ms) and on a repeat; bound "
          f"{out['bound_ms']:.4f} ms ({out['pct_of_bound']:.1f}%); shapes "
          + ", ".join(f"{k_} {v:.4f} ms" for k_, v in shapes.items()),
          flush=True)
    return out


def _boxes_shape(spos, smass, salive, cfg):
    """The block rows and boxes kernel against its plain version bit for
    bit at the main path's shape (the selection's live masses; the dead
    bodies sort to the end, so the last blocks hold none) and on a ragged
    tail (every slot but the last), with the selection's union table bit
    for bit against ``_union_boxes`` and its stats zeroed; timed as the
    main path calls it (with the unions) on the device with the host's
    enqueue hidden and as a call on an idle card; bound from
    ``mesh.block_boxes_work`` with the unions."""
    import torch
    from tpu_nbody_torch.ops import mesh
    S = cfg.mesh_band
    live = torch.where(salive, smass, 0.0)
    cap = spos.shape[0]
    for name, inputs in (("main", (spos, live, salive)),
                         ("ragged", (spos[:cap - 1], live[:cap - 1],
                                     salive[:cap - 1]))):
        got = mesh._block_boxes(*inputs, S, unions=True)
        want = mesh._block_boxes_ref(*inputs, S)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0])
                and torch.equal(got[1], want[1])):
            raise AssertionError(f"block_boxes ({name}): the kernel's rows "
                                 f"or boxes differ from the plain version's")
        if not (torch.equal(got[2].boxes, mesh._union_boxes(want[1]))
                and got[2].stats.tolist() == [0, 0, 0, 0]):
            raise AssertionError(f"block_boxes ({name}): the union table "
                                 f"differs from _union_boxes, or its stats "
                                 f"are not zero")
    fn = lambda: mesh._block_boxes(spos, live, salive, S, unions=True)
    ms = device_ms(fn)
    call_ms = timed_ms(fn)
    plain_ms = timed_ms(lambda: mesh._block_boxes_ref(spos, live, salive, S))
    out = dict(max_abs_err=0.0, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
               **bounds(mesh.block_boxes_work(cap, S, unions=True), ms))
    print(f"block_boxes S={S} cap={cap}: the same bits as the plain version "
          f"(and on a ragged tail of {cap - 1}), the union table bit for "
          f"bit; kernel {ms:.4f} ms on the device ({call_ms:.4f} ms a call "
          f"on an idle card), plain {plain_ms:.4f} ms, bound "
          f"{out['bound_ms']:.5f} ms ({out['bound_by']}, "
          f"{out['pct_of_bound']:.1f}%)", flush=True)
    return out


def _merge_compare(name, st, params, H):
    """The merge kernel against its plain version on one state: the same
    alive flags and heavy_need, masses within MERGE_RTOL; the kernel's
    call (``_per_call``: device ms, a call on an idle card, host enqueue;
    its device operations, which must be the one kernel) beside those of
    the design it replaced (BEFORE_MERGE), the plain version a call.
    Returns the row's numbers with the bound of the tests the data needs."""
    import torch
    from tpu_nbody_torch.ops import merge
    got, need = merge.merge_bodies(st, params, heavy_cap=H)
    want, wneed = merge._merge_bodies_ref(st, params, heavy_cap=H)
    torch.cuda.synchronize()
    n_alive = int(st.n_alive())
    victims = n_alive - int(want.alive.sum())
    err = float((got.mass - want.mass).abs().max())
    rel = float(((got.mass - want.mass).abs()
                 / want.mass.abs().clamp_min(1e-30)).max())
    if not (int(need) == int(wneed) and torch.equal(got.alive, want.alive)
            and rel <= MERGE_RTOL):
        raise AssertionError(
            f"{name}: the merge kernel disagrees with its plain version: "
            f"heavy_need {int(need)} against {int(wneed)}, alive equal "
            f"{torch.equal(got.alive, want.alive)}, mass max rel {rel:.3e}")
    call = _per_call(name, lambda: merge.merge_bodies(st, params,
                                                      heavy_cap=H), 1)
    ms = call["device_ms"]
    plain_ms = timed_ms(lambda: merge._merge_bodies_ref(st, params,
                                                        heavy_cap=H))
    work = merge.merge_work(n_alive, int(wneed), H, st.dim)
    out = dict(max_abs_err=err, max_rel_err=rel, ms=ms,
               call_ms=call["call_ms"],
               host_enqueue_ms=call["host_enqueue_ms"], per_call=call,
               plain_ms=plain_ms, bodies=st.capacity, alive=n_alive,
               heavy_need=int(wneed), heavy_cap=H, victims=victims,
               tests=work["tests"], before=BEFORE_MERGE, **bounds(work, ms))
    print(f"{name}: {victims} bodies absorbed of {n_alive}, heavy_need "
          f"{int(wneed)} (cap {H}): the plain version's alive flags and "
          f"heavy_need, mass max rel diff {rel:.3e}; kernel "
          + _per_call_text(call, BEFORE_MERGE)
          + f"; plain {plain_ms:.4f} ms, bound {out['bound_ms']:.5f} ms "
          f"({out['bound_by']}, {out['pct_of_bound']:.2f}%)", flush=True)
    return out


def _merge_scene(cap, dev):
    """A synthetic merge scene of ``cap`` bodies in the two-disk world:
    light bodies everywhere, MERGE_HEAVIES heavies of distinct masses (so
    ``heavy_need`` overflows the main path's cap of 64 and the kernel's
    select runs), the 63 heaviest in 21 chains of three 6 px apart (the
    middle one the lowest index, the ends both its victims, or the first
    the lowest, the third then neither absorbing nor absorbed), each heavy
    with light bodies around it and some of them dead."""
    import torch
    from tpu_nbody_torch.state import SimState
    g = torch.Generator(device=dev).manual_seed(21)
    pos = torch.rand((cap, 2), generator=g, device=dev) * torch.tensor(
        [2400.0, 800.0], device=dev)
    mass = torch.rand((cap,), generator=g, device=dev) + 0.5
    alive = torch.rand((cap,), generator=g, device=dev) > 0.02
    hs = torch.randperm(cap // 8, generator=g, device=dev)[:MERGE_HEAVIES] * 8
    mass[hs] = torch.linspace(9000.0, 4001.0, MERGE_HEAVIES, device=dev)
    alive[hs] = True
    at = torch.rand((MERGE_HEAVIES, 2), generator=g, device=dev) * \
        torch.tensor([2300.0, 700.0], device=dev) + 50.0
    chains = 21
    for c in range(chains):         # the 63 heaviest: chains of three
        for j in range(3):
            at[3 * c + j] = at[3 * c] + torch.tensor([6.0 * j, 0.0],
                                                     device=dev)
    lo = torch.sort(hs[:3 * chains].view(chains, 3), dim=1).values
    mid_low = torch.arange(chains, device=dev) % 2 == 0
    # even chains: the lowest index in the middle; odd: at the first end
    order = torch.where(mid_low[:, None], lo[:, [1, 0, 2]], lo)
    hs = torch.cat([order.reshape(-1), hs[3 * chains:]])
    pos[hs] = at
    for k in range(1, 8):           # satellites, within 3 px
        pos[hs + k] = at + (torch.rand((MERGE_HEAVIES, 2), generator=g,
                                       device=dev) - 0.5) * 4.0
    return SimState(pos=pos.contiguous(), vel=torch.zeros_like(pos),
                    mass=torch.where(alive, mass, 0.0).contiguous(),
                    alive=alive.contiguous(),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def _interp_shape(spos, smass, salive, cfg, params, origin, side):
    """The interpolation kernel against its plain version at the main
    path's shape, on the Hilbert-sorted scene: the fresh pass from the
    force-grid windows in CIC (the main path), NGP and TSC, and path B's
    carried table of [T | dT] lanes with frac, bit for bit; the CIC pass
    timed (``device_ms``, a call on an idle card) beside its plain version
    and, as a yardstick only, ``torch.nn.functional.grid_sample``
    (bilinear, ``align_corners=True``) of the same windows at the same
    positions."""
    import torch
    import torch.nn.functional as F
    from tpu_nbody_torch.ops import mesh
    nw, ny, grid, _, h, a, mo = mesh._pm_geometry(
        origin, side, cfg.mesh_level, cfg.mesh_ny, cfg.mesh_split)

    def same_bits(name, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            err = float((got - want).abs().max())
            raise AssertionError(f"interp {name}: the kernel's bits differ "
                                 f"from the plain version's (max |diff| "
                                 f"{err:.3e})")
        print(f"interp {name}: the plain version's bits", flush=True)

    out = {}
    for order in (2, 1, 3):
        kernel = mesh._kernel_hats(grid, h, params.soft2, a, spos.dtype,
                                   spos.device, grid_y=2 * ny,
                                   deconv_order=order,
                                   switch=cfg.mesh_switch)
        fx, fy = mesh._mesh_grids_one(spos, smass, mo, h, nw, grid, order,
                                      kernel, ny=ny)
        base, w = mesh._cic_cells(spos, mo, h, nw, order, ny=ny)

        def run(fx=fx, fy=fy, base=base, w=w):
            return mesh._interp_packed(fx, fy, base, w, nw, ny=ny)

        def plain(fx=fx, fy=fy, base=base, w=w):
            return mesh._interp_packed_ref(fx, fy, base, w, nw, ny=ny)

        name = {1: "NGP", 2: "CIC", 3: "TSC"}[order]
        got = run()
        same_bits(f"{name} windows {tuple(fx.shape)}", got, plain())
        if order != 2:
            continue
        ms = device_ms(run)
        call_ms = timed_ms(run)
        plain_ms = timed_ms(plain)
        # the yardstick: bilinear sampling of (fx, fy) at the bodies'
        # cell-centre coordinates, as the CIC weights read them
        u = (spos - torch.tensor(mo, device=spos.device)) / h - 0.5
        rows, cols = fx.shape
        g = torch.stack([2.0 * u[:, 0] / (cols - 1) - 1.0,
                         2.0 * u[:, 1] / (rows - 1) - 1.0], dim=-1)
        g = g[None, None].contiguous()
        img = torch.stack([fx, fy])[None].contiguous()

        def library():
            return F.grid_sample(img, g, mode="bilinear",
                                 align_corners=True)

        lib = library()[0, :, 0].T
        lib_diff = float((lib - got).abs().max())
        library_ms = timed_ms(library)
        n, K = w.shape
        work = mesh.interp_work(base, K, nw, cols)
        out.update(max_abs_err=float((got - plain()).abs().max()), ms=ms,
                   call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
                   library="torch.nn.functional.grid_sample (bilinear, "
                           "align_corners=True)",
                   library_max_abs_diff=lib_diff, bodies=n, taps=K,
                   windows=list(fx.shape), cells=work["cells"],
                   **bounds(work, ms))
        print(f"interp CIC {n} bodies: kernel {ms:.4f} ms on the device "
              f"({call_ms:.4f} ms a call on an idle card), plain "
              f"{plain_ms:.4f} ms, grid_sample {library_ms:.4f} ms (max "
              f"|diff| from the kernel {lib_diff:.3e}), bound "
              f"{out['bound_ms']:.5f} ms ({out['bound_by']}, "
              f"{out['pct_of_bound']:.2f}%; {work['cells']} window cells "
              f"touched)", flush=True)

    # path B: the carried table, [T | dT] lanes, extrapolated by frac
    kw = dict(mesh_level=cfg.mesh_level, split_cells=cfg.mesh_split,
              mesh_ny=cfg.mesh_ny, heavy_cap=16, switch=cfg.mesh_switch)
    seed = mesh.pm_mesh_state(spos, smass, salive, params.soft2, origin,
                              side, prev="zero", **kw)
    moved = (spos + 0.5).contiguous()
    state = mesh.pm_mesh_state(moved, smass, salive, params.soft2, origin,
                               side, prev=seed[0], **kw)
    T = state[0][0]
    base, w = mesh._cic_cells(moved, mo, h, nw, 2, ny=ny)
    same_bits(f"carried table {tuple(T.shape)} frac 0.25",
              mesh._interp_rows(T, base, w, frac=0.25),
              mesh._interp_rows_ref(T, base, w, frac=0.25))
    out["carried_table_ms"] = device_ms(
        lambda: mesh._interp_rows(T, base, w, frac=0.25))
    out["carried_table_plain_ms"] = timed_ms(
        lambda: mesh._interp_rows_ref(T, base, w, frac=0.25))
    print(f"interp carried table: kernel {out['carried_table_ms']:.4f} ms "
          f"on the device, plain {out['carried_table_plain_ms']:.4f} ms",
          flush=True)
    return out


def _rho_check(name, got, want, rtol=RHO_RTOL):
    """A deposit against a reference: each cell within ``rtol`` of it
    (zero where it is zero), the total within MASS_RTOL, finite. Returns
    (max relative difference of a cell, of the total)."""
    import torch
    torch.cuda.synchronize()
    g, w = got.double(), want.double()
    diff = (g - w).abs()
    bad = int((diff > rtol * w.abs()).sum())
    cell = float((diff / w.abs().clamp(min=1e-300)).max())
    total = abs(float(g.sum()) - float(w.sum())) / float(w.sum())
    if bad or not total <= MASS_RTOL or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: {bad} cells differ from the "
                             f"reference by more than {rtol} of the cell "
                             f"(max {cell:.3e}) or the total by {total:.3e} "
                             f"> {MASS_RTOL}")
    return cell, total


def _same_bits(name, got, want):
    import torch
    torch.cuda.synchronize()
    if not (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got.view(torch.int32), want.view(torch.int32))):
        raise AssertionError(f"{name}: the kernel's bits differ from the "
                             f"plain version's")


def _deposit_shape(spos, smass, cfg, origin, side):
    """The deposit kernel against its plain versions at the main path's
    shape, on the Hilbert-sorted scene, in CIC (the main path), NGP and
    TSC: the cells of the fused entry and of the cells-only entry bit for
    bit with ``_cic_cells_ref``; rho of the fused entry, the block of the
    rows the FFT reads (``mesh.occ_rows``) and of a sharded rank's
    ``occ_p``, against the plain grid's leading rows (the plain grid holds
    nothing past them), and of the entry from given cells (int32 and
    int64 base, the whole grid) within RHO_RTOL a cell and MASS_RTOL of the
    total. In CIC: the pass timed (``_per_call``: two device operations,
    the memset of the block and the kernel), the entries apart, the
    block's zeroing alone by ``torch.zeros``, the plain versions (cells
    and deposit), and, as a yardstick only, one ``index_add_`` of the 4n
    (cell, m w) pairs into the zeroed flattened block; the bound over the
    block. Then a clustered scene, the same bodies drawn 20 times closer
    to the window's centre: the fused entry timed and held to a float64
    sum of the same float32 products within CLUSTER_RHO_RTOL a cell and
    MASS_RTOL of the total, beside the plain float32 version's difference
    from that sum (read, not held). Also
    counts the coordinates where torch's division by h as a Python scalar
    differs on the card from the IEEE division the cells use
    (``_cic_cells_ref`` divides by a 0-dim tensor for that reason)."""
    import torch
    from tpu_nbody_torch.ops import mesh
    from tpu_nbody_torch.parallel import sharded_pm
    nw, ny, grid, grid_y, h, _, mo = mesh._pm_geometry(
        origin, side, cfg.mesh_level, cfg.mesh_ny, cfg.mesh_split)
    kw = dict(ny=ny, grid_y=grid_y)
    occ_p = sharded_pm._occ_rows_p(ny, P_RANKS, grid_y)
    n = spos.shape[0]
    shifted = spos - torch.tensor(mo, device=spos.device)
    scalar_differs = int((shifted / h != shifted / torch.tensor(
        h, device=spos.device)).sum())
    print(f"cells: torch's division by the Python scalar h differs from "
          f"the IEEE division in {scalar_differs} of {shifted.numel()} "
          f"coordinates on the card", flush=True)
    del shifted

    def fused(p=spos, order=2, rows=None):
        return mesh.deposit_cells(p, smass, mo, h, nw, grid, order,
                                  rows=rows, **kw)

    out = {}
    for order in (2, 1, 3):
        name = {1: "NGP", 2: "CIC", 3: "TSC"}[order]
        rows = mesh.occ_rows(ny, order)
        base_p, w_p = mesh._cic_cells_ref(spos, mo, h, nw, order, ny=ny)
        rho_p = mesh._deposit_packed_ref(smass, base_p, w_p, nw, grid, **kw)
        if rho_p[min(rows, occ_p):].any():
            raise AssertionError(f"deposit {name}: the plain grid holds "
                                 f"mass past the {rows} rows the FFT reads")
        for r in (rows, occ_p):
            rho, base, w = fused(order=order, rows=r)
            if tuple(rho.shape) != (r, grid):
                raise AssertionError(f"deposit {name}: a block of "
                                     f"{tuple(rho.shape)}, expected "
                                     f"{(r, grid)}")
            _same_bits(f"deposit {name} cells (fused)", base, base_p)
            _same_bits(f"deposit {name} weights (fused)", w, w_p)
            cell_err, total_err = _rho_check(
                f"deposit {name} rho (fused, {r} rows)", rho, rho_p[:r])
        base_c, w_c = mesh._cic_cells(spos, mo, h, nw, order, ny=ny)
        _same_bits(f"deposit {name} cells (cells only)", base_c, base_p)
        _same_bits(f"deposit {name} weights (cells only)", w_c, w_p)
        for dtype in (torch.int32, torch.int64):
            _rho_check(f"deposit {name} rho (from {dtype} cells)",
                       mesh._deposit_packed(smass, base_p.to(dtype), w_p,
                                            nw, grid, **kw), rho_p)
        print(f"deposit {name}: cells and weights the plain version's bits "
              f"(both entries); rho within {RHO_RTOL} a cell (max "
              f"{cell_err:.3e}) and {MASS_RTOL} of the total "
              f"({total_err:.3e}) in every entry, the fused entry's "
              f"{rows}- and {occ_p}-row blocks and the given entry's whole "
              f"grid", flush=True)
        if order != 2:
            continue
        K = w_p.shape[1]
        call = _per_call("deposit_cells", fused, 2)
        ms = call["device_ms"]
        cells_ms = device_ms(lambda: mesh._cic_cells(spos, mo, h, nw, order,
                                                     ny=ny))
        given_ms = device_ms(lambda: mesh._deposit_packed(
            smass, base_p, w_p, nw, grid, **kw))
        zero_ms = device_ms(lambda: torch.zeros((rows, grid),
                                                device=spos.device))
        plain_ms = timed_ms(lambda: mesh._deposit_packed_ref(
            smass, *mesh._cic_cells_ref(spos, mo, h, nw, order, ny=ny), nw,
            grid, **kw))
        offs = torch.tensor([oy * grid + ox for oy in (0, 1)
                             for ox in (0, 1)], device=spos.device)
        b64 = base_p.to(torch.int64)
        idx = ((b64 // nw) * grid + b64 % nw)[:, None] + offs[None, :]
        idx = idx.reshape(-1)
        vals = (smass[:, None] * w_p).reshape(-1)

        def library():
            return torch.zeros((rows * grid,), device=spos.device
                               ).index_add_(0, idx, vals)

        lib_rho = library().reshape(rows, grid)
        lib_diff = float((lib_rho - rho_p[:rows]).abs().max())
        library_ms = device_ms(library)
        mult = torch.bincount(b64[smass > 0])
        out.update(max_abs_err=float((fused()[0] - rho_p[:rows]).abs().max()),
                   max_rel_err_cell=cell_err, rel_err_total=total_err,
                   ms=ms, call=call, scalar_divisor_differs=scalar_differs,
                   cells_ms=cells_ms, given_ms=given_ms,
                   block_zero_ms=zero_ms, plain_ms=plain_ms,
                   library_ms=library_ms,
                   library="torch.Tensor.index_add_ of the 4n (cell, m w) "
                           "pairs into the zeroed flattened block",
                   library_max_abs_diff=lib_diff, bodies=n, taps=K,
                   block=[rows, grid], grid=[grid_y, grid],
                   cells_occupied=int((mult > 0).sum()),
                   max_bodies_a_cell=int(mult.max()),
                   **bounds(mesh.deposit_work(n, K, rows * grid), ms))
        print(f"deposit CIC {n} bodies, fused: {ms:.4f} ms on the device, "
              f"the memset of the {rows} x {grid} block and the kernel "
              f"({call['call_ms']:.4f} a call, {call['host_enqueue_ms']:.4f} "
              f"to enqueue); cells only {cells_ms:.4f}, from given cells "
              f"(the whole grid) {given_ms:.4f}; the block's zeroing alone "
              f"{zero_ms:.4f}; plain {plain_ms:.4f} ms; index_add_ "
              f"{library_ms:.4f} ms (max |diff| from the plain version "
              f"{lib_diff:.3e}); bound {out['bound_ms']:.5f} ms "
              f"({out['bound_by']}, {out['pct_of_bound']:.2f}%) over the "
              f"block; {out['cells_occupied']} base cells hold bodies, at "
              f"most {out['max_bodies_a_cell']} a cell", flush=True)
    # a clustered scene: the same bodies 20 times closer to the centre
    rows = mesh.occ_rows(ny, 2)
    centre = torch.tensor([mo[0] + 0.5 * nw * h, mo[1] + 0.5 * ny * h],
                          device=spos.device)
    tight = (centre + (spos - centre) / 20.0).contiguous()
    base_t, w_t = mesh._cic_cells_ref(tight, mo, h, nw, 2, ny=ny)
    prods = smass[:, None] * w_t                      # the float32 products
    rho64 = mesh._deposit_packed_ref(
        torch.ones_like(smass, dtype=torch.float64), base_t, prods.double(),
        nw, grid, **kw)
    b64 = base_t.to(torch.int64)
    idx = ((b64 // nw) * grid + b64 % nw)[:, None] + offs[None, :]
    terms = torch.zeros((grid_y * grid,), device=spos.device).index_add_(
        0, idx.reshape(-1), (prods != 0).float().reshape(-1))
    rho64 = rho64[:rows]
    cell_err, total_err = _rho_check("deposit CIC clustered",
                                     fused(tight)[0], rho64,
                                     rtol=CLUSTER_RHO_RTOL)
    g64 = mesh._deposit_packed_ref(smass, base_t, w_t, nw, grid,
                                   **kw)[:rows].double()
    plain_cell = float(((g64 - rho64).abs()
                        / rho64.abs().clamp(min=1e-300)).max())
    plain_total = abs(float(g64.sum() - rho64.sum())) / float(rho64.sum())
    mult = torch.bincount(b64[smass > 0])
    clustered = dict(ms=device_ms(lambda: fused(tight)),
                     max_rel_err_cell=cell_err, rel_err_total=total_err,
                     plain_max_rel_err_cell=plain_cell,
                     plain_rel_err_total=plain_total,
                     cells_occupied=int((mult > 0).sum()),
                     max_bodies_a_cell=int(mult.max()),
                     max_terms_a_cell=int(terms.max()))
    out["clustered"] = clustered
    print(f"deposit CIC clustered (20x closer): kernel {clustered['ms']:.4f}"
          f" ms; {clustered['cells_occupied']} base cells hold bodies, at "
          f"most {clustered['max_bodies_a_cell']} a cell and "
          f"{clustered['max_terms_a_cell']} products; against the float64 "
          f"sum of the same products, rho within {CLUSTER_RHO_RTOL} a cell "
          f"(max {cell_err:.3e}) and {MASS_RTOL} of the total "
          f"({total_err:.3e}); the plain float32 version reads "
          f"{plain_cell:.3e} a cell, {plain_total:.3e} of the total",
          flush=True)
    return out


def _fd_shape(spos, smass, cfg, params, origin, side):
    """The FD-gradient kernel against its plain version at the main path's
    shapes, on the potential rows of the Hilbert-sorted scene's deposit,
    bit for bit, in CIC (the main path), NGP and TSC (one more row and
    column); in CIC timed (``device_ms``) beside the plain version and,
    as a yardstick only, one ``torch.nn.functional.conv2d`` of the rolled
    rows with the (2, 1, 7, 7) stencil weight (TF32 off)."""
    import torch
    import torch.nn.functional as F
    from tpu_nbody_torch.ops import mesh
    nw, ny, grid, grid_y, h, a, mo = mesh._pm_geometry(
        origin, side, cfg.mesh_level, cfg.mesh_ny, cfg.mesh_split)
    out = {}
    for order in (2, 1, 3):
        name = {1: "NGP", 2: "CIC", 3: "TSC"}[order]
        reach = 1 if order == 3 else 0
        kernel = mesh._kernel_hats(grid, h, params.soft2, a, spos.dtype,
                                   spos.device, grid_y=grid_y,
                                   deconv_order=order,
                                   switch=cfg.mesh_switch)
        rho, _, _ = mesh.deposit_cells(spos, smass, mo, h, nw, grid, order,
                                       ny=ny, grid_y=grid_y)
        pw = mesh._conv_potential(rho, kernel[2], ny, grid, grid_y,
                                  extra=reach)
        del rho, kernel

        def run(pw=pw, reach=reach):
            return mesh._fd_gradient(pw, h, nw, ny, reach)

        def plain(pw=pw, reach=reach):
            return mesh._fd_window_ref(pw, h, ny + 1 + reach, nw + 1 + reach)

        got, want = run(), plain()
        for axis, g_, w_ in zip("xy", got, want):
            _same_bits(f"fd {name} f{axis} {tuple(w_.shape)}", g_, w_)
        print(f"fd {name}: fx and fy {tuple(want[0].shape)} the plain "
              f"version's bits", flush=True)
        if order != 2:
            continue
        ms = device_ms(run)
        call_ms = timed_ms(run)
        plain_ms = timed_ms(plain)
        c1, c2, c3 = mesh._fd_coefficients(h)
        wt = torch.zeros((2, 1, 7, 7), device=spos.device)
        for k, c in ((1, c1), (2, -c2), (3, c3)):
            wt[0, 0, 3, 3 + k], wt[0, 0, 3, 3 - k] = c, -c
            wt[1, 0, 3 + k, 3], wt[1, 0, 3 - k, 3] = c, -c
        rolled = torch.roll(pw, 3, dims=1)[:, :nw + 7 + reach]
        rolled = rolled[None, None].contiguous()

        def library():
            return F.conv2d(rolled, wt)

        lib = library()[0]
        lib_diff = max(float((lib[i] - got[i]).abs().max()) for i in (0, 1))
        library_ms = device_ms(library)
        rows, cols = got[0].shape
        work = mesh.fd_work(rows, cols)
        out.update(max_abs_err=max(float((g_ - w_).abs().max())
                                   for g_, w_ in zip(got, want)),
                   ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                   library_ms=library_ms,
                   library="torch.nn.functional.conv2d of the rolled rows, "
                           "a (2, 1, 7, 7) stencil weight, TF32 off",
                   library_max_abs_diff=lib_diff, windows=[rows, cols],
                   potential_rows=list(pw.shape), **bounds(work, ms))
        print(f"fd CIC: kernel {ms:.4f} ms on the device ({call_ms:.4f} ms "
              f"a call on an idle card), plain {plain_ms:.4f} ms, conv2d "
              f"{library_ms:.4f} ms (max |diff| from the kernel "
              f"{lib_diff:.3e}), bound {out['bound_ms']:.5f} ms "
              f"({out['bound_by']}, {out['pct_of_bound']:.2f}%)", flush=True)
    return out


def _bh_pairs_shape(st, cfg, params, n_sm, max_clock_hz):
    """The pair kernel against its plain version at the dense traversal's
    shape, on a fitted pass at N = 65,536: the pass runs with
    ``traverse.point_accel`` wrapped to keep the evaluation chunk whose
    direct-partner launch has the most nonzero masses; the group (one row)
    with the most of them is cut out of that chunk's two launches,
    accepted nodes and direct partners, and both run through the kernel
    and the plain version. The kernel is also timed on the whole chunk,
    the launch shape of the pass. Group and chunk each: the plan's splits,
    the same bits from two calls, the time of a call on an idle card
    (``timed_ms``, as earlier versions read it) and on the device
    (``device_ms``), and beside it one split (the kernel before the
    split) on the device."""
    import torch
    from tpu_nbody_torch import accuracy
    from tpu_nbody_torch.ops import traverse
    real = traverse.point_accel
    calls, best = [], {}

    def keep(targets, sources, masses, soft2):
        calls.append((targets, sources, masses))
        if len(calls) == 2:            # a chunk: nodes, then direct
            nz = int((masses != 0).sum())
            if nz > best.get("nz", -1):
                best.update(nz=nz, calls=list(calls))
            calls.clear()
        return real(targets, sources, masses, soft2)

    traverse.point_accel = keep
    try:
        accuracy.fitted_bh_pass(st.pos, st.mass, st.alive, cfg, params)
    finally:
        traverse.point_accel = real
    nodes, direct = best["calls"]
    row = int((direct[2] != 0).sum(dim=(1, 2)).argmax())
    soft2 = params.soft2

    def shape(t, src, m):
        """The plan's split, its bits from two calls, its device ms and
        one split's."""
        NT = t.shape[2]
        one = traverse._pairs_plan(NT)
        plan = traverse._pairs_plan(
            NT, S=src.shape[1], sets=t.shape[0] * t.shape[1],
            ctas=traverse._pairs_ctas(t.device.index, one.T, one.tpg,
                                      one.lanes))
        a = traverse.point_accel(t, src, m, soft2)
        _same_bits("bh_pairs: two calls", a,
                   traverse.point_accel(t, src, m, soft2))
        return dict(splits=plan.splits,
                    device_ms=device_ms(
                        lambda: traverse.point_accel(t, src, m, soft2)),
                    one_split_device_ms=device_ms(
                        lambda: traverse._pairs_launch(t, src, m, soft2,
                                                       one)))

    out = {}
    for name, (t, src, m) in (("nodes", nodes), ("direct", direct)):
        t1, s1, m1 = (x[row:row + 1].contiguous() for x in (t, src, m))
        M, C, NT, _ = t1.shape
        r = _compare(
            f"bh_pairs dense group, {name}: {C} group x {NT} targets x "
            f"{s1.shape[1]} sources",
            lambda: traverse.point_accel(t1, s1, m1, soft2),
            lambda: traverse.point_accel_ref(t1, s1, m1, soft2))
        _check_close(f"bh_pairs dense chunk, {name}",
                     traverse.point_accel(t, src, m, soft2),
                     traverse.point_accel_ref(t, src, m, soft2))
        batch_ms = timed_ms(lambda: traverse.point_accel(t, src, m, soft2))
        work = traverse.pair_work(m, NT)
        out[name] = dict(
            r, groups=C, targets=NT, sources=s1.shape[1],
            nonzero_masses=int((m1 != 0).sum()), **shape(t1, s1, m1),
            **bounds(traverse.pair_work(m1, NT), r["ms"], n_sm,
                     max_clock_hz),
            batch=dict(rows=t.shape[0], ms=batch_ms, **shape(t, src, m),
                       **bounds(work, batch_ms, n_sm, max_clock_hz)))
        g, c = out[name], out[name]["batch"]
        print(f"  bh_pairs {name}: the group {g['splits']} splits, "
              f"{g['device_ms']:.4f} ms on the "
              f"device (one split {g['one_split_device_ms']:.4f}), bound "
              f"{g['bound_ms']:.4f} ms ({g['pct_of_bound']:.1f}% of a "
              f"call's {g['ms']:.4f}); the chunk of {t.shape[0]} groups "
              f"{c['splits']} splits, {batch_ms:.4f} ms a call, "
              f"{c['device_ms']:.4f} on the device (one split "
              f"{c['one_split_device_ms']:.4f}), bound "
              f"{c['bound_ms']:.4f} ms ({c['pct_of_bound']:.1f}% of a "
              f"call, {100 * c['bound_ms'] / c['device_ms']:.1f}% of the "
              f"device time); the same bits from two calls", flush=True)
    plan = traverse._pairs_plan(direct[0].shape[2])
    return dict(out["direct"], nodes_call=out["nodes"],
                plan=dict(T=plan.T, tpg=plan.tpg, lanes=plan.lanes,
                          threads=plan.threads))


def _bh_hier_shape(st, cfg, params, caps, n_sm, max_clock_hz):
    """The hier kernel on a Barnes–Hut pass at N = 1M with the engine's
    caps (module docstring): the pass against the same pass through the
    masked-dense route (``hier_accel_ref`` with the pair kernel) within
    TOL of max |a|, with the same needs; on the arguments the pass gave
    the kernel, its per-group counts against the masks' exactly, its sums
    against the plain version's (the masked-dense route in plain torch,
    one run, which takes seconds) and against the masked-dense route's,
    and on the chunk with the most direct bodies against the plain
    version. Times: the kernel over the whole pass (median of 10), the
    plain version's one run, both on the chunk."""
    import torch
    from tpu_nbody_torch import accuracy
    from tpu_nbody_torch.ops import traverse
    real = traverse.hier_accel
    seen = {}

    def keep(*args, **kw):
        seen.update(args=args, kw=kw)
        return real(*args, **kw)

    def one_pass(route):
        traverse.hier_accel = route
        try:
            return accuracy.fitted_bh_pass(st.pos, st.mass, st.alive, cfg,
                                           params, caps)
        finally:
            traverse.hier_accel = real

    acc, need, fit = one_pass(keep)
    acc_md, need_md, _ = one_pass(traverse.hier_accel_ref)
    if fit != caps or need != need_md:
        raise AssertionError(f"bh_hier: the needs differ from the "
                             f"masked-dense route's: {need} against "
                             f"{need_md} (caps {caps}, fitted {fit})")
    err_md, scale = _check_close("bh_hier pass vs the masked-dense route",
                                 acc, acc_md)
    print(f"bh_hier pass vs the masked-dense route (bh_pairs): max|diff| "
          f"{err_md:.3e} (max|a| {scale:.3e}); needs equal: {need}",
          flush=True)

    args, kw = seen["args"], dict(seen["kw"], counts=False)
    got, cnt, walked = real(*args, **dict(kw, counts=True))
    md, md_cnt, md_slots = traverse.hier_accel_ref(*args,
                                                   **dict(kw, counts=True))
    torch.cuda.synchronize()
    if not torch.equal(cnt, md_cnt):
        bad = int((cnt != md_cnt).any(dim=1).sum())
        raise AssertionError(f"bh_hier: per-group counts differ from the "
                             f"masks' in {bad} groups")
    err_rows, _ = _check_close("bh_hier vs the masked-dense rows", got, md)

    def plain():
        return traverse.hier_accel_ref(
            *args, **dict(kw, pair_sum=traverse.point_accel_ref))

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain()
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err, scale = _check_close("bh_hier vs its plain version", got, want)
    del want, md
    ms = timed_ms(lambda: real(*args, **kw))
    work = traverse.hier_pair_work(cnt, args[6], args[0], args[1], args[3])
    needed = work["pairs"]
    print(f"bh_hier pass: {ms:.4f} ms against plain {plain_ms:.1f} ms (one "
          f"run), max|diff| {err:.3e} (max|a| {scale:.3e}); pairs walked "
          f"{int(walked):.4e} against {needed:.4e} needed "
          f"({int(walked) / needed:.3f}x); the masked-dense route's slots "
          f"{md_slots:.4e}; counts equal in {cnt.shape[0]} groups",
          flush=True)

    # the chunk with the most direct bodies, cut out
    ids = args[3]
    C, CH = ids.shape[0], args[5].shape[0] // ids.shape[0]
    c = int(cnt[:, 1].reshape(C, CH).sum(dim=1).argmax())
    g = slice(c * CH, (c + 1) * CH)
    cut = (*args[:3], ids[c:c + 1], args[4][c:c + 1],
           *(x[g] for x in args[5:10]), *args[10:])
    r = _compare(
        f"bh_hier chunk {c}: {CH} groups, {ids.shape[1]} candidates, "
        f"{int(cnt[g, 1].sum())} direct bodies",
        lambda: real(*cut, **kw),
        lambda: traverse.hier_accel_ref(
            *cut, **dict(kw, pair_sum=traverse.point_accel_ref)))
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               **bounds(work, ms, n_sm, max_clock_hz),
               pairs_walked=int(walked),
               walked_over_needed=int(walked) / needed,
               masked_dense_slots=md_slots,
               masked_dense_max_abs_err=err_rows,
               pass_vs_masked_dense=err_md, groups=cnt.shape[0],
               candidates=ids.shape[1],
               chunk=dict(r, index=c, groups=CH,
                          direct_bodies=int(cnt[g, 1].sum())))
    print(f"  bh_hier: bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}), {out['pct_of_bound']:.2f}% of it; rsqrt "
          f"floor {out['rsqrt_floor_ms']:.4f} ms", flush=True)
    return out


def _bh_cell(dev):
    """(cfg, params, engine, n_bodies) of the Barnes–Hut cell (BH_CELL: its
    node table, groups, hier sizes and candidate caps; N = 1M on the
    two-disk scene, seed 3)."""
    from tpu_nbody_torch.config import Params, SimConfig
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, BH_CELL)) as f:
        cell = json.load(f)
    sim = {k: tuple(v) if isinstance(v, list) else v
           for k, v in cell["sim_config"].items()}
    cfg = SimConfig(capacity=cell["capacity"], world_w=cell["world_w"],
                    world_h=cell["world_h"], **sim)
    params = Params.default(**cell["params"])
    eng = _engine(cfg, params, dev, cell["n_bodies"], solver="bh",
                  integrator="kdk_reuse")
    return cfg, params, eng, cell["n_bodies"]


def _bh_lists_shape(cfg, params, eng, n_bodies):
    """The lists kernel at the Barnes–Hut cell's shape (:func:`_bh_cell`):
    on the arguments a lists-only pass hands ``traverse.hier_lists``, the
    kernel against the plain version bit for bit (the final lists, their
    validity and every need), the kernel per call (``_per_call``: 2 + 3 x
    levels device operations, counted after the bench) against its bytes
    bound (``traverse.lists_work``) and the plain version's time (median
    of 3)."""
    import torch
    from tpu_nbody_torch import engine
    from tpu_nbody_torch.ops import traverse
    seen = {}
    real = traverse.hier_lists

    def keep(*args, **kw):
        seen.update(args=args, kw=kw)
        return real(*args, **kw)

    traverse.hier_lists = keep
    try:
        st = eng.state
        engine.make_bh_accel(cfg, eng.caps, evaluate=False)(
            st.pos, st.mass, st.alive, params)
    finally:
        traverse.hier_lists = real
    args, kw = seen["args"], seen["kw"]
    tree, gmin, gmax, theta2, soft2 = args
    levels = traverse._lists_plan(tree.node_rows.shape[0], gmin.shape[0],
                                  kw["sizes"], kw["kcaps"])

    def kernel():
        return traverse._lists_launch(
            tree.node_rows, tree.n_nodes, gmin, gmax, theta2, soft2, levels,
            kw["slots"], kw["n_slots"],
            min(kw["leaf_list_cap"], levels[-1].K))

    def plain():
        return traverse.hier_lists_ref(*args, **kw)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    for name, g, w in zip(("ids", "cvalid", "leaf_need", "direct_need",
                           "cand_need"),
                          (got.ids[-1], got.cvalid, got.leaf_need,
                           got.direct_need, got.cand_need), want):
        if not torch.equal(g, w):
            raise AssertionError(f"bh_lists at the cell's shape: {name} "
                                 f"differs from the plain version's")
    del want
    call = _per_call("bh_lists", kernel, 2 + 3 * len(levels))
    plain_ms = timed_ms(plain, reps=3, warmup=1)
    work = traverse.lists_work(levels, got.totals, int(tree.n_nodes),
                               gmin.shape[0])
    out = dict(ms=call["device_ms"], plain_ms=plain_ms, call=call,
               **bounds(work, call["device_ms"]), bytes=work["bytes"],
               flops=work["flops"], levels=[lv._asdict() for lv in levels],
               totals_max=[int(t.max()) for t in got.totals],
               leaf_need=int(got.leaf_need),
               direct_need=int(got.direct_need))
    print(f"bh_lists at the cell's shape (N={n_bodies}, levels "
          f"{[tuple(lv) for lv in levels]}): lists, validity and needs equal "
          f"the plain version's; {call['device_ms']:.4f} ms on the device, "
          f"{call['call_ms']:.4f} a call, {call['host_enqueue_ms']:.4f} to "
          f"enqueue; plain {plain_ms:.2f} ms; bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}, {work['bytes'] / 1e9:.3f} GB), "
          f"{out['pct_of_bound']:.2f}% of it; largest totals "
          f"{out['totals_max']}, leaf_need {out['leaf_need']}, direct_need "
          f"{out['direct_need']}", flush=True)
    return out


def _bh_tree_shape(cfg, eng, n_bodies):
    """The tree build at the Barnes–Hut cell's state (:func:`_bh_cell`):
    the kernels' build against the plain one bit for bit (every integer
    field, the sorted bodies, the root and the rows' geometry columns),
    mass and centre of mass within 1e-6 of it; the build per call
    (``_per_call``: the codes kernel, the sort's operations and the build
    kernel, counted after the bench); the kernels alone on the sort's
    order (the build's time with ``argsort`` left out) and the sort alone,
    on the device; the kernels' time against their bytes bound
    (``tree.build_work``); the plain build on the card (median of 3),
    which no library call computes: ``library_ms`` repeats it, a yardstick
    the port no longer calls on a card."""
    import torch
    from tpu_nbody_torch.engine import _root
    from tpu_nbody_torch.ops import tree
    st = eng.state
    origin, side = _root(cfg)
    mass = torch.where(st.alive, st.mass, 0.0)
    kw = dict(num_nodes=eng.caps.num_nodes, leaf_size=cfg.leaf_size,
              max_depth=cfg.max_depth)
    geo = tree._geometry(origin, side)

    def build():
        return tree.build_tree(st.pos, mass, st.alive, origin, side, **kw)

    def plain():
        return tree.build_tree_ref(st.pos, mass, st.alive, origin, side,
                                   **kw)

    got, want = build(), plain()
    torch.cuda.synchronize()
    for name in ("code", "level", "start", "count", "child", "n_children",
                 "parent", "n_nodes", "node_need", "sidx", "unsort",
                 "n_alive", "spos", "smass", "body_rows", "origin",
                 "root_side"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"bh_tree at the cell's state: {name} "
                                 f"differs from the plain build's")
    if not torch.equal(got.node_rows[:, 3:], want.node_rows[:, 3:]):
        raise AssertionError("bh_tree at the cell's state: the node rows' "
                             "geometry differs from the plain build's")
    rel = max(float(((g - w).abs() / w.abs().clamp(min=1e-30)).max())
              for g, w in ((got.mass, want.mass), (got.com, want.com),
                           (got.node_rows[:, :3], want.node_rows[:, :3])))
    if not rel <= 1e-6:
        raise AssertionError(f"bh_tree at the cell's state: mass or centre "
                             f"of mass {rel:.3e} from the plain build's")
    del want
    codes = tree._codes_launch(st.pos, st.alive, geo)
    order = torch.argsort(codes, stable=True)

    def kernels():
        return tree._sorted_launch(
            st.pos, mass, tree._codes_launch(st.pos, st.alive, geo), order,
            geo, kw["num_nodes"], kw["leaf_size"], kw["max_depth"])

    # the codes and build kernels and the operations of the sort alone
    call = _per_call("bh_tree", build, lambda: 2 + len(device_ops(
        lambda: torch.argsort(codes, stable=True))))
    kernels_ms = device_ms(kernels)
    sort_ms = device_ms(lambda: torch.argsort(codes, stable=True))
    plain_ms = timed_ms(plain, reps=3, warmup=1)
    work = tree.build_work(st.pos.shape[0], kw["num_nodes"])
    out = dict(ms=call["device_ms"], kernels_ms=kernels_ms, sort_ms=sort_ms,
               plain_ms=plain_ms, library_ms=plain_ms,
               library="none: the plain build_tree_ref on the card "
                       "(plain_ms), which the port no longer calls there",
               call=call, **bounds(work, kernels_ms), bytes=work["bytes"],
               flops=work["flops"], n_nodes=int(got.n_nodes),
               node_need=int(got.node_need), n_alive=int(got.n_alive),
               mass_com_rel=rel)
    print(f"bh_tree at the cell's state (N={n_bodies}, {out['n_nodes']} "
          f"nodes): every integer field equals the plain build's, mass and "
          f"centre of mass within {rel:.2e}; {call['device_ms']:.4f} ms on "
          f"the device, {call['call_ms']:.4f} a call, "
          f"{call['host_enqueue_ms']:.4f} to enqueue; without the sort "
          f"{kernels_ms:.4f} ms (the sort {sort_ms:.4f}); bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']}, "
          f"{work['bytes'] / 1e6:.1f} MB), {out['pct_of_bound']:.2f}% of "
          f"it; plain build {plain_ms:.2f} ms", flush=True)
    return out


def _path_d(paths, cfg, params, dev, st0, n_sm, max_clock_hz, results):
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
        for label, n in BH_STEPS:
            if label == "timed":
                changed = bh.tighten_caps()
                print(f"  tighten_caps: changed={changed} {bh.caps}",
                      flush=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bh.step(n)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            print(f"  step({n}) {label}: {dt:.3f} s; caps {bh.caps}",
                  flush=True)
        return dt / n, n0, int(bh.state.n_alive())

    sec, n0, n1 = paths.run("bh_engine", run,
                            need=("bh_tree", "bh_hier", "merge"))
    counts = paths.counts["bh_engine"]
    steps = sum(n for _, n in BH_STEPS)
    if (counts != _only(bh_tree=counts["bh_hier"], bh_hier=counts["bh_hier"],
                        bh_lists=counts["bh_hier"], merge=counts["merge"])
            or counts["merge"] < steps):
        raise AssertionError(f"Barnes–Hut steps launched another kernel "
                             f"than the tree, hier, lists and merge "
                             f"kernels, the tree or the lists other than "
                             f"once an evaluated pass, or fewer than "
                             f"{steps} merges: {counts}")
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
    results["bh_hier"] = paths.run(
        "bh_hier_check", lambda: _bh_hier_shape(st, cfg, params, bh.caps,
                                                n_sm, max_clock_hz),
        need=("bh_tree", "bh_hier", "bh_pairs", "bh_lists"))

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
    paths.run("bh_force_error", bh_error,
              need=("allpairs", "bh_tree", "bh_hier", "bh_lists"))
    del bh
    cell = _bh_cell(dev)
    results["bh_lists"] = _bh_lists_shape(*cell)
    results["bh_tree"] = _bh_tree_shape(cell[0], cell[2], cell[3])
    del cell
    torch.cuda.empty_cache()

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

    def three_scenes():
        sg = torch.Generator(device=dev).manual_seed(3)
        needs("two-disk", st0)
        for name, pvm in (
                ("uniform cloud", scenes.make_uniform_cloud(sg, N)),
                ("4-galaxy merger",
                 scenes.multi_galaxy_merger(sg, n_total=N))):
            needs(name, state_lib.from_arrays(*pvm, cfg.capacity,
                                              device=dev))
    paths.run("bh_needs", three_scenes, need=("bh_tree", "bh_lists"))

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
    paths.run("bh_open_all", open_all,
              need=("allpairs", "bh_tree", "bh_pairs"))

    def small_error():
        e = accuracy.sampled_force_error(s, small, params, SAMPLES, g,
                                         solver="bh")
        print(f"bh theta={params.theta} N={N_SMALL} (dense): force error "
              f"mean {e['mean']:.3e} p99 {e['p99']:.3e}", flush=True)
    paths.run("bh_small_force_error", small_error,
              need=("allpairs", "bh_tree", "bh_pairs"))
    results["bh_pairs"] = _bh_pairs_shape(s, small, params, n_sm,
                                          max_clock_hz)

    def dense_and_hier():
        for trav in ("dense", "hier"):
            c = dataclasses.replace(small, bh_traversal=trav)
            accs[trav], _, _ = accuracy.fitted_bh_pass(s.pos, s.mass,
                                                       s.alive, c, params)

    accs = {}
    paths.run("bh_dense_vs_hier", dense_and_hier,
              need=("bh_tree", "bh_pairs", "bh_hier", "bh_lists"))
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
    ms = timed_ms(lambda: kernel(mass), reps=5)
    plan = forces._card_plan(n, n, 3, pos.device)
    bound = bounds(forces.pair_work(n, n, 3), ms, n_sm, max_clock_hz)
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


def _check_splat(paths, path, name, bodies, view, mode="speed", gain=1.0):
    """One frame of ``bodies`` = (pos2, vel, mass, alive) on the card, with
    sprites off and at SPRITE_SCALE: the kernel's additive splat
    (``render._splat_launch``, csrc/render.cu) rendered twice and the
    plain one once on the CPU from the same arrays (the pixel indices are
    then equal and only the order of the adds differs), each within
    RENDER_TOL of the brightest pixel; render_frame, run as ``path`` (and
    ``path``_sprites) of ``paths``, one kernel launch and no other, not
    all black, its uint8 frame within 1 level of the CPU's; the frame
    without sprites timed with CUDA events."""
    import torch
    from tpu_nbody_torch.ops import render
    for sprites in (0.0, SPRITE_SCALE):
        kw = dict(width=view["width"], height=view["height"],
                  view_x=view.get("view_x", 0.0),
                  view_y=view.get("view_y", 0.0), zoom=view.get("zoom", 1.0),
                  mode=mode, speed_scale=view["speed_scale"], gain=gain,
                  size_base=1.0, size_mass_scale=sprites)
        sums = [render._splat_launch(*bodies, **kw) for _ in range(2)]
        cpu = render._splat_sum(*[x.cpu() for x in bodies], **kw)
        peak = float(cpu.max())
        again = float((sums[0] - sums[1]).abs().max())
        host = float((sums[0].cpu() - cpu).abs().max())
        run = f"{path}_sprites" if sprites else path
        frame = paths.run(run, lambda: render.to_uint8(
            render.render_frame(*bodies, **kw)), need=("render",))
        lit = int((frame.sum(dim=2) > 0).sum())
        if paths.counts[run] != _only(render=1):
            raise AssertionError(f"{name}: render_frame launched "
                                 f"{paths.counts[run]}, expected one splat "
                                 f"kernel and no other")
        if not (frame.device == bodies[0].device and lit > 0
                and torch.isfinite(sums[0]).all()):
            raise AssertionError(f"{name}: the frame is black, not finite or "
                                 f"not on the bodies' device")
        if not (again <= RENDER_TOL * peak and host <= RENDER_TOL * peak):
            raise AssertionError(
                f"{name}: splat sums differ: two renders {again:.3e}, card "
                f"against CPU {host:.3e} > {RENDER_TOL} x {peak:.3e} "
                f"(size_mass_scale {sprites})")
        levels = int((frame.cpu().int() - render.to_uint8(
            torch.clamp(cpu, 0.0, 1.0)).int()).abs().max())
        if levels > 1:
            raise AssertionError(f"{name}: uint8 frame {levels} levels from "
                                 f"the CPU's (size_mass_scale {sprites})")
        if not sprites:
            ms = timed_ms(lambda: render.render_frame(*bodies, **kw))
        print(f"render {name} {kw['width']}x{kw['height']} {mode}, "
              f"size_mass_scale {sprites}: {lit} lit pixels, brightest sum "
              f"{peak:.1f}, two renders differ by {again:.3e}, card against "
              f"CPU {host:.3e}, uint8 within {levels}", flush=True)
    print(f"render {name}: {ms:.3f} ms a frame without sprites", flush=True)
    return ms


def _splat_row(bodies):
    """The kernel's row at the frames cell's shape (2400 x 800 at zoom 1,
    speed mode, size_mass_scale SPRITE_SCALE) on ``bodies`` (the stepped
    main path's state, in slot order, as the engine returns it): the
    kernel's device time (the memset and the kernel) against its bound
    (``render.splat_work``); render_frame a call on an idle card; and the
    plain version on the card, the 21-pass index_add_ render_frame the
    port ran before the kernel (``_splat_sum`` and its clip). No library
    call computes the splat: ``library_ms`` is that same retired plain
    path, the yardstick the port no longer calls, not a timing of its
    own."""
    import torch
    from tpu_nbody_torch.ops import render
    w, h = FRAMES_VIEW
    kw = dict(width=w, height=h, view_x=0.0, view_y=0.0, zoom=1.0,
              mode="speed", speed_scale=1.0 / 300.0, gain=1.0, size_base=1.0,
              size_mass_scale=SPRITE_SCALE)
    cap = bodies[0].shape[0]
    work = render.splat_work(cap, w, h, bodies[1].shape[1])
    out = dict(kernel_ms=device_ms(lambda: render._splat_launch(*bodies,
                                                                **kw)),
               frame_ms=timed_ms(lambda: render.render_frame(*bodies, **kw)),
               plain_ms=timed_ms(lambda: torch.clamp(
                   render._splat_sum(*bodies, **kw), 0.0, 1.0)))
    out.update(library_ms=out["plain_ms"],
               library="none: the plain 21-pass index_add_ render_frame "
                       "(plain_ms), which the port no longer calls on a card")
    b = bounds(work, out["kernel_ms"])
    out.update(bound_ms=b["bound_ms"], pct_of_bound=b["pct_of_bound"])
    print(f"render splat kernel {cap} slots {w}x{h} speed, size_mass_scale "
          f"{SPRITE_SCALE}: {out['kernel_ms']:.4f} ms on the device (memset "
          f"and kernel), bound {b['bound_ms']:.5f} ms ({b['bound_by']}: "
          f"{work['bytes']} B, {work['flops']} flops), "
          f"{b['pct_of_bound']:.1f}% of it; render_frame "
          f"{out['frame_ms']:.4f} ms a call; the plain 21-pass index_add_ "
          f"render_frame (_splat_sum and its clip; library_ms) "
          f"{out['plain_ms']:.4f} ms", flush=True)
    return out


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
    if paths.counts["sphere3d_demo"] != _only(allpairs=SPHERE_FRAMES,
                                              render=SPHERE_FRAMES):
        raise AssertionError(f"sphere3d_demo: launches "
                             f"{paths.counts['sphere3d_demo']}, expected "
                             f"{SPHERE_FRAMES} all-pairs and splats and "
                             f"no other")
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
                                                  lambda s: s,
                                                  ("allpairs",)),
            need=("allpairs",))
        hold["result"] = big.state
    if paths.counts["sphere3d_engine"] != _only(allpairs=4):
        raise AssertionError(f"sphere3d_engine: launches "
                             f"{paths.counts['sphere3d_engine']}, expected "
                             f"4 all-pairs and no other")
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
            paths, "render_sphere", f"sphere N={cap}",
            (pos2, st.vel, st.mass, st.alive), view, gain=0.6)
        fb = render.render_frame_3d(st.pos, st.vel, st.mass, st.alive,
                                    gain=0.6, **cam)
        if int((fb.sum(dim=2) > 0).sum()) == 0:
            raise AssertionError("render_frame_3d: the frame is black")
        out["frame3d_ms"] = timed_ms(lambda: render.render_frame_3d(
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
    out = {mode: _check_splat(paths, f"render_pm_main_{mode}",
                              f"pm_main N={int(stepped.n_alive())}", bodies,
                              view, mode=mode)
           for mode in ("speed", "classic")}
    out["splat_row"] = _splat_row(bodies)

    step_once = engine.make_step_fn(cfg, engine.Caps.from_config(cfg), "pm",
                                    "kdk_reuse", False, 64, device=dev)

    def movie():
        t0 = time.perf_counter()
        final, frames = render.render_movie(
            st0, params, lambda s, p: step_once(s, p, n_steps=1)[0],
            n_frames=8, steps_per_frame=4, mode="speed", **view)
        torch.cuda.synchronize()
        return final, frames, time.perf_counter() - t0

    final, frames, sec = paths.run("render_movie_pm", movie,
                                   need=("band", "render"))
    if paths.counts["render_movie_pm"] != _only(merge=32, render=8,
                                                **dict.fromkeys(P3M_PASS, 64)):
        raise AssertionError(f"render_movie_pm: launches "
                             f"{paths.counts['render_movie_pm']}, expected "
                             f"64 of each of {P3M_PASS} (two passes a single "
                             f"step), 32 merge and 8 splats (one a frame)")
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


def _gathered_pass(step, grp, cfg, params, st):
    """One force pass of the sharded step ``step`` on the global state
    ``st``: resharded along the Hilbert curve, each rank's pass, and the
    accelerations with the resharded global state they belong to."""
    import torch
    from tpu_nbody_torch.parallel import mesh as pmesh
    from tpu_nbody_torch.parallel.sharded_pm import reshard_by_hilbert
    local = reshard_by_hilbert(st, grp, cfg)
    res = step.accel(local, params)
    return (torch.cat([r[0] for r in res]), res[0][1],
            pmesh.gather_state(local, grp), local)


def _path_f1(paths, cfg, params, dev, grp, g, n_sm, max_clock_hz, results):
    """The sharded P3M main path at N = 1M on P_RANKS thread ranks."""
    import torch
    from tpu_nbody_torch import accuracy, engine
    from tpu_nbody_torch.ops import band
    from tpu_nbody_torch.parallel import mesh as pmesh
    from tpu_nbody_torch.parallel import sharded, sharded_pm
    from tpu_nbody_torch.parallel.collectives import run_spmd
    from tpu_nbody_torch.parallel.engine import ShardedEngine

    P = grp.size
    print(f"path F1: ShardedEngine(solver='pm', integrator='kdk_reuse') on "
          f"{P} thread ranks of one card (one process, one stream), the "
          f"main path's configuration, N={N}, reshard_every={F_STEPS}",
          flush=True)
    se = ShardedEngine(cfg, params, mesh=grp, solver="pm",
                       integrator="kdk_reuse", reshard_every=F_STEPS, seed=3,
                       device=dev)
    se.reset_default_scene(n1=N - N // 5, n2=N // 5)
    torch.cuda.reset_peak_memory_stats()

    def run():
        n0 = int(se.state.n_alive())
        out = {}
        for label in ("warm-up", "timed"):
            c0 = _build.LAUNCHES.copy()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            se.step(F_STEPS)
            end.record()
            torch.cuda.synchronize()
            host = time.perf_counter() - t0
            (launches, rescues, selects, unions, boxes, interps, merges,
             deposits, fds) = (_build.LAUNCHES[k] - c0[k] for k in (
                 "band", "rescue", "rescue_select", "select_unions",
                 "boxes", "interp", "merge", "deposit", "fd"))
            print(f"  step({F_STEPS}) {label}: {host:.3f} s host, "
                  f"{start.elapsed_time(end):.1f} ms device events, "
                  f"{launches} band launches, {rescues} rescue launches, "
                  f"{selects} rescue_select launches, {unions} union "
                  f"launches, {boxes} boxes launches, {interps} interp "
                  f"launches, {deposits} deposit launches, {fds} fd "
                  f"launches, {merges} merge launch sets", flush=True)
            if label == "timed" and (launches != P * (F_STEPS + 1)
                                     or rescues != 2 * launches
                                     or selects != 3 * launches
                                     or unions != 2 * launches
                                     or boxes != 2 * launches
                                     or interps != launches
                                     or deposits != launches
                                     or fds != launches
                                     or merges != 2 * P * F_STEPS):
                raise AssertionError(
                    f"sharded pm: {launches} band, {rescues} rescue, "
                    f"{selects} rescue_select, {unions} union, {boxes} "
                    f"boxes, {interps} interp, {deposits} deposit, {fds} "
                    f"fd and {merges} merge launches in step({F_STEPS}), "
                    f"expected {P} band a force pass x {F_STEPS + 1} "
                    f"passes, two rescues and two block-box builds (local, "
                    f"cross-shard), three selections (local; the "
                    f"cross-shard export scores and import picks), two "
                    f"union tables (the export's and the import's) and one "
                    f"interpolation, one "
                    f"deposit and one FD gradient a band launch, and two "
                    f"merge launch sets (the heavy table, then the "
                    f"absorb) a rank's step")
            out[label] = (host / F_STEPS, start.elapsed_time(end) / F_STEPS)
        return out, n0

    times, n0 = paths.run("sharded_pm", run,
                          need=P3M_PASS + ("merge", "select_unions"))
    sec, dev_ms = times["timed"]
    st = se.state
    n1 = int(st.n_alive())
    if not all(bool(torch.isfinite(x).all()) for x in (st.pos, st.vel,
                                                        st.mass)):
        raise AssertionError("sharded pm: state is not finite")
    if n1 > n0:
        raise AssertionError(f"sharded pm: n_alive grew: {n0} -> {n1}")
    print(f"sharded_pm P={P}: {1e3 * sec:.2f} ms/step host clock "
          f"({dev_ms:.2f} ms/step between CUDA events), {n1 / sec:.1f} "
          f"body-updates/s, n_alive {n0} -> {n1}; needs: heavy "
          f"{se.last_heavy_need} (cap {se.heavy_cap_local}), rescue "
          f"{se.last_rescue_need} (k {cfg.mesh_rescue}), xport "
          f"{se.last_xport_need} (cap {se.xrescue_export}), ximport "
          f"{se.last_ximport_need} (k {cfg.mesh_xrescue}), mesh_oob "
          f"{se.last_mesh_oob}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if se.last_xport_need > se.xrescue_export:
        raise AssertionError("sharded pm: the cross-shard export still "
                             "overflows after the retune")

    # one sharded pass of the gathered state: its force error, and its
    # difference from the one-device pass on the same bodies
    step = sharded_pm.make_sharded_pm_step(
        grp, cfg, integrator="kdk_reuse",
        heavy_cap_local=se.heavy_cap_local,
        xrescue_export=se.xrescue_export)

    def error():
        acc, needs, gst, local = _gathered_pass(step, grp, cfg, params, st)
        e = accuracy.sampled_error(acc, gst.pos, gst.mass, gst.alive, params,
                                   SAMPLES, g)
        one = engine.make_pm_accel(cfg, dev)
        acc1, _ = one(gst.pos, gst.mass, gst.alive, params,
                      kernel=one.prepare(params))
        rel = _rel_err(acc, acc1)[gst.alive]
        print(f"sharded_pm step {int(st.step)}: force error vs exact "
              f"({e['samples']} sampled bodies): mean {e['mean']:.3e} p50 "
              f"{e['p50']:.3e} p99 {e['p99']:.3e} max {e['max']:.3e}; "
              f"against the one-device pm_accel on the same bodies: mean "
              f"relative difference {float(rel.mean()):.3e}, max "
              f"{float(rel.max()):.3e}; pass needs (rescue, xport, "
              f"ximport, oob) {needs.tolist()}", flush=True)
        if not e["mean"] <= ERR_LIMIT:
            raise AssertionError(f"sharded pm: mean force error "
                                 f"{e['mean']:.3e} > {ERR_LIMIT:.3e}")
        return gst, local, float(rel.mean())

    gst, local, rel_mean = paths.run(
        "sharded_pm_force_error", error,
        need=("band", "rescue", "rescue_select", "boxes", "allpairs"))
    counts = paths.counts["sharded_pm_force_error"]
    if (counts["band"] != P + 1 or counts["rescue_select"] != 3 * P + 1
            or counts["boxes"] != 2 * P + 1
            or counts["select_unions"] != 2 * P
            or any(counts[k] != P + 1 for k in ("interp", "deposit", "fd"))):
        raise AssertionError(
            f"sharded pm: {counts} launches for a sharded and a one-device "
            f"pass, expected {P} + 1 band, {3 * P} + 1 rescue_select, "
            f"{2 * P} select_unions, {2 * P} + 1 boxes and {P} + 1 each of "
            f"interp, deposit and fd")

    # one pass by phase on rank 0, CUDA events; every rank enqueues on the
    # one stream, so a phase's time holds the other ranks' work enqueued
    # between rank 0's marks, which the collectives keep in step
    clock = Recorder(events=True)

    def probe(name):
        if grp.rank == 0:
            clock(name)

    timed = sharded_pm.make_sharded_pm_step(
        grp, cfg, integrator="kdk_reuse",
        heavy_cap_local=se.heavy_cap_local,
        xrescue_export=se.xrescue_export, probe=probe)
    torch.cuda.synchronize()
    clock("start")
    t0 = time.perf_counter()
    timed.accel(local, params)
    enqueue_ms = 1e3 * (time.perf_counter() - t0)

    def merge(s):
        probe("start")
        out = sharded._merge_sharded(s, params, group=grp,
                                     heavy_cap_local=se.heavy_cap_local)
        probe("merge")
        return out

    run_spmd(grp, merge, local)
    ms = clock.ms()
    print("sharded_pm pass by phase on rank 0 (ms, all ranks' work between "
          "its marks): " + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
          + f"; total {sum(ms.values()):.2f}; the host took "
          f"{enqueue_ms:.2f} ms to enqueue the pass", flush=True)
    # the same pass on one rank (no threads) and on P thread ranks, CUDA
    # events
    one = pmesh.make_mesh(1, device=dev)
    local1 = sharded_pm.reshard_by_hilbert(gst, one, cfg)
    step1 = sharded_pm.make_sharded_pm_step(one, cfg, integrator="kdk_reuse")
    p1_ms = timed_ms(lambda: step1.accel(local1, params), reps=3)
    pp_ms = timed_ms(lambda: step.accel(local, params), reps=3)
    print(f"sharded_pm pass, median of 3: {p1_ms:.2f} ms on 1 rank, "
          f"{pp_ms:.2f} ms on {P} thread ranks", flush=True)
    del local1, step1

    # the band kernel at the sharded shape: rank 0's rows and the halos
    S = cfg.mesh_band
    _, _, _, _, _, a, _ = _geometry(cfg)
    r0, r1 = local[0], local[1]
    fields = torch.cat([r0.pos, torch.where(r0.alive, r0.mass, 0.0)[:, None]],
                       dim=1)
    halo = torch.cat([r1.pos[:S], torch.where(r1.alive[:S], r1.mass[:S],
                                              0.0)[:, None]], dim=1)
    ext = torch.cat([torch.zeros_like(halo), fields, halo])
    ep, em = ext[:, :2].contiguous(), ext[:, 2].contiguous()
    rows = ep.shape[0]
    r = _compare(
        f"band {cfg.mesh_switch} S={S} sharded rows {rows}",
        lambda: band.band_short_range(ep, em, params.soft2, a, band=S,
                                      chunk=cfg.mesh_chunk,
                                      switch=cfg.mesh_switch),
        lambda: band.band_short_range_ref(ep, em, params.soft2, a, band=S,
                                          chunk=cfg.mesh_chunk,
                                          switch=cfg.mesh_switch))
    results["band"]["sharded_shape"] = dict(
        r, rows=rows, **bounds(band.pair_work(rows, S, cfg.mesh_switch),
                               r["ms"], n_sm, max_clock_hz))
    del se, step, timed, gst, local
    return dict(ms_per_step=1e3 * sec, device_ms_per_step=dev_ms,
                body_updates_per_s=n1 / sec, rel_to_one_device=rel_mean,
                pass_ms_1_rank=p1_ms, pass_ms_p_ranks=pp_ms)


def _geometry(cfg):
    from tpu_nbody_torch import engine
    from tpu_nbody_torch.ops import mesh
    origin, side = engine._root(cfg)
    return mesh._pm_geometry(origin, side, cfg.mesh_level, cfg.mesh_ny,
                             cfg.mesh_split)


def _path_f2(paths):
    """merger10m at its own size on P_RANKS thread ranks."""
    import torch
    from tpu_nbody_torch.examples import merger10m
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = MERGER_ARGS + ["--device", DEVICE]
    print(f"path F2: python -m tpu_nbody_torch.examples.merger10m "
          f"{' '.join(args)}", flush=True)
    r = paths.run("merger10m", lambda: merger10m.main(args),
                  need=P3M_PASS + ("merge",))
    n_total = int(args[args.index("--n") + 1])
    alive = [n for _, n, _ in r["lines"]]
    st = r["engine"].state
    if not (alive == sorted(alive, reverse=True) and alive[0] <= n_total
            and all(bool(torch.isfinite(x).all()) for x in (st.pos, st.vel,
                                                            st.mass))
            and all(torch.isfinite(torch.tensor(ke)) for _, _, ke in
                    r["lines"])):
        raise AssertionError(f"merger10m: n_alive grew or the state is not "
                             f"finite: {r['lines']}")
    print(f"merger10m: {r['updates_per_s']:.1f} body-updates/s "
          f"({r['seconds']:.2f} s for the steps, stats and gathers), "
          f"n_alive {alive}, launches {paths.counts['merger10m']}, peak "
          f"memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    out = dict(updates_per_s=r["updates_per_s"], seconds=r["seconds"])
    del r, st
    torch.cuda.empty_cache()
    return out


def _path_f3(paths, params, dev, grp, n_sm, max_clock_hz, results):
    """Sharded all-pairs against the one-device all-pairs engine."""
    import torch
    from tpu_nbody_torch.config import SimConfig
    from tpu_nbody_torch.engine import Engine
    from tpu_nbody_torch.ops import forces
    from tpu_nbody_torch.parallel import sharded
    from tpu_nbody_torch.parallel.collectives import run_spmd
    from tpu_nbody_torch.parallel.engine import ShardedEngine

    P = grp.size
    cfg3 = SimConfig(capacity=N_F3, **CFG)
    print(f"path F3: ShardedEngine(solver='allpairs', kdk) on {P} ranks "
          f"against Engine(solver='allpairs', kdk), N={N_F3}, step(2)",
          flush=True)
    se = ShardedEngine(cfg3, params, mesh=grp, solver="allpairs",
                       integrator="kdk", seed=3, device=dev)
    se.reset_default_scene(n1=N_F3 - N_F3 // 5, n2=N_F3 // 5)
    one = Engine(cfg3, params, solver="allpairs", integrator="kdk",
                 device=dev)
    one.state = se.state          # the same bodies in the same slots
    local = [s for s in se._local]

    # one force pass: the ring's accelerations against the one-device
    # kernel's on the same bodies, within 1e-5 of max |a| (a ring round
    # that skipped or repeated a tile would show here, where two steps'
    # positions hide it)
    def ring_pass():
        return torch.cat(run_spmd(
            grp, lambda s: sharded.ring_allpairs_accel(
                s.pos, torch.where(s.alive, s.mass, 0.0), params.G,
                params.soft2, group=grp), local))

    a_ring = paths.run("sharded_allpairs_pass", ring_pass,
                       need=("allpairs",))
    st0 = one.state
    a_one = forces.accel_allpairs(st0.pos, torch.where(st0.alive, st0.mass,
                                                       0.0),
                                  params.G, params.soft2)
    da = float((a_ring - a_one).abs().max())
    amax = float(a_one.abs().max())
    launches = paths.counts["sharded_allpairs_pass"]["allpairs"]
    print(f"sharded_allpairs one force pass: {launches} launches, max "
          f"|a_ring - a_one| {da:.3e} = {da / amax:.3e} of max |a| "
          f"{amax:.3e}", flush=True)
    if launches != P * P or not da <= 1e-5 * amax:
        raise AssertionError(f"sharded allpairs force pass: {launches} "
                             f"launches (expected {P}^2), max difference "
                             f"{da:.3e} > 1e-5 x {amax:.3e}")
    del a_ring, a_one
    paths.run("sharded_allpairs", lambda: se.step(2),
              need=("allpairs", "merge"))
    paths.run("allpairs_one_device", lambda: one.step(2),
              need=("allpairs",))
    got = paths.counts["sharded_allpairs"]["allpairs"]
    if got != 4 * P * P:
        raise AssertionError(f"sharded allpairs: {got} launches in step(2) "
                             f"(kdk), expected {P}^2 a pass x 4")
    a, b = se.state, one.state
    dpos = float((a.pos - b.pos).abs().max())
    ok = (torch.equal(a.alive, b.alive)
          and torch.allclose(a.pos, b.pos, rtol=2e-4, atol=2e-4)
          and torch.allclose(a.mass, b.mass, rtol=1e-6))
    print(f"sharded_allpairs P={P} N={N_F3}: {got} launches, against the "
          f"one-device engine max |dpos| {dpos:.3e} px, alive equal "
          f"{torch.equal(a.alive, b.alive)}, n_alive {int(a.n_alive())}",
          flush=True)
    if not ok:
        raise AssertionError("sharded allpairs disagrees with the one-device "
                             "engine (rtol 2e-4, atol 2e-4)")
    # the all-pairs kernel at a ring round's shape: rank 0's bodies against
    # rank 1's tile
    tgt, src = local[0], local[1]
    tm = torch.where(src.alive, src.mass, 0.0)
    n_t = tgt.pos.shape[0]
    r = _compare(
        f"allpairs ring tile {n_t} targets x {src.pos.shape[0]} sources",
        lambda: forces.accel_allpairs(src.pos, tm, 1.0, params.soft2,
                                      targets=tgt.pos),
        lambda: sharded._accel_vs_tile(tgt.pos, src.pos, tm, params.soft2))
    results["allpairs"]["ring_tile_shape"] = dict(
        r, targets=n_t, sources=src.pos.shape[0],
        **bounds(forces.pair_work(n_t, src.pos.shape[0], 2), r["ms"], n_sm,
                 max_clock_hz))
    del se, one, local


def _path_f4(paths, params, dev, grp, g, n_sm, max_clock_hz, results):
    """Sharded Barnes–Hut at N = 65,536: its force error and LET needs."""
    import torch
    from tpu_nbody_torch import accuracy
    from tpu_nbody_torch.config import SimConfig
    from tpu_nbody_torch.ops import forces
    from tpu_nbody_torch.parallel import sharded_bh
    from tpu_nbody_torch.parallel.engine import ShardedEngine

    P = grp.size
    cfg4 = SimConfig(capacity=N_F4)
    print(f"path F4: ShardedEngine(solver='bh', kdk_reuse) on {P} ranks, "
          f"N={N_F4}, theta={params.theta}, step(2)", flush=True)
    se = ShardedEngine(cfg4, params, mesh=grp, solver="bh",
                       integrator="kdk_reuse", seed=3, device=dev)
    se.reset_default_scene(n1=N_F4 - N_F4 // 5, n2=N_F4 // 5)
    t0 = time.perf_counter()
    paths.run("sharded_bh", lambda: se.step(2),
              need=("allpairs", "bh_tree", "bh_pairs", "merge"))
    sec = time.perf_counter() - t0
    print(f"sharded_bh step(2): {sec:.2f} s (retune rounds included), "
          f"{paths.counts['sharded_bh']['allpairs']} all-pairs launches "
          f"(the import sums), {paths.counts['sharded_bh']['bh_pairs']} "
          f"pair-kernel launches (the local trees); LET needs: export "
          f"{se.last_export_need} "
          f"(caps {se.let_approx_cap} + {se.let_body_cap}), leaf/frontier "
          f"caps {se.let_leaf_cap}/{se.let_frontier_cap}; traversal needs "
          f"{se.last_stats}", flush=True)
    step = sharded_bh.make_sharded_bh_step(
        grp, cfg4, se.caps, heavy_cap_local=se.heavy_cap_local,
        let_approx_cap=se.let_approx_cap, let_body_cap=se.let_body_cap,
        let_leaf_cap=se.let_leaf_cap, let_frontier_cap=se.let_frontier_cap)

    def error():
        acc, st, gst, local = _gathered_pass(step, grp, cfg4, params,
                                             se.state)
        e = accuracy.sampled_error(acc, gst.pos, gst.mass, gst.alive, params,
                                   SAMPLES, g)
        print(f"sharded_bh step {int(gst.step)}: force error vs exact "
              f"({e['samples']} sampled bodies): mean {e['mean']:.3e} p50 "
              f"{e['p50']:.3e} p99 {e['p99']:.3e} max {e['max']:.3e}; pass "
              f"needs: export {int(st.export_need)}, approx "
              f"{int(st.let_approx_need)}, leaf {int(st.let_leaf_need)}, "
              f"frontier {int(st.let_frontier_need)}", flush=True)
        if not e["mean"] <= BH_ERR_LIMIT:
            raise AssertionError(f"sharded bh: mean force error "
                                 f"{e['mean']:.3e} > {BH_ERR_LIMIT:.3e}")
        return local

    local = paths.run("sharded_bh_force_error", error,
                      need=("allpairs", "bh_tree", "bh_pairs"))
    # the all-pairs kernel at the LET import shape: rank 0's bodies against
    # (P, E, 3) rows, here the other ranks' first E bodies
    E = se.let_approx_cap + se.let_body_cap
    imports = torch.zeros((P, E, 3), device=dev)
    for r in range(1, P):
        s = local[r]
        k = min(E, s.pos.shape[0])
        imports[r, :k, :2] = s.pos[:k]
        imports[r, :k, 2] = torch.where(s.alive[:k], s.mass[:k], 0.0)
    tgt = local[0].pos
    res = _compare(
        f"allpairs LET import {tgt.shape[0]} targets x {P * E} rows",
        lambda: sharded_bh._import_sum(tgt, imports, params.G, params.soft2),
        lambda: params.G * sharded_bh._import_accel(tgt, imports,
                                                    params.soft2))
    results["allpairs"]["let_import_shape"] = dict(
        res, targets=tgt.shape[0], sources=P * E,
        **bounds(forces.pair_work(tgt.shape[0], P * E, 2), res["ms"], n_sm,
                 max_clock_hz))
    del se, step, local


def _path_f5(paths, dev):
    """dryrun_multichip on DRYRUN_RANKS ranks, and one step of entry() on
    the card against the same step on the CPU."""
    import torch
    from tpu_nbody_torch import graft_entry
    print(f"path F5: dryrun_multichip({DRYRUN_RANKS}) and one entry() step",
          flush=True)
    paths.run("dryrun_multichip",
              lambda: graft_entry.dryrun_multichip(DRYRUN_RANKS,
                                                   device=DEVICE),
              need=P3M_PASS + ("merge", "allpairs", "bh_tree",
                               "bh_pairs"))
    fn, (st, prm) = graft_entry.entry(device=DEVICE)
    t0 = time.perf_counter()
    out = paths.run("entry", lambda: fn(st, prm),
                    need=("bh_tree", "bh_pairs", "merge"))
    card_s = time.perf_counter() - t0
    cpu_fn, _ = graft_entry.entry(device="cpu")
    t0 = time.perf_counter()
    want = cpu_fn(type(st)(*(x.cpu() for x in st)), prm)
    cpu_s = time.perf_counter() - t0
    dpos = float((out.pos.cpu() - want.pos).abs().max())
    print(f"entry: one BH kdk step + merge of {int(st.n_alive())} bodies: "
          f"card {card_s:.2f} s, CPU {cpu_s:.2f} s; max |dpos| {dpos:.3e} "
          f"px, n_alive {int(out.n_alive())} / {int(want.n_alive())}; "
          f"launches {paths.counts['dryrun_multichip']} in the dry run",
          flush=True)
    if not (torch.equal(out.alive.cpu(), want.alive) and dpos <= 1e-3):
        raise AssertionError("entry: the card's step disagrees with the "
                             "CPU's")


def _path_f(paths, cfg, params, dev, n_sm, max_clock_hz, results):
    """Path F: the sharded paths on P_RANKS thread ranks of the one card."""
    import torch
    from tpu_nbody_torch.parallel import mesh as pmesh
    t0 = time.perf_counter()
    grp = pmesh.make_mesh(P_RANKS, device=dev)
    g = torch.Generator(device=dev).manual_seed(17)
    f1 = _path_f1(paths, cfg, params, dev, grp, g, n_sm, max_clock_hz,
                  results)
    f2 = _path_f2(paths)
    _path_f3(paths, params, dev, grp, n_sm, max_clock_hz, results)
    _path_f4(paths, params, dev, grp, g, n_sm, max_clock_hz, results)
    _path_f5(paths, dev)
    print(f"path F: {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(f1=f1, f2=f2)


def _step_trace(eng, steps=STEPS):
    """One bench ``step(steps)`` of the pm engine on the card, twice: once
    untraced, for its wall time and the host's enqueue time (from the
    call's entry to the start of its one host sync, the engine's call
    record, ``profiling.call_records``), and once under ``profiling.trace``,
    for the device's busy time (the union of its kernels, memsets and
    copies), its busy and idle shares of the step (of the traced step's
    host time, the profiler's overhead in it, and of the untraced wall
    time), its device operations a step and the kernels that take the
    most time."""
    import torch
    from tpu_nbody_torch import profiling
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step(steps)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    call = profiling.call_records()[-1]
    enqueue_ms = 1e-6 * (call.t_sync_start - call.t_enter)
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d):
            torch.cuda.synchronize()
            time.sleep(profiling.TRACE_PAD_S)
            with torch.profiler.record_function("bench_step"):
                eng.step(steps)
                torch.cuda.synchronize()
            time.sleep(profiling.TRACE_PAD_S)
        path = os.path.join(d, "trace.json")
        spans = profiling.trace_device_spans(path)
        with open(path) as f:
            marks = [e for e in json.load(f)["traceEvents"]
                     if e.get("name") == "bench_step"
                     and e.get("ph") == "X"
                     and e.get("cat") != "gpu_user_annotation"]
    if not marks or not spans:
        raise AssertionError(f"step trace: {len(marks)} step marks and "
                             f"{len(spans)} device operations in the trace")
    # every device operation of the trace is the step's (the trace holds
    # the step alone); the window is the step's host time up to its sync,
    # and the device's own clock spans the operations, so no time is
    # moved from one clock to the other
    window = float(marks[0]["dur"])
    busy = profiling.busy_us(spans)
    by_name = {}
    for e in spans:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = dict(steps=steps, wall_ms_per_step=wall_ms / steps,
               host_enqueue_ms_per_step=enqueue_ms / steps,
               traced_ms_per_step=window / 1e3 / steps,
               device_busy_ms_per_step=busy / 1e3 / steps,
               busy_share_traced=busy / window,
               idle_share_traced=1.0 - busy / window,
               busy_share_untraced=busy / 1e3 / wall_ms,
               idle_share_untraced=1.0 - busy / 1e3 / wall_ms,
               device_ops_per_step=len(spans) / steps,
               top_kernels_ms_per_step={k: v / 1e3 / steps for k, v in top})
    print(f"bench pm step({steps}) traced: device busy "
          f"{out['device_busy_ms_per_step']:.4f} ms a step of "
          f"{out['traced_ms_per_step']:.4f} traced "
          f"({100 * out['busy_share_traced']:.1f}% busy, "
          f"{100 * out['idle_share_traced']:.1f}% idle) and of "
          f"{out['wall_ms_per_step']:.4f} untraced "
          f"({100 * out['idle_share_untraced']:.1f}% idle); the host "
          f"enqueues a step in {out['host_enqueue_ms_per_step']:.4f} ms (untraced); "
          f"{out['device_ops_per_step']:.1f} device operations a step; "
          f"most time: "
          + ", ".join(f"{k[:60]} {v:.4f} ms" for k, v in
                      out["top_kernels_ms_per_step"].items()), flush=True)
    return out


def _path_g(paths):
    """Path G: the port's bench as a user runs it (module docstring).
    Returns, per solver, the JSON line, ms/step (median, min, max), the
    warm-up seconds and the mean force error; for pm also one traced step
    (``_step_trace``: the device's busy and idle shares, the host's
    enqueue)."""
    import torch
    from tpu_nbody_torch import bench
    out = {}
    for solver, (argv, need, limit) in BENCH_RUNS.items():
        print(f"path G: python -m tpu_nbody_torch.bench {' '.join(argv)}",
              flush=True)
        buf = io.StringIO()

        def run():
            with contextlib.redirect_stdout(buf):
                return bench.main(argv)

        rep = paths.run(f"bench_{solver}", run, need=need)
        text = buf.getvalue()
        print(text, end="", flush=True)
        lines = text.splitlines()
        if len(lines) != 1:
            raise AssertionError(f"bench {solver}: {len(lines)} stdout "
                                 f"lines, expected one JSON line")
        line = json.loads(lines[0])
        if (sorted(line) != ["metric", "unit", "value", "vs_baseline"]
                or line["unit"] != "bodies/s" or not line["value"] > 0):
            raise AssertionError(f"bench {solver}: bad JSON line {line}")
        err = rep["force_error"]["mean"]
        if not err <= limit:
            raise AssertionError(f"bench {solver}: mean force error "
                                 f"{err:.3e} > {limit:.3e}")
        rows = rep["phases"] or []
        missing = [p for p in BENCH_PHASES[solver]
                   if not any(r["name"].startswith(p) for r in rows)]
        if missing or not all(r["bound_ms"] > 0 and r["pct_of_bound"] > 0
                              for r in rows):
            raise AssertionError(f"bench {solver}: phase rows missing "
                                 f"{missing} or without a bound: {rows}")
        out[solver] = dict(line=line, ms_per_step=rep["ms_per_step"],
                           warmup_s=rep["warmup_s"], force_error=err)
        if solver == "pm":
            pm_engine = rep["engine"]
        print(f"bench {solver}: ms/step median {rep['ms_per_step'][0]:.3f} "
              f"[{rep['ms_per_step'][1]:.3f}-{rep['ms_per_step'][2]:.3f}], "
              f"warm-up {rep['warmup_s']:.2f} s, force error mean "
              f"{err:.4e}, launches {paths.counts[f'bench_{solver}']}",
              flush=True)
        del rep
        torch.cuda.empty_cache()
    # traced after every timed bench run: a profiler session leaves the
    # host's later launches slower in this process
    out["pm"]["step_trace"] = _step_trace(pm_engine)
    return out


def _cuda_tests():
    """The ``cuda``-marked tests in a child process (no jax there, so no
    conftest); fails on a non-zero exit."""
    import torch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = subprocess.run(CUDA_TESTS, capture_output=True, text=True,
                         timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    tail = res.stdout.strip().splitlines()[-1:] or [""]
    print(f"cuda tests: {' '.join(CUDA_TESTS[1:])}: exit {res.returncode}, "
          f"{tail[0]} ({time.perf_counter() - t0:.1f} s)", flush=True)
    if res.returncode != 0:
        print(res.stdout[-20000:], res.stderr[-4000:], sep="\n",
              file=sys.stderr)
        raise AssertionError(f"the cuda tests failed (exit "
                             f"{res.returncode})")


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
    card = card_info(dev)
    if card["smi"] is None:
        raise RuntimeError("nvidia-smi did not report the card's name and "
                           "power limit")
    print(card["smi"], flush=True)
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
    _count_hier_passes()
    _count_builds()

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
    spos, smass, salive, _ = mesh._hilbert_sort(st0.pos, st0.mass,
                                                st0.alive, origin, side)
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
            work = band.pair_work(cap, S, switch)
            # the window pairs poly4 weighs, beside every window pair
            near = band.band_cutoff_pairs(spos, smass, a, band=S,
                                          chunk=cfg.mesh_chunk)
            recount = bounds(dict(work, pairs=near,
                                  flops=near * band._PAIR_FLOPS[switch]),
                             r["ms"])
            results["band"] = dict(
                r, **bounds(work, r["ms"], n_sm, max_clock_hz),
                pairs_within_cutoff=near, pairs_window=work["pairs"],
                cutoff_bound_ms=recount["bound_ms"],
                cutoff_pct_of_bound=recount["pct_of_bound"],
                plan=dict(T=plan.T, B=plan.B, threads=plan.threads,
                          smem=plan.smem))
            print(f"  band: {near} of its {work['pairs']} window pairs "
                  f"within 2a with partner mass; bound over those "
                  f"{recount['bound_ms']:.4f} ms "
                  f"({recount['pct_of_bound']:.1f}%)", flush=True)

    # -- rescue selection and pair kernels vs plain, the same scene -------
    results["rescue_select"] = _rescue_select_shape(spos, smass, salive,
                                                    cfg, a)
    results["rescue"] = _rescue_shape(spos, smass, salive, cfg, params, a,
                                      n_sm, max_clock_hz)
    results["boxes"] = _boxes_shape(spos, smass, salive, cfg)
    results["select_unions"] = _unions_shape(spos, smass, salive, cfg)

    # -- interpolation and merge kernels vs plain --------------------------
    results["interp"] = _interp_shape(spos, smass, salive, cfg, params,
                                      origin, side)
    results["deposit"] = _deposit_shape(spos, smass, cfg, origin, side)
    results["fd"] = _fd_shape(spos, smass, cfg, params, origin, side)
    synthetic = _merge_scene(cap, dev)
    merge_synthetic = _merge_compare(
        f"merge synthetic {cap} bodies, chains, {MERGE_HEAVIES} heavies",
        synthetic, params, 64)
    if not (merge_synthetic["heavy_need"] > 64
            and merge_synthetic["victims"] > 0):
        raise AssertionError("merge synthetic: expected an overflowing "
                             "table and absorbed bodies")
    del synthetic

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
        r, **bounds(forces.pair_work(4096, cap, 2), r["ms"], n_sm,
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
    eng_ms = timed_ms(lambda: forces.accel_allpairs(
        st0.pos, live_mass, params.G, params.soft2), reps=5)
    eng_plan = forces._card_plan(cap, cap, 2, dev)
    eng_bound = bounds(forces.pair_work(cap, cap, 2), eng_ms, n_sm,
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
                     need=P3M_PASS + ("allpairs",))

    # -- main path ----------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    sec, n0, n1 = paths.run(
        "pm_main", lambda: _run_steps(eng, 3, [STEPS] * 3, lambda s: s + 1,
                                      P3M_PASS, P3M_MERGES),
        need=P3M_PASS + ("merge",))
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
    results["merge"] = dict(
        _merge_compare(f"merge pm_main state at step {int(hud['step'])}",
                       main_state, params, eng.merge_heavy_cap),
        synthetic=merge_synthetic)
    del eng

    # -- path A: the exact all-pairs engine ---------------------------------
    print(f"path A: solver='allpairs', kdk_reuse, N={N}", flush=True)
    ap = _engine(cfg, params, dev, N, solver="allpairs",
                 integrator="kdk_reuse")
    torch.cuda.reset_peak_memory_stats()
    sec, n0, n1 = paths.run(
        "allpairs_engine", lambda: _run_steps(ap, 2, [2, 3], lambda s: s + 1,
                                              ("allpairs",), P3M_MERGES),
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
                               ("allpairs",), P3M_MERGES),
            need=("allpairs",))
        _report_run(f"allpairs_engine {integrator} N={N_SMALL}", e, sec, n0,
                    n1)

    # -- path B: heavy-direct + F_long subcycling ---------------------------
    print(f"path B: the main path's configuration with {SUBCYCLED}",
          flush=True)
    cfg_b = dataclasses.replace(cfg, **SUBCYCLED)
    sub = _engine(cfg_b, params, dev, N, solver="pm", integrator="kdk_reuse")
    torch.cuda.reset_peak_memory_stats()
    sec, n0, n1 = paths.run(
        "pm_subcycled",
        lambda: _run_steps(sub, 3, [STEPS] * 3, lambda s: s + 1,
                           ("band", "rescue", "rescue_select", "boxes",
                            "interp"), P3M_MERGES),
        need=P3M_PASS + ("merge",))
    _report_run("pm_subcycled", sub, sec, n0, n1)
    print(f"pm_subcycled against pm_main in this run: "
          f"{1e3 * sec:.2f} against {1e3 * main_sec:.2f} ms/step", flush=True)
    paths.run("pm_subcycled_force_error",
              lambda: _force_error("pm_subcycled fresh pass after the run",
                                   sub.state, cfg_b, params, g, ERR_LIMIT),
              need=P3M_PASS + ("allpairs",))
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

    errs = paths.run("pm_knobs", knobs, need=P3M_PASS + ("allpairs",))
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
              lambda: _run_steps(ex, 2, [2, 2], lambda s: s + 1,
                                 ("band", "rescue", "rescue_select",
                                  "boxes", "interp"), P3M_MERGES),
              need=P3M_PASS + ("merge",))
    print("  pm_mesh_extrapolate: two step(2) calls, state finite",
          flush=True)
    del ex

    # the deposit's run_compress modes on the Hilbert-sorted scene, as the
    # engine deposits: the kernel in each mode against the plain deposit
    base, w = mesh._cic_cells_ref(spos, morigin, h, nw, 2, ny=ny)

    def deposit(mode=False, fn=mesh._deposit_packed):
        return fn(smass, base, w, nw, grid, run_compress=mode, ny=ny,
                  grid_y=grid_y)

    plain = deposit(fn=mesh._deposit_packed_ref)
    dep = {}
    for mode in (False, True, 8):
        _rho_check(f"deposit run_compress={mode}", deposit(mode), plain)
        dep[mode] = (timed_ms(lambda: deposit(mode)),
                     timed_ms(lambda: deposit(mode, mesh._deposit_packed_ref)))
    print("  deposit (Hilbert-sorted bodies), kernel against plain: "
          + ", ".join(f"run_compress={m} {k:.3f} ms against {p:.3f} ms"
                      for m, (k, p) in dep.items())
          + f"; every mode within {RHO_RTOL} of each cell", flush=True)
    del plain

    # -- path D: Barnes–Hut -------------------------------------------------
    bh_sec = _path_d(paths, SimConfig(capacity=cap, **CFG, **BH_CFG), params,
                     dev, st0, n_sm, max_clock_hz, results)
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

    # -- path F: the sharded paths on thread ranks of the one card --------
    f = _path_f(paths, cfg, params, dev, n_sm, max_clock_hz, results)
    print(f"ms/step in this run: sharded_pm P={P_RANKS} "
          f"{f['f1']['ms_per_step']:.2f} against pm_main {1e3 * main_sec:.2f}"
          f"; merger10m {f['f2']['updates_per_s']:.1f} body-updates/s",
          flush=True)

    # -- path G: the port's bench, then the cuda tests --------------------
    g_runs = _path_g(paths)
    print("ms/step in this run: bench "
          + ", ".join(f"{k} {v['ms_per_step'][0]:.3f}"
                      for k, v in g_runs.items())
          + f"; bh warm-up {g_runs['bh']['warmup_s']:.2f} s", flush=True)
    _count_device_ops()
    _cuda_tests()

    results["allpairs"]["demo_shape_3d"] = e["demo_shape_3d"]
    results["allpairs"]["engine_shape_3d"].update(
        path_e_ms_per_step=e["ms_per_step"],
        path_e_body_updates_per_s=e["body_updates_per_s"])
    launches = {"band": paths.counts["pm_main"]["band"],
                "rescue": paths.counts["pm_main"]["rescue"],
                "rescue_select": paths.counts["pm_main"]["rescue_select"],
                "select_unions": paths.counts["sharded_pm"]["select_unions"],
                "boxes": paths.counts["pm_main"]["boxes"],
                "allpairs": paths.counts["sphere3d_engine"]["allpairs"],
                "bh_pairs": paths.counts["bh_small_force_error"]["bh_pairs"],
                "bh_hier": paths.counts["bh_engine"]["bh_hier"],
                "bh_lists": paths.counts["bh_engine"]["bh_lists"],
                "bh_tree": paths.counts["bh_engine"]["bh_tree"],
                "merge": paths.counts["pm_main"]["merge"],
                "interp": paths.counts["pm_main"]["interp"],
                "deposit": paths.counts["pm_main"]["deposit"],
                "fd": paths.counts["pm_main"]["fd"]}
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
        dict(name="rescue_pair_sum", route="cuda",
             source="tpu_nbody_torch/csrc/rescue.cu",
             replaces="tpu_nbody/ops/mesh.py:245",
             replaces_also="tpu_nbody/parallel/sharded_pm.py:197",
             replaces_kind="XLA pair sum (no Pallas original)",
             launches=launches["rescue"],
             launches_by_path=paths.of("rescue"), library_ms=None,
             **results["rescue"]),
        dict(name="rescue_select", route="cuda",
             source="tpu_nbody_torch/csrc/rescue_select.cu",
             replaces="tpu_nbody/ops/mesh.py:245",
             replaces_also="tpu_nbody/parallel/sharded_pm.py:197",
             replaces_kind="XLA box-gap test and top_k of the rescue "
                           "(one_chunk, mesh.py:316-330; no Pallas "
                           "original)",
             launches=launches["rescue_select"],
             launches_by_path=paths.of("rescue_select"), library_ms=None,
             **results["rescue_select"]),
        dict(name="select_unions", route="cuda",
             source="tpu_nbody_torch/csrc/rescue_select.cu",
             replaces="tpu_nbody/parallel/sharded_pm.py:197",
             replaces_also="tpu_nbody/ops/mesh.py:245",
             replaces_kind="none of its own: the union table of the "
                           "selection's skip test for callers whose boxes "
                           "do not come from block_boxes.cu (the sharded "
                           "export and import); the XLA selection tests "
                           "every pair (no Pallas original)",
             launches=launches["select_unions"],
             launches_by_path=paths.of("select_unions"), library_ms=None,
             **results["select_unions"]),
        dict(name="block_boxes", route="cuda",
             source="tpu_nbody_torch/csrc/block_boxes.cu",
             replaces="tpu_nbody/ops/mesh.py:286",
             replaces_also="tpu_nbody/parallel/sharded_pm.py:197",
             replaces_kind="XLA block rows and alive-only boxes of the "
                           "rescue (mesh.py:286-300; no Pallas original)",
             launches=launches["boxes"],
             launches_by_path=paths.of("boxes"), library_ms=None,
             **results["boxes"]),
        dict(name="bh_pairs", route="cuda",
             source="tpu_nbody_torch/csrc/bh_pairs.cu",
             replaces="tpu_nbody/ops/traverse.py:589",
             replaces_kind="XLA pair blocks (no Pallas original)",
             launches=launches["bh_pairs"],
             launches_by_path=paths.of("bh_pairs"), library_ms=None,
             **results["bh_pairs"]),
        dict(name="bh_hier", route="cuda",
             source="tpu_nbody_torch/csrc/bh_hier.cu",
             replaces="tpu_nbody/ops/traverse.py:589",
             replaces_kind="XLA pair blocks with the hier traversal's "
                           "masks and partner flatten (no Pallas original)",
             launches=launches["bh_hier"],
             launches_by_path=paths.of("bh_hier"), library_ms=None,
             **results["bh_hier"]),
        dict(name="bh_lists", route="cuda",
             source="tpu_nbody_torch/csrc/bh_lists.cu",
             replaces="tpu_nbody/ops/traverse.py:339",
             replaces_also="tpu_nbody/ops/traverse.py:410",
             replaces_kind="XLA candidate refinement of _hier_lists and "
                           "the leaf and direct needs of _hier_accel (no "
                           "Pallas original)",
             launches=launches["bh_lists"],
             launches_by_path=paths.of("bh_lists"), library_ms=None,
             **results["bh_lists"]),
        dict(name="bh_tree", route="cuda",
             source="tpu_nbody_torch/csrc/bh_tree.cu",
             replaces="tpu_nbody/ops/tree.py:148",
             replaces_kind="XLA tree build: Hilbert codes, boundary scans "
                           "over (L, cap) arrays, slot-wise gathers and "
                           "prefix-sum aggregates (no Pallas original)",
             launches=launches["bh_tree"],
             launches_by_path=paths.of("bh_tree"), **results["bh_tree"]),
        dict(name="merge", route="cuda",
             source="tpu_nbody_torch/csrc/merge.cu",
             replaces="tpu_nbody/ops/merge.py:43",
             replaces_also="tpu_nbody/parallel/sharded.py",
             replaces_kind="XLA top_k, distance test, two absorber rounds "
                           "and segment sum of merge_bodies (no Pallas "
                           "original)",
             launches=launches["merge"],
             launches_by_path=paths.of("merge"), library_ms=None,
             **results["merge"]),
        dict(name="interp", route="cuda",
             source="tpu_nbody_torch/csrc/interp.cu",
             replaces="tpu_nbody/ops/mesh.py:596",
             replaces_also="tpu_nbody/ops/mesh.py:550, :577",
             replaces_kind="XLA packed-table build and row gather of "
                           "_interp_packed, _interp_table and _interp_rows "
                           "(no Pallas original)",
             launches=launches["interp"],
             launches_by_path=paths.of("interp"), **results["interp"]),
        dict(name="deposit", route="cuda",
             source="tpu_nbody_torch/csrc/deposit.cu",
             replaces="tpu_nbody/ops/mesh.py:471",
             replaces_also="tpu_nbody/ops/mesh.py:399; "
                           "tpu_nbody/parallel/sharded_pm.py:352",
             replaces_kind="XLA assignment cells (_cic_cells) and plane "
                           "scatter-adds with the pad-shift combine "
                           "(_deposit_packed) (no Pallas original)",
             launches=launches["deposit"],
             launches_by_path=paths.of("deposit"), **results["deposit"]),
        dict(name="fd_gradient", route="cuda",
             source="tpu_nbody_torch/csrc/fd.cu",
             replaces="tpu_nbody/ops/mesh.py:648",
             replaces_also="tpu_nbody/parallel/sharded_pm.py:124",
             replaces_kind="XLA 6th-order FD stencil of _mesh_grids_one "
                           "and _fd_force_window (no Pallas original)",
             launches=launches["fd"],
             launches_by_path=paths.of("fd"), **results["fd"]),
        dict(name="render_splat", route="cuda",
             source="tpu_nbody_torch/csrc/render.cu",
             replaces="tpu_nbody/ops/render.py:91",
             replaces_kind="XLA scatter of the splat (no Pallas original; "
                           "the port's plain _splat_sum before it)",
             launches=paths.counts["render_movie_pm"]["render"],
             launches_by_path=paths.of("render"), **render_ms["splat_row"]),
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
