"""The port's package boundary: no jax, kernels built lazily, no silent
fallback from a CUDA request, refusals of unported knobs, and the launch
counters. Tests that need a card skip here (marker ``cuda``); they also
hold the all-pairs engine and the P3M knobs on the card against the same
calls on the CPU."""

import collections
import concurrent.futures
import re
import sys
from pathlib import Path

import pytest
import torch

import tpu_nbody_torch
from tpu_nbody_torch import config as tconfig
from tpu_nbody_torch import engine as tengine
from tpu_nbody_torch.kernels import _build
from tpu_nbody_torch.ops import band as tband
from tpu_nbody_torch.ops import forces as tforces
from tpu_nbody_torch.ops import mesh as tmesh

torch.set_num_threads(2)

PKG = Path(tpu_nbody_torch.__file__).resolve().parent
CFG = dict(capacity=1024, mesh_level=9, mesh_band=32, mesh_chunk=1024)


def test_no_file_imports_jax():
    """No file of the port imports jax, the JAX package or the JAX bench
    (``bench.py`` at the repo root); the bench module is one of them."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|tpu_nbody|bench)\b", re.M)
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 12 and PKG / "bench.py" in files
    offenders = [str(p) for p in files if pat.search(p.read_text())]
    assert not offenders
    assert pat.search("import jax.numpy as jnp\n")
    assert pat.search("    from tpu_nbody.ops import mesh\n")
    assert pat.search("from bench import main\n")
    assert not pat.search("from tpu_nbody_torch import bench\n")


def test_kernel_sources_present():
    names = {p.name for p in _build.sources()}
    assert {"band.cu", "allpairs.cu"} <= names
    for name in ("band.cu", "allpairs.cu"):
        text = (PKG / "csrc" / name).read_text()
        assert "Replaces the Pallas TPU kernel tpu_nbody/ops/" in text
        assert 'extern "C"' in text and "cudaGetLastError" in text


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tengine.Engine(tconfig.SimConfig(**CFG), device="cuda")


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """A tensor off the CPU never takes the plain version: a device the
    kernels do not run on raises instead of computing something."""
    pos = torch.zeros((64, 2), device="meta")
    mass = torch.zeros((64,), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tband.band_short_range(pos, mass, 1.0, 2.0, band=32, chunk=64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tforces.accel_allpairs(pos, mass, 80.0, 1.0)


def test_check_launch_keeps_the_one_launch_table(monkeypatch):
    """``_build.check_launch`` counts a launch under the kernel's name once
    its launcher returned 0, and raises without counting on an error;
    ``launches`` sums names; every launch site of the package passes one
    of the fifteen names of ``_build.KERNELS`` (a grep of the sources)."""
    monkeypatch.setattr(_build, "LAUNCHES", collections.Counter())

    class Lib:
        def tnt_error_string(self, rc):
            return b"invalid configuration argument"

    monkeypatch.setattr(_build, "library", Lib)
    _build.check_launch("band", 0)
    _build.check_launch("band", 0)
    _build.check_launch("fd", 0)
    with pytest.raises(RuntimeError, match=r"^interp: CUDA launch failed "
                                           r"\(9\): invalid configuration"):
        _build.check_launch("interp", 9)
    _build.count("allpairs_pairs", 12)
    assert _build.LAUNCHES == {"band": 2, "fd": 1, "allpairs_pairs": 12}
    assert _build.launches("band", "fd", "interp") == 3
    assert _build.launches() == 0
    assert len(set(_build.KERNELS)) == 15
    calls, names = 0, []
    for path in sorted(PKG.rglob("*.py")):
        text = path.read_text()
        calls += len(re.findall(r"(?<!def )check_launch\(", text))
        names += re.findall(r"(?<!def )check_launch\(\"(\w+)\", rc\)",
                            text)
    assert calls == len(names) == 18
    assert set(names) == set(_build.KERNELS)


def test_the_launch_table_loses_no_count_across_threads(monkeypatch):
    """Sharded ranks are threads of one process that launch at once: their
    counts all land in the table."""
    monkeypatch.setattr(_build, "LAUNCHES", collections.Counter())
    threads, each = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(threads) as pool:
            done = [pool.submit(lambda: [_build.check_launch("merge", 0)
                                         for _ in range(each)])
                    for _ in range(threads)]
            for f in done:
                f.result(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert _build.launches("merge") == threads * each


def test_cpu_calls_do_not_count_launches():
    n0, m0 = _build.LAUNCHES["band"], _build.LAUNCHES["allpairs"]
    pos = torch.rand((100, 2)) * 100
    mass = torch.rand(100)
    tband.band_short_range(pos, mass, 1.0, 3.0, band=32, chunk=64)
    tforces.accel_allpairs(pos, mass, 80.0, 1.0)
    assert (_build.LAUNCHES["band"], _build.LAUNCHES["allpairs"]) == (n0, m0)


@pytest.mark.parametrize("kw", [
    dict(solver="bh"), dict(solver="allpairs"), dict(integrator="kdk"),
    dict(integrator="euler"), dict(strict_parity=True),
    dict(cfg=dict(pm_persistent_sort=False)), dict(cfg=dict(mesh_order=3)),
    dict(cfg=dict(mesh_interlace=True)), dict(cfg=dict(mesh_rescue_hot=12)),
    dict(cfg=dict(pm_mesh_every=4)), dict(cfg=dict(pm_heavy_cap=16)),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_engine_refuses_unported_knobs(kw):
    """Of the knobs refused before the 2D engine was ported (each named
    beside the P3M main path's solver and integrator), strict_parity
    outside bh and subcycling without a heavy cap are refused as invalid
    (ValueError), and every other one, Barnes-Hut included, builds and
    runs a step."""
    kw = dict(dict(solver="pm", integrator="kdk_reuse"), **kw)
    cfg = tconfig.SimConfig(**CFG, **kw.pop("cfg", {}))
    if kw.get("strict_parity") or cfg.pm_mesh_every > 1:
        with pytest.raises(ValueError):
            tengine.Engine(cfg, device="cpu", **kw)
    else:
        eng = tengine.Engine(cfg, device="cpu", **kw)
        eng.reset_default_scene(n1=300, n2=100)
        eng.step(1)
        assert torch.isfinite(eng.state.pos).all()


def test_mesh_functions_refuse_unported_knobs():
    """Mesh knobs the JAX package does not define either raise: an
    assignment order other than 1-3, and a run-compression window that
    does not divide the bodies."""
    pos = torch.rand((64, 2)) * 100
    mass = torch.ones(64)
    with pytest.raises(ValueError, match="divide"):
        tmesh._deposit_packed(mass, torch.zeros(64, dtype=torch.int32),
                              torch.ones((64, 4)), 16, 32, run_compress=24)
    alive = torch.ones(64, dtype=torch.bool)
    common = dict(mesh_level=5, split_cells=2.5, band=32, chunk=64)
    for bad in (dict(order=4), dict(order=0)):
        with pytest.raises(ValueError, match="order"):
            tmesh.pm_accel(pos, mass, alive, 80.0, 1.0, (0.0, 0.0), 128.0,
                           **common, **bad)


@pytest.mark.parametrize("where", ["short_weight", "pm_accel", "engine"])
def test_unknown_switch_raises(where):
    if where == "short_weight":
        with pytest.raises(ValueError, match="switch"):
            tmesh._short_weight(torch.ones(4), 1.0, "gauss")
    elif where == "pm_accel":
        pos = torch.rand((64, 2)) * 100
        with pytest.raises(ValueError, match="switch"):
            tmesh.pm_accel(pos, torch.ones(64), torch.ones(64, dtype=bool),
                           80.0, 1.0, (0.0, 0.0), 128.0, mesh_level=5,
                           split_cells=2.5, band=32, chunk=64,
                           switch="Poly4")
    else:
        with pytest.raises(ValueError, match="switch"):
            tengine.Engine(tconfig.SimConfig(**CFG, mesh_switch="exp"),
                           solver="pm", device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _sorted_bodies(dev, cap):
    """``cap`` random bodies in a 300 px square, in Hilbert order."""
    g = torch.Generator(device=dev).manual_seed(0)
    pos = torch.rand((cap, 2), generator=g, device=dev) * 300.0
    codes = tmesh.morton.hilbert_codes(pos, (0.0, 0.0), 300.0)
    pos = pos[torch.argsort(codes, stable=True)].contiguous()
    return pos, torch.rand((cap,), generator=g, device=dev) + 0.1


def _assert_close_to(got, want):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("switch,band,cap", [
    ("poly4", 128, 50_000), ("exp4", 128, 50_000), ("poly4", 256, 50_000),
    ("exp4", 64, 50_000), ("poly4", 1, 5000), ("poly4", 3, 1000),
    ("poly4", 1024, 50_000), ("exp4", 1024, 3000), ("poly4", 128, 100),
    ("poly4", 100, 12_345), ("poly4", 128, 512 * 40 + 1)])
def test_band_kernel_matches_plain_on_card(cuda_device, switch, band, cap):
    """Band widths 1 to 1024, capacities below one S-block and not a
    multiple of the B S bodies a CTA covers."""
    pos, mass = _sorted_bodies(cuda_device, cap)
    n0 = _build.LAUNCHES["band"]
    got = tband.band_short_range(pos, mass, 1.0, 2.0, band=band,
                                 chunk=16384, switch=switch)
    want = tband.band_short_range_ref(pos, mass, 1.0, 2.0, band=band,
                                      chunk=16384, switch=switch)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["band"] == n0 + 1
    _assert_close_to(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", [(1, 2), (2, None), (8, None), (4, 1),
                                 (4, 8)])
def test_band_kernel_plans_on_card(cuda_device, T, B):
    """Every launch shape the plan can give computes the same pass."""
    cap = 20_000 + 77
    pos, mass = _sorted_bodies(cuda_device, cap)
    plan = tband._band_plan(cap, 128, T=T, B=B)
    got = tband._launch(pos, mass, 1.0, 2.0, 128, "poly4", plan)
    want = tband.band_short_range_ref(pos, mass, 1.0, 2.0, band=128,
                                      chunk=16384, switch="poly4")
    torch.cuda.synchronize()
    _assert_close_to(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,nt,ns", [
    (2, 777, 5000), (3, 777, 5000), (2, 513, 100), (3, 513, 100),
    (2, 1, 70_001), (3, 3000, 70_001), (2, 4096, 1 << 18)])
def test_allpairs_kernel_matches_plain_on_card(cuda_device, dim, nt, ns):
    """Sources fewer than one tile, targets not a multiple of the T x 128
    of a block, 2D and 3D; a second call gives the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    pos = torch.rand((ns, dim), generator=g, device=cuda_device) * 1000
    mass = torch.rand((ns,), generator=g, device=cuda_device)
    tgt = torch.rand((nt, dim), generator=g, device=cuda_device) * 1000
    tgt[: min(nt, ns)] = pos[: min(nt, ns)]           # self pairs too
    got = tforces.accel_allpairs(pos, mass, 80.0, 1.0, targets=tgt)
    again = tforces.accel_allpairs(pos, mass, 80.0, 1.0, targets=tgt)
    want = tforces.accel_allpairs_ref(pos, mass, 80.0, 1.0, targets=tgt)
    torch.cuda.synchronize()
    _assert_close_to(got, want)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("per_sm", [1, 16])
def test_allpairs_kernel_plans_on_card(cuda_device, per_sm):
    """66 source splits and one split a tile (118) give the same sums."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    pos = torch.rand((30_000, 2), generator=g, device=cuda_device) * 1000
    mass = torch.rand((30_000,), generator=g, device=cuda_device)
    tgt = pos[:1500]
    plan = tforces._split_plan(1500, 30_000, 132, per_sm)
    got = 80.0 * tforces._launch(pos, mass, 1.0, tgt, plan)
    want = tforces.accel_allpairs_ref(pos, mass, 80.0, 1.0, targets=tgt)
    torch.cuda.synchronize()
    _assert_close_to(got, want)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(cuda_device):
    """The main path on the card (band kernel, cuFFT, atomic deposit)
    against the same port on the CPU (plain versions), same bodies, 10
    steps: alive masks and stats equal, positions within 1e-2 px (deposit
    atomics and re-sorts of slightly different positions drift a little)."""
    from tpu_nbody_torch import convert
    cfg = tconfig.SimConfig(capacity=16384, mesh_level=10, mesh_band=64,
                            mesh_rescue=4, mesh_switch="poly4",
                            pm_resort_every=4, mesh_chunk=4096)
    main = dict(solver="pm", integrator="kdk_reuse")
    cpu = tengine.Engine(cfg, seed=4, device="cpu", **main)
    cpu.reset_default_scene(n1=12_000, n2=3_000)
    cpu.add_black_hole(1203.0, 400.0)
    card = tengine.Engine(cfg, seed=4, device=cuda_device, **main)
    card.state = convert.state_from_numpy(*[x.numpy() for x in cpu.state],
                                          device=cuda_device)
    n0 = _build.LAUNCHES["band"]
    cpu.step(10)
    card.step(10)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["band"] == n0 + 11
    assert torch.equal(card.state.alive.cpu(), cpu.state.alive)
    alive = cpu.state.alive
    dpos = (card.state.pos.cpu() - cpu.state.pos)[alive].abs().max()
    assert float(dpos) <= 1e-2
    assert (card.last_rescue_need, card.last_heavy_need) == \
        (cpu.last_rescue_need, cpu.last_heavy_need)


@pytest.mark.cuda
@pytest.mark.parametrize("integrator,launches", [("kdk_reuse", 3),
                                                 ("kdk", 4), ("euler", 2)])
def test_allpairs_engine_on_card_matches_cpu(cuda_device, integrator,
                                             launches):
    """solver="allpairs" at N=8192 on the card (every force pass through
    the all-pairs kernel, launches counted) against the plain version on
    the CPU, one step(2): alive masks equal, positions within 1e-2 px."""
    from tpu_nbody_torch import convert
    cfg = tconfig.SimConfig(capacity=8192)
    cpu = tengine.Engine(cfg, solver="allpairs", integrator=integrator,
                         seed=5, device="cpu")
    cpu.reset_default_scene(n1=6000, n2=2000)
    card = tengine.Engine(cfg, solver="allpairs", integrator=integrator,
                          seed=5, device=cuda_device)
    card.state = convert.state_from_numpy(*[x.numpy() for x in cpu.state],
                                          device=cuda_device)
    n0 = _build.LAUNCHES["allpairs"]
    card.step(2)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["allpairs"] == n0 + launches
    cpu.step(2)
    assert torch.equal(card.state.alive.cpu(), cpu.state.alive)
    alive = cpu.state.alive
    dpos = (card.state.pos.cpu() - cpu.state.pos)[alive].abs().max()
    assert float(dpos) <= 1e-2
    assert card.last_heavy_need == cpu.last_heavy_need


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [dict(heavy_cap=16), dict(order=3),
                                   dict(order=3, heavy_cap=16,
                                        interlace=True, rescue_k_hot=16)])
def test_pm_accel_knobs_on_card_match_cpu(cuda_device, knobs):
    """pm_accel with heavy-direct, TSC and the other knobs on the card
    (band kernel, cuFFT, atomic deposit) against the same call on CPU
    tensors: stats equal, 1e-4 of the largest magnitude (FFT libraries
    and the deposit's atomics sum in other orders)."""
    from tpu_nbody_torch.models import scenes
    g = torch.Generator().manual_seed(6)
    p, _, m = scenes.default_two_disk_scene(g, n1=40_000, n2=10_000)
    alive = torch.ones(50_000, dtype=torch.bool)
    kw = dict(mesh_level=10, split_cells=2.5, band=128, chunk=16384,
              rescue_k=4, mesh_ny=512, return_stats=True, switch="poly4",
              **knobs)
    args = (80.0, 1.0, (-2.0, -802.0), 2404.0)
    want, st_cpu = tmesh.pm_accel(p, m, alive, *args, **kw)
    n0 = _build.LAUNCHES["band"]
    got, st = tmesh.pm_accel(p.to(cuda_device), m.to(cuda_device),
                             alive.to(cuda_device), *args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["band"] == n0 + 1
    assert {k: int(v) for k, v in st.items()} == \
        {k: int(v) for k, v in st_cpu.items()}
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-4 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("traversal", ["dense", "bfs", "hier"])
def test_bh_pass_on_card_matches_cpu(cuda_device, traversal):
    """One Barnes-Hut pass on the card against the same pass on the CPU:
    every need equal, forces within 2e-5 of the largest magnitude."""
    from tpu_nbody_torch.models import scenes
    cfg = tconfig.SimConfig(capacity=16384, group_size=256, group_cap=256,
                            leaf_list_cap=2048, direct_body_cap=16384,
                            bh_traversal=traversal, bh_hier_sizes=(64, 8))
    caps = tengine.Caps.from_config(cfg)
    params = tconfig.Params.default(theta=0.5)
    g = torch.Generator().manual_seed(7)
    p, _, m = scenes.default_two_disk_scene(g, n1=12_000, n2=3_000)
    pos = torch.zeros((16384, 2))
    mass = torch.zeros(16384)
    pos[:15_000], mass[:15_000] = p, m
    alive = torch.arange(16384) < 15_000
    want, st_cpu = tengine.make_bh_accel(cfg, caps)(pos, mass, alive, params)
    n0 = (_build.LAUNCHES["band"], _build.LAUNCHES["allpairs"])
    got, st = tengine.make_bh_accel(cfg, caps)(
        pos.to(cuda_device), mass.to(cuda_device), alive.to(cuda_device),
        params)
    torch.cuda.synchronize()
    assert (_build.LAUNCHES["band"], _build.LAUNCHES["allpairs"]) == n0
    assert st.flat().tolist() == st_cpu.flat().tolist()
    assert not st.on_host(st.flat().tolist()).overflowed(caps.as_dict())
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=2e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("integrator,launches", [("kdk_reuse", 3),
                                                 ("kdk", 4), ("euler", 2)])
def test_engine3d_on_card_matches_cpu(cuda_device, integrator, launches):
    """The 3D all-pairs engine on the sphere scene (8191 satellites and the
    centre) on the card, every force pass through the kernel's 3D
    instantiation, against the plain version on the CPU, one step(2):
    positions within 1e-2 px, the 3-vector stats within 1e-4 of scale."""
    from tpu_nbody_torch.models import scenes3d
    cfg = tconfig.SimConfig(capacity=8192, dim=3)
    params = tconfig.Params.default(merge_min_dist=0.0)
    bodies = scenes3d.generate_sphere(torch.Generator().manual_seed(8), 8191)
    kw = dict(solver="allpairs", integrator=integrator)
    cpu = tengine.Engine(cfg, params, device="cpu", **kw)
    cpu.set_bodies(*bodies)
    card = tengine.Engine(cfg, params, device=cuda_device, **kw)
    card.set_bodies(*bodies)
    n0 = (_build.LAUNCHES["band"], _build.LAUNCHES["allpairs"])
    card.step(2)
    torch.cuda.synchronize()
    assert (_build.LAUNCHES["band"], _build.LAUNCHES["allpairs"]) == (
        n0[0], n0[1] + launches)
    cpu.step(2)
    assert card.state.pos.shape == (8192, 3) and card.state.pos.is_cuda
    assert int(card.state.n_alive()) == 8192
    dpos = (card.state.pos.cpu() - cpu.state.pos).abs().max()
    assert float(dpos) <= 1e-2
    got, want = card.stats(potential=True), cpu.stats(potential=True)
    for k in ("com", "kinetic", "potential", "energy", "total_mass"):
        assert abs(got[k] - want[k]).max() <= 1e-4 * abs(want[k]).max(), k


@pytest.mark.cuda
@pytest.mark.parametrize("mode,sprites", [("speed", 0.0), ("classic", 0.0),
                                          ("speed", 1e-3)])
def test_render_on_card_matches_cpu(cuda_device, mode, sprites):
    """The splat on the card (csrc/render.cu's atomic adds) against the
    CPU's plain splat on the same bodies, off-screen, negative and
    non-finite coordinates included: the sums before the clip within 1e-4
    of the brightest pixel, two renders on the card likewise, the uint8
    frames within 1 level."""
    from tpu_nbody_torch.ops import render
    g = torch.Generator().manual_seed(9)
    n = 200_000
    pos = torch.rand((n, 2), generator=g) * 700.0 - 50.0
    pos[:3] = torch.tensor([[float("nan"), 5.0], [float("inf"), 5.0],
                            [3e38, -3e38]])
    vel = torch.randn((n, 2), generator=g) * 300.0
    mass = torch.rand((n,), generator=g) * 6000.0
    alive = torch.rand((n,), generator=g) > 0.2
    kw = dict(width=600, height=200, view_x=0.0, view_y=0.0, zoom=1.0,
              mode=mode, speed_scale=1 / 300.0, gain=1.0, size_base=1.0,
              size_mass_scale=sprites)
    want = render._splat_sum(pos, vel, mass, alive, **kw)
    on_card = [t.to(cuda_device) for t in (pos, vel, mass, alive)]
    got = render._splat_launch(*on_card, **kw)
    again = render._splat_launch(*on_card, **kw)
    torch.cuda.synchronize()
    assert got.is_cuda and float(want.max()) > 1.0
    tol = 1e-4 * float(want.max())
    assert float((got.cpu() - want).abs().max()) <= tol
    assert float((got - again).abs().max()) <= tol
    u8 = render.to_uint8(got).cpu().int() - render.to_uint8(want).int()
    assert int(u8.abs().max()) <= 1


@pytest.mark.cuda
def test_trace_on_card_records_the_kernel(cuda_device, tmp_path):
    """profiling.trace around one all-pairs call: the Chrome trace is
    written and the profiler attributes device time to the hand-written
    kernel, though it is launched through ctypes and not by torch."""
    from tpu_nbody_torch import profiling
    g = torch.Generator(device=cuda_device).manual_seed(10)
    pos = torch.rand((20_000, 3), generator=g, device=cuda_device) * 1000
    mass = torch.rand((20_000,), generator=g, device=cuda_device)
    tforces.accel_allpairs(pos, mass, 80.0, 1.0)       # build and warm up
    with profiling.trace(str(tmp_path)) as prof:
        profiling.sync(tforces.accel_allpairs(pos, mass, 80.0, 1.0))
    assert (tmp_path / "trace.json").stat().st_size > 0
    timed = {e.key: getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0))
             for e in prof.key_averages()}
    kernels = {k: v for k, v in timed.items() if "allpairs_partial" in k}
    print({k: v for k, v in timed.items() if v > 0})
    assert kernels and all(v > 0 for v in kernels.values())


@pytest.mark.cuda
@pytest.mark.parametrize("P", [2, 4])
def test_ring_tile_sums_on_card_match_plain(cuda_device, P):
    """The sharded ring on P thread ranks of the card: P² all-pairs
    launches a pass, and the accelerations within 1e-5 of max |a| of the
    plain tile sums (_accel_vs_tile) over every tile."""
    from tpu_nbody_torch.parallel import sharded
    from tpu_nbody_torch.parallel.collectives import ThreadGroup, run_spmd
    g = torch.Generator(device=cuda_device).manual_seed(4)
    n = 3000 * P
    pos = torch.rand((n, 2), generator=g, device=cuda_device) * 1000
    mass = torch.rand((n,), generator=g, device=cuda_device)
    grp = ThreadGroup(P, cuda_device)
    n0 = _build.LAUNCHES["allpairs"]
    got = torch.cat(run_spmd(
        grp, lambda p, m: sharded.ring_allpairs_accel(p, m, 80.0, 1.0,
                                                      group=grp),
        list(pos.chunk(P)), list(mass.chunk(P))))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["allpairs"] - n0 == P * P
    want = torch.cat([
        80.0 * sum(sharded._accel_vs_tile(p, t, tm, 1.0)
                   for t, tm in zip(pos.chunk(P), mass.chunk(P)))
        for p in pos.chunk(P)])
    _assert_close_to(got, want)


@pytest.mark.cuda
def test_let_import_sum_on_card_matches_plain(cuda_device):
    """The sharded BH import sum through the all-pairs kernel, on (P·E, 3)
    imported rows whose pos and mass columns are strided slices, against
    _import_accel."""
    from tpu_nbody_torch.parallel import sharded_bh
    g = torch.Generator(device=cuda_device).manual_seed(5)
    imports = torch.rand((4, 4096, 3), generator=g, device=cuda_device)
    imports[..., :2] *= 1000.0
    imports[1, 3000:, 2] = 0.0                          # unused rows
    pos = torch.rand((5000, 2), generator=g, device=cuda_device) * 1000
    n0 = _build.LAUNCHES["allpairs"]
    got = sharded_bh._import_sum(pos, imports, 80.0, 1.0)
    want = 80.0 * sharded_bh._import_accel(pos, imports, 1.0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["allpairs"] - n0 == 1
    _assert_close_to(got, want)


@pytest.mark.cuda
def test_sharded_pm_pass_on_card_matches_cpu(cuda_device):
    """One sharded P3M force pass of 4 thread ranks on the card (band
    kernel on each rank's rows plus halos, cuFFT slabs) against the same
    pass on the CPU: 4 band launches, accelerations within 1e-4 of max |a|
    (deposit atomics reorder the sums), needs equal."""
    from tpu_nbody_torch.parallel import mesh as pmesh
    from tpu_nbody_torch.parallel import sharded_pm
    from tpu_nbody_torch.parallel.collectives import run_spmd
    cfg = tconfig.SimConfig(capacity=1 << 15, mesh_level=10, mesh_band=128,
                            mesh_rescue=4, mesh_switch="poly4")
    out = {}
    for dev in ("cpu", cuda_device):
        eng = tengine.Engine(cfg, seed=4, device="cpu", solver="pm")
        eng.reset_default_scene(n1=24_000, n2=6_000)
        grp = pmesh.make_mesh(4, device=dev)
        local = sharded_pm.reshard_by_hilbert(eng.state, grp, cfg)
        origin, side = tengine._root(cfg)
        n0 = _build.LAUNCHES["band"]
        res = run_spmd(grp, lambda s: sharded_pm._pm_accel_local_sorted(
            s.pos, s.mass, s.alive, 80.0, 1.0, origin, side,
            mesh_level=10, split_cells=cfg.mesh_split, band=128,
            chunk=8192, rescue_k=4, group=grp, xrescue_k=4,
            xrescue_export=64, switch="poly4"), local)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert _build.LAUNCHES["band"] - n0 == 4
        out[str(dev)] = (torch.cat([r[0] for r in res]).cpu(),
                         [[int(x) for x in r[1]] for r in res])
    (a_cpu, n_cpu), (a_card, n_card) = out["cpu"], out[str(cuda_device)]
    assert n_card == n_cpu
    torch.testing.assert_close(a_card, a_cpu, rtol=0,
                               atol=1e-4 * a_cpu.abs().max().item())
