"""The port's package boundary: no jax, kernels built lazily, no silent
fallback from a CUDA request, refusals of unported knobs, and the launch
counters. Tests that need a card skip here (marker ``cuda``)."""

import re
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
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 12
    offenders = [str(p) for p in files if pat.search(p.read_text())]
    assert not offenders


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


def test_cpu_calls_do_not_count_launches():
    n0, m0 = tband.LAUNCHES, tforces.LAUNCHES
    pos = torch.rand((100, 2)) * 100
    mass = torch.rand(100)
    tband.band_short_range(pos, mass, 1.0, 3.0, band=32, chunk=64)
    tforces.accel_allpairs(pos, mass, 80.0, 1.0)
    assert (tband.LAUNCHES, tforces.LAUNCHES) == (n0, m0)


@pytest.mark.parametrize("kw", [
    dict(solver="bh"), dict(solver="allpairs"), dict(integrator="kdk"),
    dict(integrator="euler"), dict(strict_parity=True),
    dict(cfg=dict(pm_persistent_sort=False)), dict(cfg=dict(mesh_order=3)),
    dict(cfg=dict(mesh_interlace=True)), dict(cfg=dict(mesh_rescue_hot=12)),
    dict(cfg=dict(pm_mesh_every=4)), dict(cfg=dict(pm_heavy_cap=16)),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_engine_refuses_unported_knobs(kw):
    kw = dict(kw)
    cfg = tconfig.SimConfig(**CFG, **kw.pop("cfg", {}))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tengine.Engine(cfg, **kw)


def test_mesh_functions_refuse_unported_knobs():
    pos = torch.rand((64, 2)) * 100
    mass = torch.ones(64)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tmesh._deposit_packed(mass, torch.zeros(64, dtype=torch.int32),
                              torch.ones((64, 4)), 16, 32, run_compress=True)
    alive = torch.ones(64, dtype=torch.bool)
    common = dict(mesh_level=5, split_cells=2.5, band=32, chunk=64)
    for bad in (dict(order=3), dict(interlace=True), dict(heavy_cap=4),
                dict(rescue_k=2, rescue_k_hot=4)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
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
            tengine.Engine(tconfig.SimConfig(**CFG, mesh_switch="exp"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("switch,band", [("poly4", 128), ("exp4", 128),
                                         ("poly4", 256), ("exp4", 64)])
def test_band_kernel_matches_plain_on_card(cuda_device, switch, band):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    cap = 50_000
    pos = torch.rand((cap, 2), generator=g, device=cuda_device) * 300.0
    codes = tmesh.morton.hilbert_codes(pos, (0.0, 0.0), 300.0)
    pos = pos[torch.argsort(codes, stable=True)].contiguous()
    mass = torch.rand((cap,), generator=g, device=cuda_device) + 0.1
    n0 = tband.LAUNCHES
    got = tband.band_short_range(pos, mass, 1.0, 2.0, band=band,
                                 chunk=16384, switch=switch)
    want = tband.band_short_range_ref(pos, mass, 1.0, 2.0, band=band,
                                      chunk=16384, switch=switch)
    torch.cuda.synchronize()
    assert tband.LAUNCHES == n0 + 1
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
def test_allpairs_kernel_matches_plain_on_card(cuda_device, dim):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    pos = torch.rand((5000, dim), generator=g, device=cuda_device) * 1000
    mass = torch.rand((5000,), generator=g, device=cuda_device)
    got = tforces.accel_allpairs(pos, mass, 80.0, 1.0, targets=pos[:777])
    want = tforces.accel_allpairs_ref(pos, mass, 80.0, 1.0, targets=pos[:777])
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


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
    cpu = tengine.Engine(cfg, seed=4)
    cpu.reset_default_scene(n1=12_000, n2=3_000)
    cpu.add_black_hole(1203.0, 400.0)
    card = tengine.Engine(cfg, seed=4, device=cuda_device)
    card.state = convert.state_from_numpy(*[x.numpy() for x in cpu.state],
                                          device=cuda_device)
    n0 = tband.LAUNCHES
    cpu.step(10)
    card.step(10)
    torch.cuda.synchronize()
    assert tband.LAUNCHES == n0 + 11
    assert torch.equal(card.state.alive.cpu(), cpu.state.alive)
    alive = cpu.state.alive
    dpos = (card.state.pos.cpu() - cpu.state.pos)[alive].abs().max()
    assert float(dpos) <= 1e-2
    assert (card.last_rescue_need, card.last_heavy_need) == \
        (cpu.last_rescue_need, cpu.last_heavy_need)
