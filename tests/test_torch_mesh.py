"""Port parity: the P3M pieces of tpu_nbody_torch.ops.mesh and
tpu_nbody_torch.ops.band against tpu_nbody.ops.mesh on the same inputs.

Tolerances are stated per test. FFT pieces compare within 1e-4 of the
largest magnitude: the two FFT libraries (pocketfft under XLA, pocketfft or
MKL under torch) sum in different orders. Integer outputs (cell indices,
rescue needs, out-of-window counts) must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nbody.models import scenes as jscenes
from tpu_nbody.ops import mesh as jmesh
from tpu_nbody_torch.kernels import _build
from tpu_nbody_torch.ops import band as tband
from tpu_nbody_torch.ops import mesh as tmesh

torch.set_num_threads(2)

ORIGIN = (-2.0, -802.0)
SIDE = 2404.0
G, SOFT2 = 80.0, 1.0


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, frac=1e-4):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * np.abs(want).max())


@pytest.fixture(scope="module")
def galaxy():
    """The test_mesh.py galaxy shapes: 2000 bodies in 2048 slots, plus a
    few bodies far above the window to exercise mesh_oob, Hilbert-sorted
    by the JAX package."""
    n, cap = 2000, 2048
    p, _, m = jscenes.make_galaxy_disk(jax.random.PRNGKey(42), n, r=300.0)
    pos = np.zeros((cap, 2), np.float32)
    mass = np.zeros(cap, np.float32)
    pos[:n], mass[:n] = np.asarray(p), np.asarray(m)
    pos[n:n + 8] = [[300.0 + 200 * i, 1500.0] for i in range(8)]
    mass[n:n + 8] = 1.0
    alive = np.arange(cap) < n + 8
    spos, smass, salive, _ = jmesh._hilbert_sort(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(alive), ORIGIN,
        SIDE)
    return dict(pos=pos, mass=mass, alive=alive, spos=np.asarray(spos),
                smass=np.asarray(smass), salive=np.asarray(salive))


@pytest.mark.parametrize("mesh_ny", [0, 128])
@pytest.mark.parametrize("switch", ["exp4", "poly4"])
def test_kernel_hats_for(mesh_ny, switch):
    kw = dict(mesh_level=8, split_cells=2.5, mesh_ny=mesh_ny, switch=switch)
    want = jmesh.kernel_hats_for(SIDE, SOFT2, **kw)
    got = tmesh.kernel_hats_for(SIDE, SOFT2, **kw, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.complex64
        _close(g, w)


def test_cic_cells(galaxy):
    nw, ny = 512, 256
    h = SIDE / nw
    morigin = (ORIGIN[0], ORIGIN[1] + 0.5 * SIDE - 0.5 * ny * h)
    base_j, w_j = jmesh._cic_cells(jnp.asarray(galaxy["spos"]),
                                   jnp.asarray(morigin, jnp.float32),
                                   jnp.float32(h), nw, 2, ny=ny)
    base_t, w_t = tmesh._cic_cells(_t(galaxy["spos"]), morigin, h, nw, 2,
                                   ny=ny)
    np.testing.assert_array_equal(base_t.numpy(), np.asarray(base_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-6)


def _grid_inputs(galaxy, mesh_level=9, mesh_ny=256):
    nw, ny, grid, grid_y, h, a, morigin = tmesh._pm_geometry(
        ORIGIN, SIDE, mesh_level, mesh_ny, 2.5)
    base, w = jmesh._cic_cells(jnp.asarray(galaxy["spos"]),
                               jnp.asarray(morigin, jnp.float32),
                               jnp.float32(h), nw, 2, ny=ny)
    kernel = jmesh.kernel_hats_for(SIDE, SOFT2, mesh_level=mesh_level,
                                   split_cells=2.5, mesh_ny=mesh_ny)
    return dict(nw=nw, ny=ny, grid=grid, grid_y=grid_y, h=h, a=a,
                morigin=morigin, base=np.asarray(base), w=np.asarray(w),
                kernel=kernel)


def test_pm_geometry_matches_jax():
    for level, ny in [(9, 0), (12, 2048), (10, 300)]:
        want = jmesh._pm_geometry(ORIGIN, SIDE, level, ny, 2.5, jnp.float32)
        got = tmesh._pm_geometry(ORIGIN, SIDE, level, ny, 2.5)
        assert got[:4] == tuple(int(x) for x in want[:4])
        assert got[4] == float(want[4]) and got[5] == float(want[5])
        assert got[6] == tuple(float(x) for x in np.asarray(want[6]))


def test_deposit_packed(galaxy):
    g = _grid_inputs(galaxy)
    args = (g["nw"], g["grid"])
    want = jmesh._deposit_packed(jnp.asarray(galaxy["smass"]),
                                 jnp.asarray(g["base"]), jnp.asarray(g["w"]),
                                 *args, ny=g["ny"], grid_y=g["grid_y"])
    got = tmesh._deposit_packed(_t(galaxy["smass"]), _t(g["base"]),
                                _t(g["w"]), *args, ny=g["ny"],
                                grid_y=g["grid_y"])
    assert got.shape == want.shape
    _close(got, want, 1e-6)   # plain sums of the same products


def test_conv_potential_and_fd_grids(galaxy):
    g = _grid_inputs(galaxy)
    rho = jmesh._deposit_packed(jnp.asarray(galaxy["smass"]),
                                jnp.asarray(g["base"]), jnp.asarray(g["w"]),
                                g["nw"], g["grid"], ny=g["ny"],
                                grid_y=g["grid_y"])
    phi_hat = g["kernel"][2]
    want = jmesh._conv_potential(rho, phi_hat, g["ny"], g["grid"],
                                 g["grid_y"])
    got = tmesh._conv_potential(_t(rho), _t(phi_hat), g["ny"], g["grid"],
                                g["grid_y"])
    assert got.shape == want.shape
    _close(got, want)

    kernel_t = tuple(_t(k) for k in g["kernel"])
    fx_j, fy_j = jmesh._mesh_grids_one(
        jnp.asarray(galaxy["spos"]), jnp.asarray(galaxy["smass"]),
        jnp.asarray(g["morigin"], jnp.float32), jnp.float32(g["h"]), g["nw"],
        g["grid"], 2, g["kernel"], ny=g["ny"])
    fx_t, fy_t = tmesh._mesh_grids_one(
        _t(galaxy["spos"]), _t(galaxy["smass"]), g["morigin"], g["h"],
        g["nw"], g["grid"], 2, kernel_t, ny=g["ny"])
    assert fx_t.shape == fx_j.shape == (g["ny"] + 1, g["nw"] + 1)
    _close(fx_t, fx_j)
    _close(fy_t, fy_j)


def test_interp_packed(galaxy):
    g = _grid_inputs(galaxy)
    fx, fy = jmesh._mesh_grids_one(
        jnp.asarray(galaxy["spos"]), jnp.asarray(galaxy["smass"]),
        jnp.asarray(g["morigin"], jnp.float32), jnp.float32(g["h"]), g["nw"],
        g["grid"], 2, g["kernel"], ny=g["ny"])
    want = jmesh._interp_packed(fx, fy, jnp.asarray(g["base"]),
                                jnp.asarray(g["w"]), g["nw"], ny=g["ny"])
    got = tmesh._interp_packed(_t(fx), _t(fy), _t(g["base"]), _t(g["w"]),
                               g["nw"], ny=g["ny"])
    _close(got, want, 1e-6)   # same table rows, same weights


@pytest.mark.parametrize("switch", ["exp4", "poly4"])
@pytest.mark.parametrize("band", [32, 128])
def test_band_ref_matches_xla_band(galaxy, switch, band):
    """Capacity 2000 is not a multiple of either band: the ragged tail
    block is exercised. Same pair math in the same block order; 1e-5 of
    the largest magnitude covers the libraries' rsqrt/exp rounding."""
    cap = 2000
    spos, smass = galaxy["spos"][:cap], galaxy["smass"][:cap]
    a = 2.5 * SIDE / 1024
    want = jmesh._band_short_range(jnp.asarray(spos), jnp.asarray(smass),
                                   jnp.float32(SOFT2), jnp.float32(a),
                                   band=band, chunk=512, switch=switch)
    got = tband.band_short_range_ref(_t(spos), _t(smass), SOFT2, a,
                                     band=band, chunk=512, switch=switch)
    _close(got, want, 1e-5)
    # the dispatching wrapper takes the plain version on CPU tensors
    launches = _build.LAUNCHES["band"]
    again = tband.band_short_range(_t(spos), _t(smass), SOFT2, a, band=band,
                                   chunk=512, switch=switch)
    assert torch.equal(again, got) and _build.LAUNCHES["band"] == launches


def test_band_ref_matches_pallas_interpret(galaxy, monkeypatch):
    """exp4 at S=128 is exactly what the TPU kernel computes; run it in
    interpret mode as tests/test_forces.py does. Tolerance 1e-5 of the
    largest magnitude."""
    from jax.experimental import pallas as pl

    from tpu_nbody.ops import band_pallas

    real_call = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return real_call(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    spos, smass = galaxy["spos"], galaxy["smass"]
    a = 2.5 * SIDE / 4096
    want = band_pallas.band_short_range_pallas(
        jnp.asarray(spos), jnp.asarray(smass), jnp.float32(SOFT2),
        jnp.float32(a))
    got = tband.band_short_range_ref(_t(spos), _t(smass), SOFT2, a, band=128,
                                     chunk=2048, switch="exp4")
    _close(got, want, 1e-5)


@pytest.mark.parametrize("k", [2, 8])
def test_block_rescue(galaxy, k):
    """k=2 overflows (need > k), so the closest-first top-k choice, ties
    broken towards the lower block index as jax.lax.top_k breaks them,
    decides which partners are summed."""
    a = 4.0 * SIDE / 512
    args = (galaxy["spos"], galaxy["smass"], galaxy["salive"])
    acc_j, need_j, hot_j = jmesh._block_rescue(
        *map(jnp.asarray, args), SOFT2, jnp.float32(a), band=32, k=k,
        chunk=256, switch="poly4")
    acc_t, need_t, hot_t = tmesh._block_rescue(
        *map(_t, args), SOFT2, a, band=32, k=k, chunk=256, switch="poly4")
    assert int(need_t) == int(need_j) and int(hot_t) == int(hot_j)
    if k == 2:
        assert int(need_j) > k
    _close(acc_t, acc_j, 1e-5)


def test_topk_lowest_index_ties():
    score = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0, 3.0, 0.0]])
    vals, idx = tmesh._topk_lowest_index(score, 3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[3.0] * 3]


@pytest.mark.parametrize("mesh_ny,switch", [(0, "exp4"), (256, "poly4")])
def test_pm_accel_with_stats(galaxy, mesh_ny, switch):
    """Whole fresh force pass in original order, with its stats. The mesh
    part differs by FFT rounding; 1e-4 of the largest magnitude."""
    kw = dict(mesh_level=10, split_cells=2.5, band=128, chunk=2048,
              rescue_k=4, mesh_ny=mesh_ny, return_stats=True, switch=switch)
    args = (galaxy["pos"], galaxy["mass"], galaxy["alive"])
    acc_j, st_j = jmesh.pm_accel(*map(jnp.asarray, args), G, SOFT2, ORIGIN,
                                 SIDE, **kw)
    acc_t, st_t = tmesh.pm_accel(*map(_t, args), G, SOFT2, ORIGIN, SIDE,
                                 **kw)
    for key in ("rescue_need", "rescue_hot", "mesh_oob"):
        assert int(st_t[key]) == int(st_j[key]), key
    if mesh_ny:
        assert int(st_t["mesh_oob"]) == 8
    _close(acc_t, acc_j)


def test_unknown_switch_raises():
    with pytest.raises(ValueError, match="switch"):
        tmesh._short_weight(torch.ones(3), 1.0, "exp5")
