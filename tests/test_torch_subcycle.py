"""Port parity: the P3M knobs beyond the main path — NGP and TSC
assignment, the run-compressed deposits, interlace, two-tier rescue,
heavy-direct and the carried (subcycled) mesh state — against
tpu_nbody.ops.mesh on the same inputs.

Tolerances are stated per test. Pieces without an FFT compare within 1e-6
(weights) or 1e-5 of the largest magnitude (sums of the same products in
another order); pieces through the FFT within 1e-5 (grids) or 1e-4
(whole force passes, as tests/test_torch_mesh.py) of the largest
magnitude. Integer outputs and masks must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nbody.models import scenes as jscenes
from tpu_nbody.ops import mesh as jmesh
from tpu_nbody_torch.ops import mesh as tmesh

torch.set_num_threads(2)

ORIGIN = (-2.0, -802.0)
SIDE = 2404.0
G, SOFT2 = 80.0, 1.0
LEVEL, NY, SPLIT = 9, 256, 2.5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, frac):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * np.abs(want).max())


@pytest.fixture(scope="module")
def galaxy():
    """A galaxy disk of 2000 bodies in 2048 slots, Hilbert-sorted by the
    JAX package: one 50 000 central and 1999 satellites of one equal mass,
    so any top-k of masses past the central is a tie."""
    n, cap = 2000, 2048
    p, _, m = jscenes.make_galaxy_disk(jax.random.PRNGKey(7), n, r=300.0)
    pos = np.zeros((cap, 2), np.float32)
    mass = np.zeros(cap, np.float32)
    pos[:n], mass[:n] = np.asarray(p), np.asarray(m)
    alive = np.arange(cap) < n
    spos, smass, salive, _ = jmesh._hilbert_sort(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(alive), ORIGIN,
        SIDE)
    assert len(np.unique(np.asarray(m)[1:])) == 1
    return dict(pos=pos, mass=mass, alive=alive, spos=np.asarray(spos),
                smass=np.asarray(smass), salive=np.asarray(salive))


def _geometry():
    nw, ny, grid, grid_y, h, a, morigin = tmesh._pm_geometry(
        ORIGIN, SIDE, LEVEL, NY, SPLIT)
    return dict(nw=nw, ny=ny, grid=grid, grid_y=grid_y, h=h, a=a,
                morigin=morigin)


@pytest.mark.parametrize("order", [1, 3])
def test_cells_table_and_grids(galaxy, order):
    g = _geometry()
    nw, ny, h, mo = g["nw"], g["ny"], g["h"], g["morigin"]
    base_j, w_j = jmesh._cic_cells(jnp.asarray(galaxy["spos"]),
                                   jnp.asarray(mo, jnp.float32),
                                   jnp.float32(h), nw, order, ny=ny)
    base_t, w_t = tmesh._cic_cells(_t(galaxy["spos"]), mo, h, nw, order,
                                   ny=ny)
    assert w_t.shape[1] == {1: 1, 3: 9}[order]
    np.testing.assert_array_equal(base_t.numpy(), np.asarray(base_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=1e-6)

    rho_j = jmesh._deposit_packed(jnp.asarray(galaxy["smass"]), base_j, w_j,
                                  nw, g["grid"], ny=ny, grid_y=g["grid_y"])
    rho_t = tmesh._deposit_packed(_t(galaxy["smass"]), base_t, w_t, nw,
                                  g["grid"], ny=ny, grid_y=g["grid_y"])
    _close(rho_t, rho_j, 1e-5)

    reach = 1 if order == 3 else 0
    rng = np.random.default_rng(order)
    fx, fy = (rng.standard_normal((ny + 1 + reach, nw + 1 + reach))
              .astype(np.float32) for _ in range(2))
    tab_j = jmesh._interp_table(jnp.asarray(fx), jnp.asarray(fy), nw, order,
                                ny=ny)
    tab_t = tmesh._interp_table(_t(fx), _t(fy), nw, order, ny=ny)
    np.testing.assert_array_equal(tab_t.numpy(), np.asarray(tab_j))
    _close(tmesh._interp_rows(tab_t, base_t, w_t),
           jmesh._interp_rows(tab_j, base_j, w_j), 1e-6)

    kernel = jmesh.kernel_hats_for(SIDE, SOFT2, mesh_level=LEVEL,
                                   split_cells=SPLIT, mesh_ny=NY, order=order)
    kernel_t = tmesh.kernel_hats_for(SIDE, SOFT2, mesh_level=LEVEL,
                                     split_cells=SPLIT, mesh_ny=NY,
                                     order=order, device="cpu")
    for k_t, k_j in zip(kernel_t, kernel):
        _close(k_t, k_j, 1e-4)
    grids_j = jmesh._mesh_grids_one(
        jnp.asarray(galaxy["spos"]), jnp.asarray(galaxy["smass"]),
        jnp.asarray(mo, jnp.float32), jnp.float32(h), nw, g["grid"], order,
        kernel, ny=ny)
    grids_t = tmesh._mesh_grids_one(
        _t(galaxy["spos"]), _t(galaxy["smass"]), mo, h, nw, g["grid"], order,
        tuple(_t(k) for k in kernel), ny=ny)
    for f_t, f_j in zip(grids_t, grids_j):
        assert f_t.shape == (ny + 1 + reach, nw + 1 + reach)
        _close(f_t, f_j, 1e-5)


@pytest.mark.parametrize("mode,order", [(True, 2), (8, 2), (8, 3)])
def test_run_compressed_deposit(galaxy, mode, order):
    """Exact run sums (a segment sum by run id here, an associative scan
    in JAX) and window-8 compression, against the JAX deposit in the same
    mode and against the port's plain deposit: 1e-5 of max rho."""
    g = _geometry()
    nw, ny = g["nw"], g["ny"]
    base, w = tmesh._cic_cells(_t(galaxy["spos"]), g["morigin"], g["h"], nw,
                               order, ny=ny)
    m = _t(galaxy["smass"])
    args = (nw, g["grid"])
    kw = dict(ny=ny, grid_y=g["grid_y"])
    want = jmesh._deposit_packed(jnp.asarray(m.numpy()),
                                 jnp.asarray(base.numpy()),
                                 jnp.asarray(w.numpy()), *args,
                                 run_compress=mode, **kw)
    got = tmesh._deposit_packed(m, base, w, *args, run_compress=mode, **kw)
    plain = tmesh._deposit_packed(m, base, w, *args, **kw)
    _close(got, want, 1e-5)
    _close(got, plain, 1e-5)


def test_run_compress_window_must_divide():
    with pytest.raises(ValueError, match="divide"):
        tmesh._deposit_packed(torch.ones(10), torch.zeros(10, dtype=torch.int32),
                              torch.ones((10, 4)), 8, 16, run_compress=4)


PASS_KW = dict(mesh_level=LEVEL, split_cells=SPLIT, band=32, chunk=512,
               rescue_k=2, mesh_ny=NY, switch="poly4")


@pytest.mark.parametrize("knobs", [
    dict(interlace=True), dict(order=3), dict(order=1),
    dict(order=3, interlace=True, heavy_cap=3),
    dict(rescue_k_hot=8), dict(rescue_k_hot=8, rescue_hot_cap=4),
    dict(heavy_cap=5), dict(heavy_cap=5, interlace=True, switch="exp4"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_pm_accel_knobs(galaxy, knobs):
    """Whole fresh force passes with each knob, stats equal. heavy_cap
    picks the central and then satellites of equal mass: the lowest
    Hilbert positions win the tie, as jax.lax.top_k picks them. With
    rescue_hot_cap=4 more blocks are hot than the hot tier serves."""
    kw = dict(PASS_KW, return_stats=True, **knobs)
    args = (galaxy["pos"], galaxy["mass"], galaxy["alive"])
    acc_j, st_j = jmesh.pm_accel(*map(jnp.asarray, args), G, SOFT2, ORIGIN,
                                 SIDE, **kw)
    acc_t, st_t = tmesh.pm_accel(*map(_t, args), G, SOFT2, ORIGIN, SIDE,
                                 **kw)
    for key in ("rescue_need", "rescue_hot", "mesh_oob"):
        assert int(st_t[key]) == int(st_j[key]), key
    if "rescue_hot_cap" in knobs:
        assert int(st_t["rescue_hot"]) > knobs["rescue_hot_cap"]
    _close(acc_t, acc_j, 1e-4)


def _mesh_states(galaxy, prev, heavy_cap=4):
    """JAX and port mesh states (interlaced) of the sorted galaxy; with
    ``prev="grids"`` each side's previous grids come from its own state
    of positions moved by 3 px."""
    kw = dict(mesh_level=LEVEL, split_cells=SPLIT, mesh_ny=NY,
              interlace=True, heavy_cap=heavy_cap, switch="poly4")
    sp, sm, sa = galaxy["spos"], galaxy["smass"], galaxy["salive"]
    old = sp + np.float32(3.0)
    out = []
    for lib, conv in ((jmesh, jnp.asarray), (tmesh, _t)):
        p = prev
        if prev == "grids":
            p = lib.pm_mesh_state(conv(old), conv(sm), conv(sa), SOFT2,
                                  ORIGIN, SIDE, **kw)[0]
        out.append(lib.pm_mesh_state(conv(sp), conv(sm), conv(sa), SOFT2,
                                     ORIGIN, SIDE, prev=p, **kw))
    return out


@pytest.mark.parametrize("prev", [None, "zero", "grids"])
def test_pm_mesh_state(galaxy, prev):
    ms_j, ms_t = _mesh_states(galaxy, prev)
    grids_j, dep_pos_j, dep_wmass_j, heavy_j = ms_j
    grids_t, dep_pos_t, dep_wmass_t, heavy_t = ms_t
    lanes = 8 if prev is None else 16
    assert len(grids_t) == 2
    for t_t, t_j in zip(grids_t, grids_j):
        # the ΔT lanes carry the rounding of both grids: held within 1e-5
        # of the largest |T|, as the T lanes are
        assert t_t.shape == (NY << LEVEL, lanes)
        np.testing.assert_allclose(
            t_t.numpy(), np.asarray(t_j), rtol=0,
            atol=1e-5 * np.abs(np.asarray(t_j)[:, :8]).max())
    np.testing.assert_array_equal(dep_pos_t.numpy(), np.asarray(dep_pos_j))
    np.testing.assert_array_equal(heavy_t.numpy(), np.asarray(heavy_j))
    np.testing.assert_array_equal(dep_wmass_t.numpy(),
                                  np.asarray(dep_wmass_j))
    assert int(heavy_t.sum()) == 4 and not dep_wmass_t[heavy_t].any()


@pytest.mark.parametrize("frac", [None, 0.5])
def test_pm_accel_sorted_carried_state(galaxy, frac):
    """A stale, extrapolated state read 3 px away from where it was
    deposited, with the self-term and the heavy-direct sum: the carried
    branch of pm_accel_sorted. 1e-4 of the largest magnitude."""
    ms_j, ms_t = _mesh_states(galaxy, "grids")
    now = galaxy["spos"] + np.float32(3.0)
    kw = dict(PASS_KW, heavy_cap=4, interlace=True, self_correct=True,
              stale_frac=frac)
    sm, sa = galaxy["smass"], galaxy["salive"]
    acc_j, st_j = jmesh.pm_accel_sorted(
        jnp.asarray(now), jnp.asarray(sm), jnp.asarray(sa), G, SOFT2, ORIGIN,
        SIDE, mesh_state=ms_j, **dict(
            kw, stale_frac=None if frac is None else jnp.float32(frac)))
    acc_t, st_t = tmesh.pm_accel_sorted(_t(now), _t(sm), _t(sa), G, SOFT2,
                                        ORIGIN, SIDE, mesh_state=ms_t, **kw)
    assert [int(x) for x in st_t] == [int(x) for x in st_j]
    _close(acc_t, acc_j, 1e-4)


def test_self_term_and_heavy_direct(galaxy):
    rng = np.random.default_rng(5)
    sp, sm, sa = galaxy["spos"], galaxy["smass"], galaxy["salive"]
    moved = sp + rng.normal(0, 4.0, sp.shape).astype(np.float32)
    a = _geometry()["a"]
    want = jmesh._self_term(jnp.asarray(moved), jnp.asarray(sp),
                            jnp.asarray(sm), jnp.float32(SOFT2),
                            jnp.float32(a), switch="poly4")
    got = tmesh._self_term(_t(moved), _t(sp), _t(sm), SOFT2, a,
                           switch="poly4")
    _close(got, want, 1e-5)

    heavy = np.zeros(sp.shape[0], bool)
    heavy[np.argsort(-sm, kind="stable")[:6]] = True
    heavy[np.flatnonzero(~sa)[:2]] = True          # dead: no force
    want = jmesh._heavy_direct(jnp.asarray(moved), jnp.asarray(sm),
                               jnp.asarray(sa), jnp.asarray(heavy),
                               jnp.float32(SOFT2), jnp.float32(a), 8,
                               switch="poly4")
    got = tmesh._heavy_direct(_t(moved), _t(sm), _t(sa), _t(heavy), SOFT2, a,
                              8, switch="poly4")
    _close(got, want, 1e-5)


def test_topk_lowest_index_orders_negatives():
    """Negative scores order by value and ties go to the lower index, as
    in jax.lax.top_k, in one and two dimensions."""
    score = torch.tensor([-1.0, 2.0, -0.5, -1.0, 2.0, -3.0, -1.0])
    want_v, want_i = jax.lax.top_k(jnp.asarray(score.numpy()), 6)
    vals, idx = tmesh._topk_lowest_index(score, 6)
    assert idx.tolist() == np.asarray(want_i).tolist() == [1, 4, 2, 0, 3, 6]
    assert vals.tolist() == np.asarray(want_v).tolist()
    vals2, idx2 = tmesh._topk_lowest_index(torch.stack([score, -score]), 3)
    assert idx2.tolist() == [[1, 4, 2], [5, 0, 3]]
