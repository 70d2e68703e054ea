"""The P3M assignment cells and mass deposit of the port
(``mesh._cic_cells``, ``mesh._deposit_packed`` and both at once,
``mesh.deposit_cells``; kernel ``csrc/deposit.cu``) against the JAX
package's ``tpu_nbody/ops/mesh.py::_cic_cells`` and ``_deposit_packed`` on
the same numpy inputs.

On the CPU the wrappers run their plain versions: orders 1, 2 and 3 (NGP,
CIC, TSC) on a level-6 mesh, square (64 rows) and rectangular (32 rows),
with bodies beyond the window's edges (clipped cells). The base cells
equal the JAX package's and the weights are within 1e-6 (they lie in
[0, 1]; XLA may fuse a product and a difference); the deposits are within
1e-6 of max rho (the same products, summed in another order).
``deposit_cells`` returns the leading rows of the padded grid, the
``occ_rows`` the FFT reads by default or a sharded rank's ``occ_p``: the
JAX package's grid on those rows, and exactly zero past them. A numpy
model of the kernel (the cells rounded op by op, then the warp pre-sum
of same-cell bodies and each sum's K products added at row by + oy,
column bx + ox of the block) gives the plain version's cells bit for bit
and its rho within RHO_RTOL of each cell and MASS_RTOL of the total, on
the scene and on the scene drawn 20 times closer to the window's centre,
into the whole grid and into the blocks of the rows the FFT reads: the
sums are of positive terms, in another order. A fresh pass computes
its cells once; its force windows (``_mesh_grids_one``), ``_mesh_force``
and ``pm_accel_sorted`` stay within 1e-4 of the JAX package's max (the
FFT libraries round differently).

On the card (marker ``cuda``, skipped without one): every entry of the
kernel (cells only, cells and deposit at the default rows and a sharded
``occ_p``, deposit from given cells with int32 and int64 base in each
``run_compress`` mode) against the plain version, the cells bit for bit,
rho within the same tolerances (the fused entry also on the scene 20
times closer), the launch counter, two device operations a deposit (the
memset of the block and the kernel; no torch fill), the block exactly
zero past the bodies' reach, and four deposits on four streams at
once. The JAX package is imported
inside the tests that use it, so the ``cuda`` tests also collect where
jax is missing.
"""

import numpy as np
import pytest
import torch

from tpu_nbody_torch.ops import mesh as tmesh

torch.set_num_threads(2)

LEVEL = 6
ORIGIN, SIDE = (-2.0, -802.0), 2404.0
ORDERS = [1, 2, 3]
MESHES = {"square": 0, "rect": 32}
RHO_RTOL = 1e-5     # each cell: positive terms summed in another order
MASS_RTOL = 1e-6    # the total mass deposited
G, SOFT2 = 80.0, 1.0


def _geometry(mesh_ny):
    nw, ny, grid, grid_y, h, a, mo = tmesh._pm_geometry(ORIGIN, SIDE, LEVEL,
                                                        mesh_ny, 2.5)
    return dict(nw=nw, ny=ny, grid=grid, grid_y=grid_y, h=h, a=a, mo=mo)


def _bodies(mesh_ny, n=3000, seed=0, closer=1.0):
    """Bodies over the mesh window and 5% beyond each edge (clipped
    cells), a third of them in a tight clump (many bodies a cell), and
    their masses, a few of them zero (dead); ``closer`` > 1 draws every
    body that many times closer to the window's centre."""
    g = _geometry(mesh_ny)
    rng = np.random.default_rng(seed + mesh_ny)
    lo = np.array(g["mo"], np.float32)
    span = np.array([g["nw"] * g["h"], g["ny"] * g["h"]], np.float32)
    pos = lo - 0.05 * span + 1.1 * span * rng.random((n, 2))
    clump = n // 3
    pos[:clump] = lo + 0.5 * span + 0.5 * g["h"] * rng.standard_normal(
        (clump, 2))
    centre = lo + 0.5 * span
    pos = centre + (pos - centre) / closer
    mass = rng.random(n) * 10.0 + 0.1
    mass[rng.random(n) < 0.05] = 0.0
    return pos.astype(np.float32), mass.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _offsets(K):
    if K == 1:
        return [(0, 0)]
    if K == 9:
        return [(k // 3, k % 3) for k in range(9)]
    return [(k >> 1, k & 1) for k in range(4)]


def _rho_close(got, want):
    """Each cell within RHO_RTOL of the plain version's (zero where it is
    zero), the total within MASS_RTOL."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= RHO_RTOL * np.abs(want))
    assert abs(got.sum() - want.sum()) <= MASS_RTOL * want.sum()


def _cells_model(pos, origin, h, nw, ny, order):
    """csrc/deposit.cu's cells in numpy: every subtraction, division and
    product rounded to float32 on its own, in the plain version's
    order."""
    f = np.float32
    s = (pos - np.array(origin, f)) / f(h)
    if order == 1:
        c = np.floor(s).astype(np.int32)
        bx, by = np.clip(c[:, 0], 0, nw - 1), np.clip(c[:, 1], 0, ny - 1)
        return by * nw + bx, np.ones((len(pos), 1), f)
    if order == 3:
        c = np.floor(s).astype(np.int32)
        d = (s - c.astype(f)) - f(0.5)
        bx = np.clip(c[:, 0] - 1, 0, nw - 1)
        by = np.clip(c[:, 1] - 1, 0, ny - 1)

        def w3(d):
            a, b = f(0.5) - d, f(0.5) + d
            return [f(0.5) * (a * a), f(0.75) - d * d, f(0.5) * (b * b)]

        wx, wy = w3(d[:, 0]), w3(d[:, 1])
        w = np.stack([wy[oy] * wx[ox] for oy, ox in _offsets(9)], axis=1)
        return by * nw + bx, w
    u = s - f(0.5)
    c = np.floor(u).astype(np.int32)
    fr = u - c.astype(f)
    bx, by = np.clip(c[:, 0], 0, nw - 1), np.clip(c[:, 1], 0, ny - 1)
    wx1, wy1 = fr[:, 0], fr[:, 1]
    wx0, wy0 = f(1.0) - wx1, f(1.0) - wy1
    return by * nw + bx, np.stack([wx0 * wy0, wx1 * wy0, wx0 * wy1,
                                   wx1 * wy1], axis=1)


def _deposit_model(mass, base, w, nw, grid, rows):
    """csrc/deposit.cu's deposit in numpy: the bodies of a warp of 32 that
    share a base cell summed in lane order, from +0.0, then each warp's
    K sums m w_k added at row by + oy, column bx + ox of the zeroed
    (rows, grid) block, in body order."""
    n, K = w.shape
    by, bx = base // nw, base % nw
    v = mass[:, None] * w
    key = base.astype(np.int64)
    lane_sum = np.zeros_like(v)
    keep = np.zeros(n, bool)
    for w0 in range(0, n, 32):
        lanes = np.arange(w0, min(w0 + 32, n))
        for b in np.unique(key[lanes]):
            peers = lanes[key[lanes] == b]
            s = np.zeros(K, np.float32)
            for p in peers:
                s = s + v[p]
            lane_sum[peers[0]] = s
            keep[peers[0]] = True
    v = np.where(keep[:, None], lane_sum, np.float32(0.0))
    rho = np.zeros(rows * grid, np.float32)
    for k, (oy, ox) in enumerate(_offsets(K)):
        np.add.at(rho, (by + oy) * grid + bx + ox, v[:, k])
    return rho.reshape(rows, grid)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("order", ORDERS)
def test_cells_match_jax(order, mesh):
    import jax.numpy as jnp

    from tpu_nbody.ops import mesh as jmesh
    g = _geometry(MESHES[mesh])
    pos, _ = _bodies(MESHES[mesh])
    base_j, w_j = jmesh._cic_cells(jnp.asarray(pos),
                                   jnp.asarray(g["mo"], jnp.float32),
                                   jnp.float32(g["h"]), g["nw"], order,
                                   ny=g["ny"])
    base_t, w_t = tmesh._cic_cells(_t(pos), g["mo"], g["h"], g["nw"], order,
                                   ny=g["ny"])
    assert base_t.dtype == torch.int32
    np.testing.assert_array_equal(base_t.numpy(), np.asarray(base_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=1e-6)
    # bodies beyond every edge clip to the border cells
    assert base_t.min() == 0 and base_t.max() == g["ny"] * g["nw"] - 1


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("order", ORDERS)
def test_deposit_matches_jax(order, mesh):
    import jax.numpy as jnp

    from tpu_nbody.ops import mesh as jmesh
    g = _geometry(MESHES[mesh])
    pos, mass = _bodies(MESHES[mesh])
    base, w = tmesh._cic_cells(_t(pos), g["mo"], g["h"], g["nw"], order,
                               ny=g["ny"])
    args = (g["nw"], g["grid"])
    kw = dict(ny=g["ny"], grid_y=g["grid_y"])
    want = np.asarray(jmesh._deposit_packed(
        jnp.asarray(mass), jnp.asarray(base.numpy()), jnp.asarray(w.numpy()),
        *args, **kw))
    got = tmesh._deposit_packed(_t(mass), base, w, *args, **kw).numpy()
    assert got.shape == want.shape == (g["grid_y"], g["grid"])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    rho, b2, w2 = tmesh.deposit_cells(_t(pos), _t(mass), g["mo"], g["h"],
                                      g["nw"], g["grid"], order, **kw)
    assert torch.equal(b2, base) and torch.equal(w2, w)
    rows = tmesh.occ_rows(g["ny"], order)
    assert rho.shape == (rows, g["grid"])
    assert np.array_equal(rho.numpy(), got[:rows])


def _sharded_rows(g):
    """A 4-rank slab FFT's ``occ_p``: the rows it reduce-scatters."""
    from tpu_nbody_torch.parallel import sharded_pm
    return sharded_pm._occ_rows_p(g["ny"], 4, g["grid_y"])


@pytest.mark.parametrize("rows", ["occ", "occ_p"])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("order", ORDERS)
def test_deposit_cells_block_matches_jax(order, mesh, rows):
    """The block ``deposit_cells`` returns, at the default rows and at a
    sharded rank's ``occ_p``, is the JAX package's grid on its leading
    rows, and the JAX grid is exactly zero past them."""
    import jax.numpy as jnp

    from tpu_nbody.ops import mesh as jmesh
    g = _geometry(MESHES[mesh])
    pos, mass = _bodies(MESHES[mesh], n=1500, seed=5)
    kw = dict(ny=g["ny"], grid_y=g["grid_y"])
    base, w = jmesh._cic_cells(jnp.asarray(pos),
                               jnp.asarray(g["mo"], jnp.float32),
                               jnp.float32(g["h"]), g["nw"], order,
                               ny=g["ny"])
    want = np.asarray(jmesh._deposit_packed(jnp.asarray(mass), base, w,
                                            g["nw"], g["grid"], **kw))
    r = (tmesh.occ_rows(g["ny"], order) if rows == "occ"
         else _sharded_rows(g))
    rho, _, _ = tmesh.deposit_cells(_t(pos), _t(mass), g["mo"], g["h"],
                                    g["nw"], g["grid"], order, rows=r, **kw)
    assert rho.shape == (r, g["grid"])
    assert not want[r:].any()
    np.testing.assert_allclose(rho.numpy(), want[:r], rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("order", ORDERS)
def test_deposit_cells_refuses_rows(order):
    """A block that misses a row the bodies reach, or has more rows than
    the grid, raises."""
    g = _geometry(32)
    pos, mass = _bodies(32, n=64)
    occ = tmesh.occ_rows(g["ny"], order)
    for r in (g["ny"] + {1: 0, 2: 1, 3: 2}[order], g["grid_y"] + 1):
        with pytest.raises(ValueError, match="rows|too small"):
            tmesh.deposit_cells(_t(pos), _t(mass), g["mo"], g["h"], g["nw"],
                                g["grid"], order, ny=g["ny"],
                                grid_y=g["grid_y"], rows=r)
    assert occ == g["ny"] + (3 if order == 3 else 2)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("order", ORDERS)
def test_cells_model_matches_plain_bits(order, mesh):
    g = _geometry(MESHES[mesh])
    pos, _ = _bodies(MESHES[mesh])
    base, w = _cells_model(pos, g["mo"], g["h"], g["nw"], g["ny"], order)
    base_t, w_t = tmesh._cic_cells_ref(_t(pos), g["mo"], g["h"], g["nw"],
                                       order, ny=g["ny"])
    np.testing.assert_array_equal(base, base_t.numpy())
    np.testing.assert_array_equal(w.view(np.int32), w_t.numpy().view(
        np.int32))


@pytest.mark.parametrize("closer", [1.0, 20.0])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("order", ORDERS)
def test_deposit_model_matches_plain(order, mesh, closer):
    g = _geometry(MESHES[mesh])
    pos, mass = _bodies(MESHES[mesh], closer=closer)
    base, w = _cells_model(pos, g["mo"], g["h"], g["nw"], g["ny"], order)
    got = _deposit_model(mass, base, w, g["nw"], g["grid"], g["grid_y"])
    want = tmesh._deposit_packed_ref(_t(mass), _t(base), _t(w), g["nw"],
                                     g["grid"], ny=g["ny"],
                                     grid_y=g["grid_y"])
    _rho_close(got, want.numpy())
    # the rows and columns past the reach of the clipped cells stay zero
    reach = {1: 0, 2: 1, 3: 2}[order]
    assert not got[g["ny"] + reach + 1:].any()
    assert not got[:, g["nw"] + reach + 1:].any()


@pytest.mark.parametrize("rows", ["occ", "occ_p"])
@pytest.mark.parametrize("closer", [1.0, 20.0])
@pytest.mark.parametrize("order", ORDERS)
def test_deposit_model_block_matches_plain(order, closer, rows):
    """The kernel's order of sums into the block of the rows the FFT reads
    (``occ_rows``, or a sharded rank's ``occ_p``), on the Hilbert-sorted
    scene and 20 times closer: within RHO_RTOL a cell and MASS_RTOL of the
    total of the plain version's leading rows, which hold all its mass."""
    g = _geometry(32)
    spos, smass, _ = _sorted_scene(32, n=3000)
    pos = spos.numpy()
    if closer != 1.0:
        centre = np.array(g["mo"], np.float32) + 0.5 * np.array(
            [g["nw"] * g["h"], g["ny"] * g["h"]], np.float32)
        pos = (centre + (pos - centre) / np.float32(closer)).astype(
            np.float32)
    mass = smass.numpy()
    base, w = _cells_model(pos, g["mo"], g["h"], g["nw"], g["ny"], order)
    r = (tmesh.occ_rows(g["ny"], order) if rows == "occ"
         else _sharded_rows(g))
    got = _deposit_model(mass, base, w, g["nw"], g["grid"], r)
    want = tmesh._deposit_packed_ref(_t(mass), _t(base), _t(w), g["nw"],
                                     g["grid"], ny=g["ny"],
                                     grid_y=g["grid_y"]).numpy()
    assert not want[r:].any()
    _rho_close(got, want[:r])


def _sorted_scene(mesh_ny, n=2048):
    pos, mass = _bodies(mesh_ny, n=n)
    alive = mass > 0
    spos, smass, salive, _ = tmesh._hilbert_sort(_t(pos), _t(mass),
                                                 _t(alive), ORIGIN, SIDE)
    return spos.contiguous(), smass.contiguous(), salive


def _kernel_hats(g, order):
    return tmesh._kernel_hats(g["grid"], g["h"], SOFT2, g["a"],
                              torch.float32, "cpu", grid_y=g["grid_y"],
                              deconv_order=order, switch="poly4")


def _count_cells(monkeypatch):
    calls = []
    ref = tmesh._cic_cells_ref

    def counted(*a, **k):
        calls.append(1)
        return ref(*a, **k)

    monkeypatch.setattr(tmesh, "_cic_cells_ref", counted)
    return calls


@pytest.mark.parametrize("order", ORDERS)
def test_mesh_force_cells_once_matches_jax(order, monkeypatch):
    import jax.numpy as jnp

    from tpu_nbody.ops import mesh as jmesh
    g = _geometry(32)
    spos, smass, _ = _sorted_scene(32)
    kernel = _kernel_hats(g, order)
    calls = _count_cells(monkeypatch)
    got = tmesh._mesh_force(spos, smass, g["mo"], g["h"], g["nw"], g["grid"],
                            SOFT2, g["a"], order, kernel, ny=g["ny"])
    assert len(calls) == 1
    want = jmesh._mesh_force(jnp.asarray(spos.numpy()),
                             jnp.asarray(smass.numpy()),
                             jnp.asarray(g["mo"], jnp.float32),
                             jnp.float32(g["h"]), g["nw"], g["grid"], SOFT2,
                             g["a"], order,
                             tuple(jnp.asarray(k.numpy()) for k in kernel),
                             ny=g["ny"])
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("order", ORDERS)
def test_mesh_grids_one_matches_jax(order):
    """The fresh pass end to end (the deposit's block, the FFT, the FD
    gradient): the force windows within 1e-4 of the JAX package's max."""
    import jax.numpy as jnp

    from tpu_nbody.ops import mesh as jmesh
    g = _geometry(32)
    spos, smass, _ = _sorted_scene(32)
    kernel = _kernel_hats(g, order)
    got = tmesh._mesh_grids_one(spos, smass, g["mo"], g["h"], g["nw"],
                                g["grid"], order, kernel, ny=g["ny"])
    want = jmesh._mesh_grids_one(
        jnp.asarray(spos.numpy()), jnp.asarray(smass.numpy()),
        jnp.asarray(g["mo"], jnp.float32), jnp.float32(g["h"]), g["nw"],
        g["grid"], order, tuple(jnp.asarray(k.numpy()) for k in kernel),
        ny=g["ny"])
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
def test_pm_accel_sorted_cells_once_matches_jax(mesh, interlace,
                                                monkeypatch):
    import jax.numpy as jnp

    from tpu_nbody.ops import mesh as jmesh
    spos, smass, salive = _sorted_scene(MESHES[mesh])
    kw = dict(mesh_level=LEVEL, split_cells=2.5, band=32, chunk=512,
              rescue_k=2, mesh_ny=MESHES[mesh], interlace=interlace,
              switch="poly4")
    calls = _count_cells(monkeypatch)
    acc_t, st_t = tmesh.pm_accel_sorted(spos, smass, salive, G, SOFT2,
                                        ORIGIN, SIDE, **kw)
    assert len(calls) == (2 if interlace else 1)    # one a registration
    acc_j, st_j = jmesh.pm_accel_sorted(
        *(jnp.asarray(x.numpy()) for x in (spos, smass, salive)), G, SOFT2,
        ORIGIN, SIDE, **kw)
    assert [int(x) for x in st_t] == [int(x) for x in st_j]
    want = np.asarray(acc_j)
    np.testing.assert_allclose(acc_t.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_deposit_refuses_bad_arguments():
    g = _geometry(32)
    pos, mass = _bodies(32, n=64)
    base, w = tmesh._cic_cells(_t(pos), g["mo"], g["h"], g["nw"], 2,
                               ny=g["ny"])
    with pytest.raises(ValueError, match="divide"):
        tmesh._deposit_packed(_t(mass), base, w, g["nw"], g["grid"],
                              run_compress=24, ny=g["ny"], grid_y=g["grid_y"])
    with pytest.raises(ValueError, match="order"):
        tmesh.deposit_cells(_t(pos), _t(mass), g["mo"], g["h"], g["nw"],
                            g["grid"], 4, ny=g["ny"], grid_y=g["grid_y"])


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same_bits(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.contiguous().view(torch.int32),
                       want.contiguous().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("order", ORDERS)
def test_cells_kernel_matches_plain_on_card(cuda_device, order, mesh):
    g = _geometry(MESHES[mesh])
    pos = _t(_bodies(MESHES[mesh], n=20000)[0]).to(cuda_device)
    before = tmesh.DEPOSIT_LAUNCHES
    base, w = tmesh._cic_cells(pos, g["mo"], g["h"], g["nw"], order,
                               ny=g["ny"])
    assert tmesh.DEPOSIT_LAUNCHES == before + 1
    base_p, w_p = tmesh._cic_cells_ref(pos, g["mo"], g["h"], g["nw"], order,
                                       ny=g["ny"])
    _same_bits(base, base_p)
    _same_bits(w, w_p)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["occ", "occ_p"])
@pytest.mark.parametrize("closer", [1.0, 20.0])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("order", ORDERS)
def test_deposit_cells_kernel_matches_plain_on_card(cuda_device, order, mesh,
                                                    closer, rows):
    g = _geometry(MESHES[mesh])
    pos, mass = (_t(x).to(cuda_device)
                 for x in _bodies(MESHES[mesh], n=20000, closer=closer))
    kw = dict(ny=g["ny"], grid_y=g["grid_y"])
    r = (tmesh.occ_rows(g["ny"], order) if rows == "occ"
         else _sharded_rows(g))
    before = tmesh.DEPOSIT_LAUNCHES
    rho, base, w = tmesh.deposit_cells(pos, mass, g["mo"], g["h"], g["nw"],
                                       g["grid"], order, rows=r, **kw)
    assert tmesh.DEPOSIT_LAUNCHES == before + 1
    assert rho.shape == (r, g["grid"])
    base_p, w_p = tmesh._cic_cells_ref(pos, g["mo"], g["h"], g["nw"], order,
                                       ny=g["ny"])
    _same_bits(base, base_p)
    _same_bits(w, w_p)
    want = tmesh._deposit_packed_ref(mass, base_p, w_p, g["nw"], g["grid"],
                                     **kw)
    _rho_close(rho.cpu().numpy(), want[:r].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("order", ORDERS)
def test_deposit_block_zero_past_bodies_on_card(cuda_device, order):
    """Bodies in the window's lower-left quarter (memory that held other
    values before): every cell of the fused entry's block and of the
    given entry's grid past their reach is exactly 0, including the
    block's rows past the mesh."""
    g = _geometry(0)
    pos, mass = _bodies(0, n=5000, seed=3)
    lo = np.array(g["mo"], np.float32)
    span = np.array([g["nw"] * g["h"], g["ny"] * g["h"]], np.float32)
    pos = (lo + 0.1 * span + (pos - lo) * 0.3).astype(np.float32)
    pos, mass = _t(pos).to(cuda_device), _t(mass).to(cuda_device)
    torch.full((1 << 22,), float("nan"), device=cuda_device)  # dirty memory
    kw = dict(ny=g["ny"], grid_y=g["grid_y"])
    rho, base, w = tmesh.deposit_cells(pos, mass, g["mo"], g["h"], g["nw"],
                                       g["grid"], order, **kw)
    given = tmesh._deposit_packed(mass, base, w, g["nw"], g["grid"], **kw)
    reach = {1: 0, 2: 1, 3: 2}[order]
    b = base.long()
    y1 = int((b // g["nw"]).max()) + reach
    x1 = int((b % g["nw"]).max()) + reach
    torch.cuda.synchronize()
    assert rho.shape == (tmesh.occ_rows(g["ny"], order), g["grid"])
    for r in (rho, given):
        assert torch.isfinite(r).all()
        assert not r[y1 + 1:].any() and not r[:, x1 + 1:].any()
        assert r.sum() > 0


@pytest.mark.cuda
def test_deposit_device_operations_on_card(cuda_device):
    """A fresh pass's deposit enqueues a memset of its block and the
    kernel: no torch fill of the grid."""
    from tpu_nbody_torch import profiling
    g = _geometry(0)
    pos, mass = (_t(x).to(cuda_device) for x in _bodies(0, n=20000))
    ops = profiling.device_ops(lambda: tmesh.deposit_cells(
        pos, mass, g["mo"], g["h"], g["nw"], g["grid"], 2, ny=g["ny"],
        grid_y=g["grid_y"]))
    assert len(ops) == 2 and "emset" in ops[0] \
        and "deposit_kernel" in ops[1], ops


@pytest.mark.cuda
def test_deposits_on_four_streams_on_card(cuda_device):
    """Four deposits at once on four streams complete, each the plain
    version's block."""
    g = _geometry(0)
    pos, mass = (_t(x).to(cuda_device) for x in _bodies(0, n=200000))
    kw = dict(ny=g["ny"], grid_y=g["grid_y"])
    base_p, w_p = tmesh._cic_cells_ref(pos, g["mo"], g["h"], g["nw"], 2,
                                       ny=g["ny"])
    want = tmesh._deposit_packed_ref(mass, base_p, w_p, g["nw"], g["grid"],
                                     **kw)[:tmesh.occ_rows(g["ny"], 2)]
    streams = [torch.cuda.Stream() for _ in range(4)]
    torch.cuda.synchronize()
    outs = []
    for _ in range(3):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(tmesh.deposit_cells(pos, mass, g["mo"], g["h"],
                                                g["nw"], g["grid"], 2,
                                                **kw)[0])
    torch.cuda.synchronize()
    for rho in outs:
        _rho_close(rho.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [False, True, 8])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("order", ORDERS)
def test_deposit_given_kernel_matches_plain_on_card(cuda_device, order,
                                                    dtype, mode):
    g = _geometry(32)
    pos, mass = (_t(x).to(cuda_device) for x in _bodies(32, n=20000))
    base, w = tmesh._cic_cells_ref(pos, g["mo"], g["h"], g["nw"], order,
                                   ny=g["ny"])
    kw = dict(ny=g["ny"], grid_y=g["grid_y"])
    before = tmesh.DEPOSIT_LAUNCHES
    got = tmesh._deposit_packed(mass, base.to(dtype), w, g["nw"], g["grid"],
                                run_compress=mode, **kw)
    assert tmesh.DEPOSIT_LAUNCHES == before + 1
    want = tmesh._deposit_packed_ref(mass, base, w, g["nw"], g["grid"], **kw)
    _rho_close(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_fresh_pass_launches_on_card(cuda_device):
    """A fresh pass: one deposit (cells and deposit), one FD gradient and
    one interpolation launch, no cells-only launch."""
    g = _geometry(32)
    spos, smass, salive = (x.to(cuda_device) for x in _sorted_scene(32))
    kernel = tuple(k.to(cuda_device) for k in _kernel_hats(g, 2))
    counts = (tmesh.DEPOSIT_LAUNCHES, tmesh.FD_LAUNCHES,
              tmesh.INTERP_LAUNCHES)
    acc = tmesh._mesh_force(spos, smass, g["mo"], g["h"], g["nw"], g["grid"],
                            SOFT2, g["a"], 2, kernel, ny=g["ny"])
    assert (tmesh.DEPOSIT_LAUNCHES, tmesh.FD_LAUNCHES,
            tmesh.INTERP_LAUNCHES) == tuple(c + 1 for c in counts)
    want = tmesh._mesh_force(spos.cpu(), smass.cpu(), g["mo"], g["h"],
                             g["nw"], g["grid"], SOFT2, g["a"], 2,
                             tuple(k.cpu() for k in kernel), ny=g["ny"])
    scale = float(want.abs().max())
    assert float((acc.cpu() - want).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_deposit_kernel_refuses_bad_inputs_on_card(cuda_device):
    g = _geometry(32)
    pos, mass = (_t(x).to(cuda_device) for x in _bodies(32, n=256))
    base, w = tmesh._cic_cells(pos, g["mo"], g["h"], g["nw"], 3, ny=g["ny"])
    with pytest.raises(ValueError, match="too small"):
        tmesh._deposit_packed(mass, base, w, g["nw"], g["grid"], ny=g["ny"],
                              grid_y=g["ny"] + 2)
    with pytest.raises(ValueError, match="divide"):
        tmesh._deposit_packed(mass, base, w, g["nw"], g["grid"],
                              run_compress=24, ny=g["ny"],
                              grid_y=g["grid_y"])
    with pytest.raises(ValueError, match="contiguous"):
        tmesh._deposit_packed(mass, base, w.t().contiguous().t(), g["nw"],
                              g["grid"], ny=g["ny"], grid_y=g["grid_y"])
