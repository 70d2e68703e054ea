"""The P3M force interpolation of the port (``mesh._interp_packed`` from the
force-grid windows, ``mesh._interp_rows`` from a packed table; kernel
``csrc/interp.cu``) against the JAX package's ``tpu_nbody/ops/mesh.py::
_interp_packed`` and ``_interp_rows`` on the same numpy inputs.

On the CPU the wrappers run their plain versions: orders 1, 2 and 3 (NGP,
CIC, TSC) on a level-6 mesh of 32 rows (a rectangular one, so the table's
row width nw and the windows' nw + 1 + reach differ), from the windows and
from tables of 2K lanes and of 4K lanes ``[T | dT]`` with and without
``frac``, within 1e-6 of max |a|. A numpy model of the kernel's windows
entry (the base cell split by nw, the windows read with their own row
stride, the products and sums rounded in the plain version's order) is
held to the plain version bit for bit.

On the card (marker ``cuda``, skipped without one): the kernel against the
plain version bit for bit, both entries, every order, int32 and int64 base
cells, the launch counter. The JAX package is imported inside the tests
that use it, so the ``cuda`` tests also collect where jax is missing.
"""

import numpy as np
import pytest
import torch

from tpu_nbody_torch.kernels import _build
from tpu_nbody_torch.ops import mesh as tmesh

torch.set_num_threads(2)

LEVEL, NY = 6, 32
ORIGIN, SIDE = (-2.0, -802.0), 2404.0
ORDERS = [1, 2, 3]
TABLES = ["2K", "4K", "4K_frac"]
FRAC = 0.25


def _inputs(order, n=3000, seed=0):
    """Bodies over the mesh window and beyond its edges (clipped cells),
    their base cells and weights (the port's ``_cic_cells``), and random
    force-grid windows of the shape ``_fd_gradient`` gives."""
    rng = np.random.default_rng(seed + order)
    nw, ny, _, _, h, _, mo = tmesh._pm_geometry(ORIGIN, SIDE, LEVEL, NY, 2.5)
    lo = np.array(mo, np.float32)
    span = np.array([nw * h, ny * h], np.float32)
    pos = (lo - 0.05 * span + 1.1 * span * rng.random((n, 2))).astype(
        np.float32)
    base, w = tmesh._cic_cells(torch.from_numpy(pos), mo, h, nw, order,
                               ny=ny)
    reach = 1 if order == 3 else 0
    fx, fy = (rng.standard_normal((ny + 1 + reach, nw + 1 + reach))
              .astype(np.float32) for _ in range(2))
    return dict(nw=nw, ny=ny, base=base.numpy(), w=w.numpy(), fx=fx, fy=fy,
                dT=rng.standard_normal((ny * nw, 4 * {1: 1, 2: 4, 3: 9}[
                    order])).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("order", ORDERS)
def test_interp_packed_matches_jax(order):
    import jax.numpy as jnp

    from tpu_nbody.ops import mesh as jmesh
    g = _inputs(order)
    want = jmesh._interp_packed(jnp.asarray(g["fx"]), jnp.asarray(g["fy"]),
                                jnp.asarray(g["base"]), jnp.asarray(g["w"]),
                                g["nw"], ny=g["ny"])
    got = tmesh._interp_packed(_t(g["fx"]), _t(g["fy"]), _t(g["base"]),
                               _t(g["w"]), g["nw"], ny=g["ny"])
    assert got.shape == (len(g["base"]), 2)
    _close(got.numpy(), want)


def _tables(g, order, kind):
    """The packed table of both packages, with ``[T | dT]`` lanes for the
    4K kinds, and the frac each reads."""
    import jax.numpy as jnp

    from tpu_nbody.ops import mesh as jmesh
    K = g["w"].shape[1]
    tj = jmesh._interp_table(jnp.asarray(g["fx"]), jnp.asarray(g["fy"]),
                             g["nw"], order, ny=g["ny"])
    tt = tmesh._interp_table(_t(g["fx"]), _t(g["fy"]), g["nw"], order,
                             ny=g["ny"])
    if kind != "2K":
        dT = g["dT"][:, :2 * K]
        tj = jnp.concatenate([tj, jnp.asarray(dT)], axis=1)
        tt = torch.cat([tt, _t(dT)], dim=1)
    frac = FRAC if kind == "4K_frac" else None
    return tj, tt, frac


@pytest.mark.parametrize("kind", TABLES)
@pytest.mark.parametrize("order", ORDERS)
def test_interp_rows_matches_jax(order, kind):
    import jax.numpy as jnp

    from tpu_nbody.ops import mesh as jmesh
    g = _inputs(order)
    tj, tt, frac = _tables(g, order, kind)
    want = jmesh._interp_rows(tj, jnp.asarray(g["base"]),
                              jnp.asarray(g["w"]),
                              frac=None if frac is None
                              else jnp.float32(frac))
    got = tmesh._interp_rows(tt, _t(g["base"]), _t(g["w"]), frac=frac)
    _close(got.numpy(), want)


def _windows_model(fx, fy, base, w, nw):
    """csrc/interp.cu's windows entry in numpy: base split by nw, the
    windows indexed with their own row stride, every product and sum
    rounded to float32 in the plain version's order from +0.0."""
    n, K = w.shape
    ld = fx.shape[1]
    offs = ([(0, 0)] if K == 1 else [(k // 3, k % 3) for k in range(9)]
            if K == 9 else [(k >> 1, k & 1) for k in range(4)])
    fxf, fyf = fx.reshape(-1), fy.reshape(-1)
    out = np.empty((n, 2), np.float32)
    by, bx = base // nw, base % nw
    cells = [(by + oy) * ld + bx + ox for oy, ox in offs]
    if K == 1:
        out[:, 0] = fxf[cells[0]] * w[:, 0]
        out[:, 1] = fyf[cells[0]] * w[:, 0]
        return out
    ax = np.zeros(n, np.float32)
    ay = np.zeros(n, np.float32)
    for k, c in enumerate(cells):
        ax = ax + w[:, k] * fxf[c]
        ay = ay + w[:, k] * fyf[c]
    out[:, 0], out[:, 1] = ax, ay
    return out


@pytest.mark.parametrize("order", ORDERS)
def test_windows_model_matches_plain_bits(order):
    g = _inputs(order)
    got = _windows_model(g["fx"], g["fy"], g["base"].astype(np.int64),
                         g["w"], g["nw"])
    want = tmesh._interp_packed(_t(g["fx"]), _t(g["fy"]), _t(g["base"]),
                                _t(g["w"]), g["nw"], ny=g["ny"]).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("order", ORDERS)
def test_interp_work_counts_the_touched_cells(order):
    """The bound's cells: the distinct window cells the bodies' taps
    read, against a count of index sets; bytes and flops from them."""
    g = _inputs(order)
    nw, ld = g["nw"], g["fx"].shape[1]
    K = g["w"].shape[1]
    reach = {1: 0, 4: 1, 9: 2}[K]
    cells = {(int(b) // nw + oy) * ld + int(b) % nw + ox
             for b in g["base"] for oy in range(reach + 1)
             for ox in range(reach + 1)}
    work = tmesh.interp_work(_t(g["base"]), K, nw, ld)
    n = len(g["base"])
    assert work["cells"] == len(cells)
    assert work["bytes"] == 8 * len(cells) + n * (4 + 4 * K) + 8 * n
    assert work["flops"] == 2 * (2 * K - 1) * n


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same_bits(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("order", ORDERS)
def test_interp_windows_kernel_matches_plain_on_card(cuda_device, order,
                                                     dtype):
    g = _inputs(order, n=20000)
    fx, fy = _t(g["fx"]).to(cuda_device), _t(g["fy"]).to(cuda_device)
    base = _t(g["base"]).to(cuda_device, dtype)
    w = _t(g["w"]).to(cuda_device)
    before = _build.LAUNCHES["interp"]
    got = tmesh._interp_packed(fx, fy, base, w, g["nw"], ny=g["ny"])
    assert _build.LAUNCHES["interp"] == before + 1
    _same_bits(got, tmesh._interp_packed_ref(fx, fy, base, w, g["nw"],
                                             ny=g["ny"]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", TABLES)
@pytest.mark.parametrize("order", ORDERS)
def test_interp_table_kernel_matches_plain_on_card(cuda_device, order,
                                                   kind):
    g = _inputs(order, n=20000)
    _, tt, frac = _tables(g, order, kind)
    T = tt.to(cuda_device)
    base, w = _t(g["base"]).to(cuda_device), _t(g["w"]).to(cuda_device)
    before = _build.LAUNCHES["interp"]
    got = tmesh._interp_rows(T, base, w, frac=frac)
    assert _build.LAUNCHES["interp"] == before + 1
    _same_bits(got, tmesh._interp_rows_ref(T, base, w, frac))


@pytest.mark.cuda
def test_interp_kernel_refuses_bad_shapes_on_card(cuda_device):
    g = _inputs(2, n=100)
    fx, fy = _t(g["fx"]).to(cuda_device), _t(g["fy"]).to(cuda_device)
    base, w = _t(g["base"]).to(cuda_device), _t(g["w"]).to(cuda_device)
    with pytest.raises(ValueError, match="too small"):
        tmesh._interp_packed(fx[:-1], fy[:-1], base, w, g["nw"],
                             ny=g["ny"])
    with pytest.raises(ValueError, match="lanes"):
        tmesh._interp_rows(torch.zeros((10, 6), device=cuda_device), base,
                           w)
    with pytest.raises(ValueError, match="contiguous"):
        tmesh._interp_packed(fx.t().contiguous().t(), fy, base, w, g["nw"],
                             ny=g["ny"])
