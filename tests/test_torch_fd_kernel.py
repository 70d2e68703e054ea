"""The P3M 6th-order finite-difference gradient of the port
(``mesh._fd_gradient`` on the one-device potential rows, ``mesh.fd_window``
on any rows, which the sharded P3M runs on its halo-extended slabs; kernel
``csrc/fd.cu``) against the JAX package's ``tpu_nbody/ops/mesh.py::
_mesh_grids_one``, whose last step it is, on the same numpy inputs.

On the CPU the wrappers run their plain versions. ``_mesh_grids_one`` in
orders 1, 2 and 3 on a level-6 mesh, square (64 rows) and rectangular (32
rows), with bodies beyond the window's edges, is within 1e-4 of the JAX
package's largest magnitude (the FFT libraries round differently). On
the same potential rows the one-device stencil and the general one give
the same bits, and so does a numpy model of the kernel: source row i + 3
± k, source column (j ± k) mod W, which is the JAX version's rolled
column (j + 3 ± k) - 3, every subtraction, product and sum rounded to
float32 on its own in the plain version's order.

On the card (marker ``cuda``, skipped without one): the kernel against
the plain version bit for bit, at the one-device shapes (reach 0 and 1,
square and rectangular) and on a slab, the launch counter, and the
refused shapes. The JAX package is imported inside the tests that use it,
so the ``cuda`` tests also collect where jax is missing.
"""

import numpy as np
import pytest
import torch

from tpu_nbody_torch.kernels import _build
from tpu_nbody_torch.ops import mesh as tmesh

torch.set_num_threads(2)

LEVEL = 6
ORIGIN, SIDE = (-2.0, -802.0), 2404.0
ORDERS = [1, 2, 3]
MESHES = {"square": 0, "rect": 32}
SOFT2 = 1.0


def _geometry(mesh_ny):
    nw, ny, grid, grid_y, h, a, mo = tmesh._pm_geometry(ORIGIN, SIDE, LEVEL,
                                                        mesh_ny, 2.5)
    return dict(nw=nw, ny=ny, grid=grid, grid_y=grid_y, h=h, a=a, mo=mo)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _potential_rows(mesh_ny, reach, seed=0):
    """Random potential rows of the shape ``_conv_potential`` returns:
    (ny + 7 + reach, grid)."""
    g = _geometry(mesh_ny)
    rng = np.random.default_rng(seed + 10 * reach + mesh_ny)
    return rng.standard_normal((g["ny"] + 7 + reach, g["grid"])).astype(
        np.float32)


def _fd_model(src, h, rows, cols):
    """csrc/fd.cu in numpy: output (i, j) from source row i + 3 + k and
    column (j + k) mod W, k = -3..3, every operation rounded to float32 in
    the plain version's order."""
    f = np.float32
    c1, c2, c3 = (f(c) for c in tmesh._fd_coefficients(h))
    W = src.shape[1]
    j = np.arange(cols)

    def px(k):                      # row i + 3, column (j + k) mod W
        return src[3:3 + rows][:, (j + k) % W]

    def py(k):                      # row i + 3 + k, column j
        return src[3 + k:3 + k + rows, :cols]

    def stencil(p):
        return ((c1 * (p(1) - p(-1)) - c2 * (p(2) - p(-2)))
                + c3 * (p(3) - p(-3)))

    return stencil(px), stencil(py)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("order", ORDERS)
def test_mesh_grids_match_jax(order, mesh):
    import jax.numpy as jnp

    from tpu_nbody.ops import mesh as jmesh
    g = _geometry(MESHES[mesh])
    rng = np.random.default_rng(order)
    lo = np.array(g["mo"], np.float32)
    span = np.array([g["nw"] * g["h"], g["ny"] * g["h"]], np.float32)
    pos = (lo - 0.05 * span + 1.1 * span * rng.random((2000, 2))).astype(
        np.float32)
    mass = (rng.random(2000) * 10.0 + 0.1).astype(np.float32)
    kernel = tmesh._kernel_hats(g["grid"], g["h"], SOFT2, g["a"],
                                torch.float32, "cpu", grid_y=g["grid_y"],
                                deconv_order=order, switch="poly4")
    fx_t, fy_t = tmesh._mesh_grids_one(_t(pos), _t(mass), g["mo"], g["h"],
                                       g["nw"], g["grid"], order, kernel,
                                       ny=g["ny"])
    fx_j, fy_j = jmesh._mesh_grids_one(
        jnp.asarray(pos), jnp.asarray(mass),
        jnp.asarray(g["mo"], jnp.float32), jnp.float32(g["h"]), g["nw"],
        g["grid"], order, tuple(jnp.asarray(k.numpy()) for k in kernel),
        ny=g["ny"])
    reach = 1 if order == 3 else 0
    shape = (g["ny"] + 1 + reach, g["nw"] + 1 + reach)
    for got, want in ((fx_t, fx_j), (fy_t, fy_j)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape == shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("reach", [0, 1])
@pytest.mark.parametrize("mesh", MESHES)
def test_fd_model_and_window_match_plain_bits(mesh, reach):
    g = _geometry(MESHES[mesh])
    src = _potential_rows(MESHES[mesh], reach)
    rows, cols = g["ny"] + 1 + reach, g["nw"] + 1 + reach
    want = tmesh._fd_gradient(_t(src), g["h"], g["nw"], g["ny"], reach)
    window = tmesh.fd_window(_t(src), g["h"], rows, cols)
    model = _fd_model(src, g["h"], rows, cols)
    for w, a, m in zip(want, window, model):
        assert tuple(w.shape) == (rows, cols)
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(w.numpy()))
        np.testing.assert_array_equal(_bits(m), _bits(w.numpy()))


def test_fd_model_on_a_slab_matches_plain_bits():
    """A sharded rank's halo-extended slab: every row of the slab an
    output row, columns wrapped across the whole padded width."""
    rng = np.random.default_rng(5)
    src = rng.standard_normal((12 + 6, 128)).astype(np.float32)
    want = tmesh.fd_window(_t(src), 0.75, 12, 65)
    for w, m in zip(want, _fd_model(src, 0.75, 12, 65)):
        np.testing.assert_array_equal(_bits(m), _bits(w.numpy()))


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same_bits(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(got.contiguous().view(torch.int32),
                       want.contiguous().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("reach", [0, 1])
@pytest.mark.parametrize("mesh", MESHES)
def test_fd_kernel_matches_plain_on_card(cuda_device, mesh, reach):
    g = _geometry(MESHES[mesh])
    src = _t(_potential_rows(MESHES[mesh], reach)).to(cuda_device)
    before = _build.LAUNCHES["fd"]
    got = tmesh._fd_gradient(src, g["h"], g["nw"], g["ny"], reach)
    assert _build.LAUNCHES["fd"] == before + 1
    want = tmesh._fd_window_ref(src, g["h"], g["ny"] + 1 + reach,
                                g["nw"] + 1 + reach)
    for a, b in zip(got, want):
        _same_bits(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,W", [(12, 65, 128), (1, 3, 6),
                                         (300, 129, 256)])
def test_fd_window_kernel_matches_plain_on_card(cuda_device, rows, cols, W):
    rng = np.random.default_rng(rows)
    src = _t(rng.standard_normal((rows + 6, W)).astype(np.float32)).to(
        cuda_device)
    before = _build.LAUNCHES["fd"]
    got = tmesh.fd_window(src, 0.75, rows, cols)
    assert _build.LAUNCHES["fd"] == before + 1
    for a, b in zip(got, tmesh._fd_window_ref(src, 0.75, rows, cols)):
        _same_bits(a, b)


@pytest.mark.cuda
def test_fd_kernel_refuses_bad_shapes_on_card(cuda_device):
    src = torch.zeros((20, 64), device=cuda_device)
    with pytest.raises(ValueError, match="potential rows"):
        tmesh.fd_window(src, 1.0, 15, 33)
    with pytest.raises(ValueError, match="potential rows"):
        tmesh.fd_window(src, 1.0, 14, 62)
    with pytest.raises(ValueError, match="contiguous"):
        tmesh.fd_window(src[:, :40], 1.0, 14, 33)
