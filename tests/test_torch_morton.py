"""Port parity: Hilbert sort keys of tpu_nbody_torch.ops.morton against
tpu_nbody.ops.morton. Integer codes of the same float32 positions must be
bit-equal, so the sort order is equal too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nbody.ops import morton as jmorton
from tpu_nbody_torch.ops import morton as tmorton

torch.set_num_threads(2)

ORIGIN = (-2.0, -802.0)   # root quad of the 2400 x 800 world
SIDE = 2404.0


def _positions(seed, n):
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 2)) * [2600.0, 1000.0] - [100.0, 100.0]
    # clusters (shared cells, long runs of equal codes) and out-of-root
    pos[: n // 4] = 1200.0 + rng.standard_normal((n // 4, 2)) * 3.0
    pos[-8:] = [[-5000.0, 0.0], [5000.0, 0.0], [0.0, -5000.0], [0.0, 5000.0],
                [1202.0, 400.0], [1202.0, -802.0], [-2.0, 400.0],
                [2402.0, 1602.0]]
    return pos.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_hilbert_codes_bit_equal(seed):
    n = 1 << 14
    pos = _positions(seed, n)
    alive = np.random.default_rng(seed + 10).random(n) > 0.1
    want = np.asarray(jmorton.hilbert_codes(jnp.asarray(pos), ORIGIN, SIDE,
                                            jnp.asarray(alive)))
    got = tmorton.hilbert_codes(torch.from_numpy(pos), ORIGIN, SIDE,
                                torch.from_numpy(alive))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[~alive] == tmorton.DEAD_CODE).all()
    # the stable argsort permutation is therefore equal as well
    np.testing.assert_array_equal(
        torch.argsort(got, stable=True).numpy(),
        np.asarray(jnp.argsort(jnp.asarray(want), stable=True)))


def test_cell_coords_and_hilbert2d_bit_equal():
    pos = _positions(2, 4096)
    ij_j = np.asarray(jmorton.cell_coords(jnp.asarray(pos), ORIGIN, SIDE))
    ij_t = tmorton.cell_coords(torch.from_numpy(pos), ORIGIN, SIDE).numpy()
    np.testing.assert_array_equal(ij_t, ij_j)
    grid = np.stack(np.meshgrid(np.arange(0, 1 << 15, 97),
                                np.arange(0, 1 << 15, 89)), -1).reshape(-1, 2)
    grid = grid.astype(np.int32)
    np.testing.assert_array_equal(
        tmorton.hilbert2d(torch.from_numpy(grid[:, 0]),
                          torch.from_numpy(grid[:, 1])).numpy(),
        np.asarray(jmorton.hilbert2d(grid[:, 0], grid[:, 1])))
