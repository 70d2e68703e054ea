"""Port parity: all-pairs forces of tpu_nbody_torch.ops.forces against
tpu_nbody.ops.forces, the Pallas kernel included (interpret mode, as
tests/test_forces.py runs it).

Tolerance: 1e-5 of the largest magnitude. Both sides are float32 sums of
the same pair terms in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nbody.ops import forces as jforces
from tpu_nbody_torch.ops import forces as tforces

torch.set_num_threads(2)

G, SOFT2 = 80.0, 1.0


def _bodies(seed, n, dim=2):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, dim)) * 1000.0).astype(np.float32)
    mass = (rng.random(n) * 10.0 + 0.1).astype(np.float32)
    return pos, mass


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_ref_matches_pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl
    real_call = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return real_call(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    pos, mass = _bodies(0, 600)
    want = jforces.accel_allpairs(jnp.asarray(pos), jnp.asarray(mass), G,
                                  SOFT2, implementation="pallas")
    got = tforces.accel_allpairs_ref(torch.from_numpy(pos),
                                     torch.from_numpy(mass), G, SOFT2)
    _close(got, want)


def test_ref_matches_xla_3d():
    pos, mass = _bodies(1, 300, dim=3)
    want = jforces.accel_allpairs(jnp.asarray(pos), jnp.asarray(mass), G,
                                  SOFT2, implementation="xla")
    got = tforces.accel_allpairs(torch.from_numpy(pos),
                                 torch.from_numpy(mass), G, SOFT2)
    _close(got, want)


@pytest.mark.parametrize("dim", [2, 3])
def test_separate_targets_equal_rows(dim):
    pos, mass = _bodies(2, 700, dim)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    full = tforces.accel_allpairs(p, m, G, SOFT2)
    rows = torch.tensor([0, 5, 123, 699, 350])
    part = tforces.accel_allpairs(p, m, G, SOFT2, targets=p[rows])
    torch.testing.assert_close(part, full[rows], rtol=1e-6, atol=1e-6)


def test_dead_bodies_force_neutral():
    pos, mass = _bodies(3, 64)
    mass2 = mass.copy()
    mass2[32:] = 0.0
    p = torch.from_numpy(pos)
    a_live = tforces.accel_allpairs(p[:32], torch.from_numpy(mass[:32]), G,
                                    SOFT2)
    a_mask = tforces.accel_allpairs(p, torch.from_numpy(mass2), G, SOFT2)
    torch.testing.assert_close(a_mask[:32], a_live, rtol=1e-6, atol=1e-6)


def test_potential_energy_matches_jax():
    pos, mass = _bodies(4, 500)
    want = float(jforces.potential_energy(jnp.asarray(pos),
                                          jnp.asarray(mass), G, SOFT2))
    got = float(tforces.potential_energy(torch.from_numpy(pos),
                                         torch.from_numpy(mass), G, SOFT2))
    np.testing.assert_allclose(got, want, rtol=1e-5)
