"""Port parity: scene generators of tpu_nbody_torch.models.scenes against
tpu_nbody.models.scenes on the same uniform draws.

Tolerance: 1e-5 of each array's largest magnitude. Both sides are
float32, but sin/cos and the enclosed-mass cumsum round differently in the
two libraries; one ulp of a position near x = 700 px is 6e-5 px, which is
8e-6 of the offset of a body 8 px from its disk centre and enters that
body's velocity direction, so an element-wise rtol of 1e-5 does not hold
for every element."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nbody.models import scenes as jscenes
from tpu_nbody_torch.models import scenes as tscenes

torch.set_num_threads(2)


def _uniforms(seed, k, n):
    rng = np.random.default_rng(seed)
    return [rng.random(n).astype(np.float32) for _ in range(k)]


def _check(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_kepler_disk_from_uniforms():
    u = _uniforms(0, 4, 999)
    kw = dict(x=700.0, y=300.0, r=250.0, min_r=8.0, central_mass=50_000.0,
              total_satellite_mass=5_000.0, G=80.0, vx=3.0, vy=-2.0)
    want = jscenes.kepler_disk_from_uniforms(*map(jnp.asarray, u), **kw)
    got = tscenes.kepler_disk_from_uniforms(*map(torch.from_numpy, u), **kw)
    _check(got, want)


@pytest.mark.parametrize("radial_jitter,clockwise", [(0.0, True),
                                                     (0.05, False)])
def test_galaxy_disk_from_uniforms(radial_jitter, clockwise):
    u = _uniforms(1, 4, 1999)
    kw = dict(x=1200.0, y=400.0, r=300.0, min_r=8.0, central_mass=50_000.0,
              total_satellite_mass=5_000.0, G=80.0, phi0=0.3,
              radial_jitter=radial_jitter, clockwise=clockwise, vx=-50.0)
    want = jscenes.galaxy_disk_from_uniforms(
        *map(jnp.asarray, u[:3]), u_vr=jnp.asarray(u[3]), **kw)
    got = tscenes.galaxy_disk_from_uniforms(
        *map(torch.from_numpy, u[:3]), u_vr=torch.from_numpy(u[3]), **kw)
    _check(got, want)


def test_default_two_disk_scene_layout():
    g = torch.Generator().manual_seed(5)
    n1, n2 = 3000, 700
    pos, vel, mass = tscenes.default_two_disk_scene(g, n1=n1, n2=n2)
    assert pos.shape == (n1 + n2, 2) and vel.shape == (n1 + n2, 2)
    m = mass.numpy()
    assert m[0] == 50_000.0 and m[n1] == 5_000.0
    np.testing.assert_allclose(m[1:n1].sum(), 5_000.0, rtol=1e-5)
    np.testing.assert_allclose(m[n1 + 1:].sum(), 500.0, rtol=1e-5)
    np.testing.assert_allclose(pos[0].numpy(), [1200.0, 400.0])
    np.testing.assert_allclose(pos[n1].numpy(), [1200.0, 160.0])
    np.testing.assert_allclose(vel[0].numpy(), [0.0, 0.0])
    np.testing.assert_allclose(vel[n1].numpy(), [-50.0, 0.0])
    r1 = np.linalg.norm(pos[1:n1].numpy() - [1200.0, 400.0], axis=1)
    assert r1.min() > 7.0 and r1.max() < 300.0 * 1.05
    # the same generator seed gives the same scene
    again = tscenes.default_two_disk_scene(torch.Generator().manual_seed(5),
                                           n1=n1, n2=n2)
    np.testing.assert_array_equal(again[0].numpy(), pos.numpy())
