"""Port parity: the 3D scene generators of tpu_nbody_torch.models.scenes3d
against tpu_nbody.models.scenes3d on the same uniform draws.

The JAX generators take a key; the uniforms they draw from it are drawn
here with the same key splits (``scenes3d.py:30,59``, ``scenes.py:173``)
and handed to the port's ``*_from_uniforms`` functions.

Tolerance: 1e-5 of each array's largest magnitude, as for the 2D scenes.
torch has no ``cbrt``, so the sphere's radii come from ``pow(u, 1/3)`` and
differ from the JAX package's in the last bits (a relative 2e-7); sin, cos
and the enclosed-mass cumsum round differently in the two libraries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nbody.models import scenes3d as jscenes3d
from tpu_nbody_torch.models import scenes3d as tscenes3d

torch.set_num_threads(2)


def _split_uniforms(key, k, n):
    """The (n,) float32 uniforms the JAX generators draw from ``key``
    split ``k`` ways, as numpy."""
    return [np.array(jax.random.uniform(sub, (n,), jnp.float32))
            for sub in jax.random.split(key, k)]


def _check(got, want, vel_tol=1e-5):
    assert len(got) == len(want) == 3
    for g, w, tol in zip(got, want, (1e-5, vel_tol, 1e-5)):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=tol * np.abs(w).max())


@pytest.mark.parametrize("kw", [{}, dict(w=800.0, h=600.0,
                                         central_mass=1e4, speed_const=5e3)],
                         ids=["demo", "small-world"])
def test_sphere_from_uniforms(kw):
    n = 20_000
    key = jax.random.PRNGKey(1)
    want = jscenes3d.generate_sphere(key, n, **kw)
    u = _split_uniforms(key, 3, n)
    near_pole = np.abs(u[1] * np.float32(2.0) - np.float32(1.0)) > 0.99
    assert 50 < near_pole.sum() < n // 10     # both axis branches are taken
    got = tscenes3d.sphere_from_uniforms(*map(torch.from_numpy, u), **kw)
    _check(got, want)
    pos, vel, mass = got
    assert pos.shape == (n + 1, 3)
    assert float(mass[-1]) == kw.get("central_mass", 5e6)
    assert not vel[-1].any()
    # velocities are tangential: v . (p - c) = 0 within rounding
    d = (pos[:-1] - pos[-1]).double()
    dots = (d * vel[:-1].double()).sum(-1)
    scale = d.norm(dim=-1) * vel[:-1].double().norm(dim=-1)
    assert float((dots.abs() / scale).max()) < 1e-5


def test_sphere_pole_axis_branch():
    """|z| just below, at and above 0.99 picks the JAX package's axis."""
    z = np.array([0.9899999, 0.99, 0.9900001, -0.99, -0.9900001, 0.0, 1.0,
                  -1.0], np.float32)
    u_z = ((z.astype(np.float64) + 1.0) / 2.0).astype(np.float32)
    u_r = np.linspace(0.1, 0.9, z.size).astype(np.float32)
    u_phi = np.linspace(0.05, 0.95, z.size).astype(np.float32)
    pos, vel, _ = tscenes3d.sphere_from_uniforms(
        *map(torch.from_numpy, (u_r, u_z, u_phi)))
    zz = u_z * np.float32(2.0) - np.float32(1.0)
    pole = np.abs(zz) > 0.99
    assert pole.any() and not pole.all()
    # cross(rdir, e_x) has no x component; cross(rdir, e_y) no y component
    v = vel[:-1].numpy()
    assert (v[pole, 0] == 0).all() and (v[~pole, 1] == 0).all()
    assert np.isfinite(v).all()


def test_disk3d_from_uniforms():
    n = 5_000
    key = jax.random.PRNGKey(7)
    want = jscenes3d.generate_disk3d(key, n)
    got = tscenes3d.disk3d_from_uniforms(
        *map(torch.from_numpy, _split_uniforms(key, 4, n)))
    _check(got, want)
    assert float(got[0][:, 2].min()) >= 1.0 and float(got[2].min()) >= 1.0


@pytest.mark.parametrize("kw", [{}, dict(x=900.0, y=500.0, r=150.0, vx=4.0,
                                         clockwise=False)],
                         ids=["defaults", "placed"])
def test_galaxy_disk3d_from_uniforms(kw):
    """Velocities within 5e-4 of the largest speed: the innermost orbits
    are 2 px (``GPU_MIN_R``) from a centre near x = 1720 px, where one ulp
    of a position (1.2e-4 px) is 6e-5 of the offset that sets the
    velocity's direction, and both packages round it."""
    n = 3_000
    key = jax.random.PRNGKey(11)
    want = jscenes3d.make_galaxy_disk3d(key, n, **kw)
    u = _split_uniforms(key, 4, n - 1)
    got = tscenes3d.galaxy_disk3d_from_uniforms(
        *map(torch.from_numpy, u[:3]), **kw)
    _check(got, want, vel_tol=5e-4)
    assert not got[0][:, 2].any() and not got[1][:, 2].any()


@pytest.mark.parametrize("name,n_out", [("generate_sphere", 1001),
                                        ("generate_disk3d", 1000),
                                        ("make_galaxy_disk3d", 1000)])
def test_generators_draw_on_the_generators_device(name, n_out):
    fn = getattr(tscenes3d, name)
    pos, vel, mass = fn(torch.Generator().manual_seed(2), 1000)
    assert pos.shape == vel.shape == (n_out, 3) and mass.shape == (n_out,)
    assert pos.device.type == "cpu" and torch.isfinite(pos).all()
    again = fn(torch.Generator().manual_seed(2), 1000)
    assert torch.equal(again[0], pos) and torch.equal(again[1], vel)
