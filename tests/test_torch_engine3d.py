"""Port parity: the engine in 3D (``SimConfig(dim=3)``, solver="allpairs")
against ``tpu_nbody.engine.Engine`` on the sphere scene, the 3D checkpoint
across the packages, and the refusals of a 3D engine.

Both engines start from the same bodies (the JAX sphere scene as numpy).
Tolerances: positions within 1e-2 px and velocities within 1e-4 of the
largest speed after 5 steps (float32 on both sides, the pair sums taken in
another order); every ``stats()`` entry within 1e-4 of its scale."""

import jax
import numpy as np
import pytest
import torch

from tpu_nbody import checkpoint as jcheckpoint
from tpu_nbody import config as jconfig
from tpu_nbody import engine as jengine
from tpu_nbody.models import scenes3d as jscenes3d
from tpu_nbody_torch import checkpoint as tcheckpoint
from tpu_nbody_torch import config as tconfig
from tpu_nbody_torch import engine as tengine
from tpu_nbody_torch import state as tstate
from tpu_nbody_torch.ops import diagnostics as tdiagnostics

torch.set_num_threads(2)

CAP = 256
INTEGRATORS = ("euler", "kdk", "kdk_reuse")


def _sphere(n, **kw):
    return [np.array(x) for x in
            jscenes3d.generate_sphere(jax.random.PRNGKey(1), n, **kw)]


def _engines(integrator, bodies, **params):
    kw = dict(solver="allpairs", integrator=integrator)
    jeng = jengine.Engine(jconfig.SimConfig(capacity=CAP, dim=3),
                          jconfig.Params.default(**params), **kw)
    teng = tengine.Engine(tconfig.SimConfig(capacity=CAP, dim=3),
                          tconfig.Params.default(**params), device="cpu",
                          **kw)
    jeng.set_bodies(*bodies)
    teng.set_bodies(*bodies)
    return jeng, teng


def _check_states(ts, js):
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    assert int(ts.step) == int(js.step)
    assert ts.pos.shape == ts.vel.shape == (CAP, 3)
    alive = np.asarray(js.alive)
    np.testing.assert_allclose(ts.mass.numpy(), np.asarray(js.mass),
                               rtol=1e-6)
    dpos = np.abs(ts.pos.numpy() - np.asarray(js.pos))[alive].max()
    assert dpos <= 1e-2, dpos
    jv = np.asarray(js.vel)[alive]
    dvel = np.abs(ts.vel.numpy()[alive] - jv).max()
    assert dvel <= 1e-4 * np.abs(jv).max(), dvel


def _check_stats(teng, jeng):
    """Every ``stats()`` entry within 1e-4 of its scale: its own largest
    magnitude, or for the two sums that cancel (momentum and L_z, where
    the 5e6 centre balances the satellites) the sum of their terms'
    magnitudes."""
    tstats, jstats = teng.stats(), jeng.stats()
    assert set(tstats) == set(jstats)
    assert tstats["com"].shape == tstats["momentum"].shape == (3,)
    st = teng.state
    r = st.pos - tdiagnostics.center_of_mass(st)
    speed = st.vel.norm(dim=-1)
    terms = {"momentum": float((st.mass * speed).sum()),
             "angular_momentum_z": float((st.mass * r.norm(dim=-1)
                                          * speed).sum())}
    for k, want in jstats.items():
        want = np.asarray(want)
        scale = terms.get(k, np.abs(want).max())
        np.testing.assert_allclose(tstats[k], want, rtol=0,
                                   atol=1e-4 * scale + 1e-6, err_msg=k)


@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_engine3d_5_steps_matches_jax(integrator):
    """The demo's physics: merging off, 255 satellites + the centre."""
    jeng, teng = _engines(integrator, _sphere(CAP - 1), merge_min_dist=0.0)
    _check_stats(teng, jeng)
    jeng.step(5)
    teng.step(5)
    assert int(teng.state.step) == 5
    assert int(teng.state.n_alive()) == CAP
    _check_states(teng.state, jeng.state)
    _check_stats(teng, jeng)
    moved = (teng.state.pos - torch.as_tensor(_sphere(CAP - 1)[0])).abs()
    assert float(moved[:, 2].max()) > 1.0        # z really moves


@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_engine3d_merge_matches_jax(integrator):
    """Merging on in a small ball (r_max 45 px), so the 5e6 centre absorbs
    the satellites that come within 8 px in 3D; 200 bodies, so add_bodies
    has free slots to fill."""
    bodies = _sphere(199, w=100.0, h=100.0, speed_const=3000.0)
    jeng, teng = _engines(integrator, bodies)
    extra = [np.array([[50.0, 50.0, 20.0]], np.float32),
             np.array([[5.0, 0.0, 0.0]], np.float32),
             np.array([2.0], np.float32)]
    jeng.add_bodies(*extra)
    teng.add_bodies(*extra)
    jeng.step(5)
    teng.step(5)
    assert int(teng.state.n_alive()) < 201       # merging really happened
    assert teng.last_heavy_need == jeng.last_heavy_need == 1
    _check_states(teng.state, jeng.state)
    jeng.compact()
    teng.compact()
    _check_states(teng.state, jeng.state)
    for got, want in zip(teng.get_bodies(), jeng.get_bodies()):
        assert got.shape == want.shape
    _check_stats(teng, jeng)


def test_add_bodies_beyond_the_free_slots_keeps_the_live_ones():
    """More bodies than free slots, no more than the capacity: the free
    slots are filled in order, the rest is dropped and no live body is
    overwritten, as in the JAX package (all values equal bit for bit)."""
    jeng, teng = _engines("euler", _sphere(199))        # 200 live, 56 free
    before = [x.clone() for x in teng.state[:3]]
    extra = _sphere(99, w=500.0, central_mass=7.0)      # 100 bodies
    jeng.add_bodies(*extra)
    teng.add_bodies(*extra)
    st = teng.state
    assert int(st.n_alive()) == CAP
    for got, old in zip(st[:3], before):
        assert torch.equal(got[:200], old[:200])
    for got, new in zip(st[:3], extra):
        np.testing.assert_array_equal(got[200:].numpy(), new[:56])
    for got, want in zip(st[:4], jeng.state[:4]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_angular_momentum_is_the_z_component():
    pos, vel, mass = map(torch.as_tensor, _sphere(100))
    st = tstate.from_arrays(pos, vel, mass, device="cpu")
    com = (mass[:, None] * pos).sum(0) / mass.sum()
    L = (mass[:, None] * torch.linalg.cross(pos - com, vel)).sum(0)
    got = float(tdiagnostics.angular_momentum_z(st))
    assert got == pytest.approx(float(L[2]), rel=1e-4)


def test_checkpoint3d_round_trip_across_packages(tmp_path):
    """A 3D state saved by either package loads into the other and steps on
    to the same place."""
    jeng, teng = _engines("euler", _sphere(CAP - 1), merge_min_dist=0.0)
    jeng.step(2)
    jpath, tpath = tmp_path / "j.npz", tmp_path / "t.npz"
    jcheckpoint.save(jpath, jeng.state, jeng.params, tag=np.arange(3))
    state, params, extra = tcheckpoint.load(jpath, device="cpu")
    assert state.pos.shape == (CAP, 3) and int(state.step) == 2
    np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jeng.state.pos))
    np.testing.assert_array_equal(extra["tag"], np.arange(3))
    assert params == tconfig.Params.default(merge_min_dist=0.0)
    teng.state, teng.params = state, params
    teng.step(3)
    jeng.step(3)
    _check_states(teng.state, jeng.state)
    tcheckpoint.save(tpath, teng.state, teng.params)
    jstate, jparams, _ = jcheckpoint.load(tpath)
    assert jstate.pos.shape == (CAP, 3) and int(jstate.step) == 5
    np.testing.assert_array_equal(np.asarray(jstate.vel),
                                  teng.state.vel.numpy())
    assert float(jparams.merge_min_dist) == 0.0


@pytest.mark.parametrize("method,args", [
    ("reset_default_scene", ()), ("add_galaxy_disk", (10.0, 10.0)),
    ("add_kepler_disk", (10.0, 10.0)), ("add_cloud", ()),
    ("add_black_hole", (10.0, 10.0)), ("tree_boxes", ()),
])
def test_engine3d_refuses_2d_scene_methods(method, args):
    eng = tengine.Engine(tconfig.SimConfig(capacity=64, dim=3),
                         solver="allpairs", device="cpu")
    with pytest.raises(ValueError, match="2D"):
        getattr(eng, method)(*args)
    assert int(eng.state.n_alive()) == 0


@pytest.mark.parametrize("solver", ["bh", "pm"])
def test_engine3d_refuses_2d_solvers(solver):
    with pytest.raises(ValueError, match="dim=3"):
        tengine.Engine(tconfig.SimConfig(capacity=64, dim=3), solver=solver,
                       device="cpu")


def test_engine3d_clear_and_capacity():
    eng = tengine.Engine(tconfig.SimConfig(capacity=64, dim=3),
                         solver="allpairs", device="cpu")
    eng.set_bodies(*_sphere(40))
    assert int(eng.state.n_alive()) == 41 and eng.state.dim == 3
    eng.clear()
    assert int(eng.state.n_alive()) == 0 and eng.state.pos.shape == (64, 3)
    with pytest.raises(ValueError, match="capacity"):
        eng.set_bodies(*_sphere(64))
    # more new bodies than slots: the first 64 land, the rest are dropped
    eng.add_bodies(*_sphere(99))
    assert int(eng.state.n_alive()) == 64
    np.testing.assert_array_equal(eng.state.pos.numpy(), _sphere(99)[0][:64])
