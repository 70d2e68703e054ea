"""Port parity: merge, the whole 20-step main path through Engine, and
checkpoints, against tpu_nbody on the same bodies."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nbody import checkpoint as jcheckpoint
from tpu_nbody import config as jconfig
from tpu_nbody import engine as jengine
from tpu_nbody import state as jstate
from tpu_nbody.ops import merge as jmerge
from tpu_nbody_torch import checkpoint as tcheckpoint
from tpu_nbody_torch import config as tconfig
from tpu_nbody_torch import convert
from tpu_nbody_torch import engine as tengine
from tpu_nbody_torch.ops import merge as tmerge

torch.set_num_threads(2)


def _np_state(st):
    return [np.asarray(x) for x in st]


def _overlapping_heavies(cap=512):
    """Satellites around three heavies: 0 and 2 overlap (2 is a victim of
    the lower-index 0 and must not absorb), 5 is alone, and 7 sits inside
    2's radius only (round two hands its victims to nobody but 2)."""
    rng = np.random.default_rng(9)
    pos = (rng.random((cap, 2)) * [2400.0, 800.0]).astype(np.float32)
    mass = (rng.random(cap) + 0.5).astype(np.float32)
    pos[0], pos[2], pos[5], pos[7] = [500, 400], [505, 400], [1500, 400], \
        [511, 400]
    mass[[0, 2, 5, 7]] = [50_000.0, 60_000.0, 8_000.0, 5_000.0]
    pos[10:40] = pos[0] + rng.standard_normal((30, 2)) * 4.0
    pos[40:60] = pos[5] + rng.standard_normal((20, 2)) * 5.0
    alive = np.ones(cap, bool)
    alive[[12, 45]] = False
    return pos, mass, alive


@pytest.mark.parametrize("heavy_cap", [2, 64])
def test_merge_bodies_matches_jax(heavy_cap):
    pos, mass, alive = _overlapping_heavies()
    jst = jstate.SimState(jnp.asarray(pos), jnp.zeros_like(pos),
                          jnp.asarray(np.where(alive, mass, 0)),
                          jnp.asarray(alive), jnp.int32(0))
    jparams = jconfig.Params.default()
    want, need_j = jmerge.merge_bodies(jst, jparams, heavy_cap=heavy_cap)
    tst = convert.state_from_numpy(*_np_state(jst), device="cpu")
    got, need_t = tmerge.merge_bodies(tst, tconfig.Params.default(),
                                      heavy_cap=heavy_cap)
    assert int(need_t) == int(need_j) == 4
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    np.testing.assert_allclose(got.mass.numpy(), np.asarray(want.mass),
                               rtol=1e-6)
    if heavy_cap == 64:   # the two-round case: 2 absorbed by 0, not 7
        assert not got.alive[2] and got.alive[7]


def test_merge_disabled_returns_state_and_zero_need():
    pos, mass, alive = _overlapping_heavies(64)
    tst = convert.state_from_numpy(pos, np.zeros_like(pos), mass, alive, 0,
                                   device="cpu")
    out, need = tmerge.merge_bodies(
        tst, tconfig.Params.default(merge_min_dist=0.0))
    assert int(need) == 0 and torch.equal(out.alive, tst.alive)


SLICE_CFG = dict(capacity=2048, mesh_level=10, mesh_band=64, mesh_rescue=4,
                 mesh_switch="poly4", pm_resort_every=4, mesh_chunk=2048)


def test_engine_slice_20_steps_matches_jax():
    """The port's main path against the JAX engine from the same initial
    conditions, merging on. Re-sorts of slightly different positions can
    put a few bodies in other band blocks, which is the expected source of
    drift; positions must stay within 1e-2 px in the 2400 x 800 world."""
    jeng = jengine.Engine(jconfig.SimConfig(**SLICE_CFG),
                          jconfig.Params.default(), solver="pm",
                          integrator="kdk_reuse", seed=3)
    jeng.reset_default_scene(n1=1500, n2=400)
    jeng.add_black_hole(1204.0, 400.0)         # absorbed by the disk centre
    teng = tengine.Engine(tconfig.SimConfig(**SLICE_CFG),
                          tconfig.Params.default(), solver="pm",
                          integrator="kdk_reuse", seed=3, device="cpu")
    teng.state = convert.state_from_numpy(*_np_state(jeng.state),
                                          device="cpu")
    jeng.step(20)
    teng.step(20)
    js, ts = jeng.state, teng.state
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    assert int(ts.step) == int(js.step) == 20
    assert int(ts.alive.sum()) < 1901          # merging really happened
    np.testing.assert_allclose(ts.mass.numpy(), np.asarray(js.mass),
                               rtol=1e-6)
    alive = np.asarray(js.alive)
    dpos = np.abs(ts.pos.numpy() - np.asarray(js.pos))[alive].max()
    assert dpos <= 1e-2, dpos
    assert teng.last_heavy_need == jeng.last_heavy_need
    assert teng.last_rescue_need == jeng.last_rescue_need
    assert teng.last_mesh_oob == jeng.last_mesh_oob


def test_engine_scene_api_and_retune():
    cfg = tconfig.SimConfig(**SLICE_CFG)
    eng = tengine.Engine(cfg, tconfig.Params.default(), solver="pm",
                         integrator="kdk_reuse", seed=1, merge_heavy_cap=1,
                         device="cpu")
    eng.reset_default_scene(n1=600, n2=200)
    eng.add_black_hole(300.0, 300.0)
    eng.add_kepler_disk(1800.0, 500.0, r=80.0, n=100)
    eng.add_galaxy_disk(900.0, 600.0, r=60.0, n=100)
    eng.add_cloud(50)
    before = eng.state
    assert int(before.n_alive()) == 1051
    eng.step(2)
    assert eng.last_heavy_need == 5 and eng.merge_heavy_cap >= 5
    assert before.alive.sum() == 1051          # the input state is untouched
    p, v, m = eng.get_bodies()
    assert p.shape[0] == int(eng.state.n_alive()) <= 1051
    assert np.isfinite(p).all() and np.isfinite(v).all()
    eng.compact()
    assert eng.state.alive[:p.shape[0]].all()
    s = eng.stats()
    assert int(s["n_alive"]) == p.shape[0] and np.isfinite(s["energy"])
    eng.clear()
    assert int(eng.state.n_alive()) == 0 and int(eng.state.step) == 2


def test_checkpoint_reads_jax_file(tmp_path):
    jeng = jengine.Engine(jconfig.SimConfig(capacity=256), solver="pm",
                          integrator="kdk_reuse", seed=2)
    jeng.reset_default_scene(n1=150, n2=50)
    path = tmp_path / "ck.npz"
    jparams = jconfig.Params.default(dt=0.01, theta=0.5)
    jcheckpoint.save(path, jeng.state, jparams, note=np.arange(3))
    st, params, extra = tcheckpoint.load(path, device="cpu")
    for got, want in zip(st, jeng.state):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert params == tconfig.Params.default(dt=0.01, theta=0.5)
    np.testing.assert_array_equal(extra["note"], np.arange(3))
    # and the port's file reads back in the JAX package
    path2 = tmp_path / "ck2.npz"
    tcheckpoint.save(path2, st, params)
    st2, params2, _ = jcheckpoint.load(path2)
    np.testing.assert_array_equal(np.asarray(st2.pos), st.pos.numpy())
    assert float(params2.dt) == params.dt
