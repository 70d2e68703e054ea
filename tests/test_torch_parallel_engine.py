"""ShardedEngine against tpu_nbody.parallel.engine.ShardedEngine on the
8-device CPU mesh, the same bodies on both sides (pm across reshards with
merging and a scene edit, allpairs, heavy-cap growth; bh is in
test_torch_parallel_engine_bh.py), the retune warnings of both engines,
and the card default of the new entry points."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nbody import config as jconfig
from tpu_nbody.models import scenes as jscenes
from tpu_nbody.parallel import engine as jpengine
from tpu_nbody.parallel import mesh as jmesh
from tpu_nbody_torch import config as tconfig
from tpu_nbody_torch import engine as tengine
from tpu_nbody_torch import graft_entry
from tpu_nbody_torch.examples import merger10m
from tpu_nbody_torch.parallel import engine as tpengine
from tpu_nbody_torch.parallel import mesh as tmesh
from tpu_nbody_torch.parallel.collectives import ThreadGroup

torch.set_num_threads(1)


def _cfg(**kw):
    base = dict(capacity=2048, mesh_level=9, mesh_band=64, mesh_chunk=512,
                mesh_rescue=0)
    base.update(kw)
    return base


def _pair(cfg_kw, params_kw, P=8, **kw):
    j = jpengine.ShardedEngine(jconfig.SimConfig(**cfg_kw),
                               jconfig.Params.default(**params_kw),
                               mesh=jmesh.make_mesh(P), **kw)
    t = tpengine.ShardedEngine(tconfig.SimConfig(**cfg_kw),
                               tconfig.Params.default(**params_kw),
                               mesh=tmesh.make_mesh(P, device="cpu"),
                               device="cpu", **kw)
    return j, t


def _set_both(j, t, p, v, m):
    j.set_bodies(p, v, m)
    t.set_bodies(np.array(p), np.array(v), np.array(m))


def _alive_rows(st):
    al = np.asarray(st.alive)
    r = np.concatenate([np.asarray(st.pos)[al],
                        np.asarray(st.mass)[al][:, None]], axis=1)
    return r[np.lexsort(r.T)]


def _assert_same_bodies(j, t, atol):
    assert int(t.state.n_alive()) == int(j.state.n_alive())
    a, b = _alive_rows(j.state), _alive_rows(t.state)
    np.testing.assert_allclose(b[:, 2], a[:, 2], rtol=1e-5)
    np.testing.assert_allclose(b[:, :2], a[:, :2], rtol=1e-3, atol=atol)


def test_sharded_engine_pm_multi_reshard_merging_matches_jax():
    """7 steps at reshard_every=3 (two device reshards) with merging, then
    a black hole dropped onto a light body and 2 more steps: the same
    bodies alive, masses within 1e-5, positions within 1e-3 / 2e-2 px, the
    needs equal; total mass conserved."""
    j, t = _pair(_cfg(), dict(merge_min_dist=4.0), reshard_every=3)
    p, v, m = jscenes.default_two_disk_scene(jax.random.PRNGKey(0), n1=900,
                                             n2=300)
    _set_both(j, t, p, v, m)
    m0 = float(np.asarray(m).sum())
    j.step(7)
    t.step(7)
    assert int(t.state.step) == 7 and t._steps_since_reshard == 1
    _assert_same_bodies(j, t, 2e-2)
    assert t.last_xport_need == j.last_xport_need
    assert t.last_ximport_need == j.last_ximport_need
    assert t.last_heavy_need == int(np.asarray(j.last_heavy_need))
    np.testing.assert_allclose(float(t.state.mass.sum()), m0, rtol=1e-5)
    hud = t.stats()
    assert int(hud["n_alive"]) == int(t.state.n_alive())
    assert np.isfinite(float(hud["energy"]))

    st = t.state
    light = st.alive.numpy() & (st.mass.numpy() < 100.0)
    x, y = (float(c) for c in st.pos.numpy()[light][0])
    for e in (j, t):
        e.add_black_hole(x, y)
    n_before = int(t.state.n_alive())
    j.step(2)
    t.step(2)
    assert int(t.state.n_alive()) < n_before
    _assert_same_bodies(j, t, 2e-2)


def test_sharded_engine_allpairs_matches_jax():
    """Exact ring, kdk, merging off, 3 steps (bodies reordered by the
    reshard: compared as sets)."""
    j, t = _pair(_cfg(capacity=512), dict(merge_min_dist=0.0),
                 solver="allpairs", integrator="kdk")
    p, v, m = jscenes.make_galaxy_disk(jax.random.PRNGKey(7), 400, r=250.0)
    _set_both(j, t, p, v, m)
    j.step(3)
    t.step(3)
    _assert_same_bodies(j, t, 2e-3)
    pj, vj, mj = (np.asarray(x) for x in t.get_bodies())
    assert pj.shape == (400, 2) and np.isfinite(vj).all()


def test_sharded_engine_heavy_cap_grows_as_jax():
    """40 heavies with a satellite each and heavy_cap_local=2: the block
    is redone with a grown cap, to the JAX engine's cap, and every
    satellite is absorbed."""
    j, t = _pair(_cfg(capacity=512), dict(merge_min_dist=10.0),
                 solver="allpairs", heavy_cap_local=2)
    hp = jax.random.uniform(jax.random.PRNGKey(1), (40, 2), jnp.float32,
                            300.0, 900.0)
    pos = jnp.concatenate([hp, hp + 1.0])
    mass = jnp.concatenate([jnp.full((40,), 6000.0), jnp.full((40,), 1.0)])
    _set_both(j, t, pos, jnp.zeros_like(pos), mass)
    j.step(1)
    t.step(1)
    assert t.heavy_cap_local == j.heavy_cap_local > 2
    _assert_same_bodies(j, t, 2e-3)
    al = t.state.alive.numpy()
    assert (t.state.mass.numpy()[al] > 100.0).all()


def test_engine_retune_exit_warns(monkeypatch):
    """Caps of 1 that cannot grow: the one-device retune leaves its loop
    with the lists still overflowing and says so, naming caps and needs."""
    cfg = tconfig.SimConfig(capacity=256, approx_cap=1, leaf_list_cap=1,
                            direct_body_cap=1, frontier_cap=1, group_cap=1,
                            max_depth=6)
    eng = tengine.Engine(cfg, solver="bh", device="cpu")
    eng.reset_default_scene(n1=150, n2=50)
    monkeypatch.setattr(tengine.Caps, "grown", lambda self, stats: self)
    with pytest.warns(RuntimeWarning, match="leaf_list_cap 1 < need"):
        eng.step(1)
    monkeypatch.undo()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        eng.step(1)                        # the real retune converges


@pytest.mark.parametrize("grow,rounds", [("none", 0), ("by_one", 6)])
def test_sharded_engine_redo_exit_warns(monkeypatch, grow, rounds):
    """A heavy cap that cannot reach its need: the sharded redo loop stops
    at once when the cap cannot grow, or after its 6 rounds when each
    round grows it by one, and warns, naming the cap and the need."""
    eng = tpengine.ShardedEngine(
        tconfig.SimConfig(**_cfg(capacity=512)),
        tconfig.Params.default(merge_min_dist=10.0),
        mesh=tmesh.make_mesh(4, device="cpu"), solver="allpairs",
        heavy_cap_local=1, device="cpu")
    rng = np.random.default_rng(2)
    hp = (700.0 + rng.random((20, 2)) * 40.0).astype(np.float32)
    pos = np.concatenate([hp, hp + 1.0])
    mass = np.concatenate([np.full(20, 6000.0), np.ones(20)]).astype(
        np.float32)
    eng.set_bodies(pos, np.zeros_like(pos), mass)
    caps = iter(range(2, 100))
    monkeypatch.setattr(tpengine, "_next_pow2",
                        (lambda x: 1) if grow == "none"
                        else (lambda x: next(caps)))
    with pytest.warns(RuntimeWarning,
                      match=f"after {rounds} retune rounds.*heavy_cap_local "
                            f"{1 + rounds} < need"):
        eng.step(1)
    assert eng.last_heavy_need > 1 + rounds


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.SimConfig(capacity=64)
    for call in (lambda: tpengine.ShardedEngine(cfg),
                 lambda: graft_entry.entry(),
                 lambda: graft_entry.dryrun_multichip(2),
                 lambda: merger10m.main(["--n", "2000", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with pytest.raises(ValueError, match="mesh runs on"):
        tpengine.ShardedEngine(cfg, mesh=ThreadGroup(2, "meta"),
                               device="cpu")
    with pytest.raises(ValueError, match="one axis"):
        tpengine.ShardedEngine(cfg, axis="x", device="cpu")
