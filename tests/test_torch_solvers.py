"""Port parity: the engine's solvers and integrators beyond the main path
(solver="allpairs"; kdk, kdk_reuse and euler; pm without persistent sort;
F_long subcycling and heavy-direct), the step function's guards, the
sampled exact force error, and the numpy oracle's integrator and merge
cases of tests/test_integrate.py and tests/test_merge.py.

Trajectories start from the same bodies in both packages, merging on, and
must stay within 1e-2 px after 20 steps with equal alive masks and stats
(the pattern of tests/test_torch_engine.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import oracle
from tpu_nbody import config as jconfig
from tpu_nbody import engine as jengine
from tpu_nbody.ops import forces as jforces
from tpu_nbody_torch import accuracy
from tpu_nbody_torch import config as tconfig
from tpu_nbody_torch import convert
from tpu_nbody_torch import engine as tengine
from tpu_nbody_torch import state as tstate
from tpu_nbody_torch.ops import integrate as tintegrate
from tpu_nbody_torch.ops import merge as tmerge

torch.set_num_threads(2)

BASE = dict(capacity=1024, mesh_level=8, mesh_band=32, mesh_rescue=4,
            mesh_switch="poly4", pm_resort_every=4, mesh_chunk=1024)


@pytest.mark.parametrize("solver,integrator,cfg", [
    ("allpairs", "kdk", {}), ("allpairs", "kdk_reuse", {}),
    ("allpairs", "euler", {}), ("pm", "kdk", dict(mesh_rescue=32)),
    ("pm", "euler", dict(mesh_rescue=32, mesh_order=1)),
    ("pm", "kdk_reuse", dict(pm_persistent_sort=False, mesh_order=3)),
    ("pm", "kdk_reuse", dict(pm_mesh_every=2, pm_heavy_cap=2)),
    ("pm", "kdk_reuse", dict(pm_mesh_every=2, pm_heavy_cap=2,
                             pm_mesh_extrapolate=True,
                             mesh_interlace=True)),
    ("pm", "kdk_reuse", dict(pm_heavy_cap=2, mesh_rescue_hot=8)),
], ids=lambda x: (x if isinstance(x, str) else
                  "-".join(f"{k}={v}" for k, v in x.items()) or "base"))
def test_engine_20_steps_matches_jax(solver, integrator, cfg):
    """Two step(10) calls, so the subcycled mesh phase restarts at 0 in
    the second call as in the JAX scan. pm with kdk or euler sorts before
    each of its force passes; there rescue k=32 covers every partner block
    (need <= k), so a sort that puts a body in the next band block, as
    positions an ulp apart can, does not change its short-range force."""
    kw = dict(solver=solver, integrator=integrator, seed=3)
    jeng = jengine.Engine(jconfig.SimConfig(**dict(BASE, **cfg)),
                          jconfig.Params.default(), **kw)
    jeng.reset_default_scene(n1=600, n2=200)
    jeng.add_black_hole(1204.0, 400.0)         # absorbed by the disk centre
    teng = tengine.Engine(tconfig.SimConfig(**dict(BASE, **cfg)),
                          tconfig.Params.default(), device="cpu", **kw)
    teng.state = convert.state_from_numpy(
        *[np.asarray(x) for x in jeng.state], device="cpu")
    for _ in range(2):
        jeng.step(10)
        teng.step(10)
    js, ts = jeng.state, teng.state
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    assert int(ts.step) == int(js.step) == 20
    assert int(ts.alive.sum()) < 801           # merging really happened
    np.testing.assert_allclose(ts.mass.numpy(), np.asarray(js.mass),
                               rtol=1e-6)
    alive = np.asarray(js.alive)
    dpos = np.abs(ts.pos.numpy() - np.asarray(js.pos))[alive].max()
    assert dpos <= 1e-2, dpos
    for key in ("heavy_need", "rescue_need", "rescue_hot", "mesh_oob"):
        assert getattr(teng, f"last_{key}") == getattr(jeng, f"last_{key}")


@pytest.mark.parametrize("kw,err", [
    (dict(cfg=dict(pm_mesh_every=2)), (ValueError, "pm_heavy_cap")),
    (dict(cfg=dict(pm_mesh_every=2, pm_heavy_cap=2), integrator="kdk"),
     (ValueError, "kdk_reuse")),
    (dict(cfg=dict(pm_mesh_every=2, pm_heavy_cap=2,
                   pm_persistent_sort=False)), (ValueError, "kdk_reuse")),
    (dict(strict_parity=True), (ValueError, "strict_parity")),
    (dict(strict_parity=True, solver="allpairs"), (ValueError, "bh")),
    (dict(solver="allpairs", allpairs_impl="xla"), (ValueError, "xla")),
    (dict(allpairs_impl="triton"), (ValueError, "allpairs_impl")),
    (dict(solver="bh"), None),
    (dict(solver="bh", strict_parity=True), None),
    (dict(cfg=dict(dim=3)), (ValueError, "dim=3")),
    (dict(cfg=dict(dim=3), solver="bh", integrator="kdk"),
     (ValueError, "dim=3")),
    (dict(cfg=dict(dim=4), solver="allpairs"), (ValueError, "dim=4")),
    (dict(integrator="leapfrog"), (ValueError, "integrator")),
    (dict(cfg=dict(mesh_order=4)), (ValueError, "order")),
], ids=str)
def test_engine_refusals(kw, err):
    """Each case beside the P3M main path's solver and integrator. The
    Barnes-Hut cases, refused until it was ported, construct and step."""
    kw = dict(dict(solver="pm", integrator="kdk_reuse"), **kw)
    cfg = tconfig.SimConfig(**dict(BASE, capacity=256), **kw.pop("cfg", {}))
    if err is None:
        eng = tengine.Engine(cfg, device="cpu", **kw)
        eng.reset_default_scene(n1=150, n2=50)
        eng.step(1)
        assert eng.last_stats.group_need > 0
        assert torch.isfinite(eng.state.pos).all()
        return
    with pytest.raises(err[0], match=err[1]):
        tengine.Engine(cfg, device="cpu", **kw).step(1)


def _accel(pos, mass, alive, params):
    return tengine.make_allpairs_accel()(pos, mass, alive, params)[0]


def test_allpairs_accel_zeroes_dead_sources_only():
    """Dead slots exert no force but still receive one, as in JAX."""
    rng = np.random.default_rng(2)
    pos = (rng.random((64, 2)) * 300).astype(np.float32)
    mass = (rng.random(64) + 0.5).astype(np.float32)
    alive = np.arange(64) < 40
    params = tconfig.Params.default()
    got = _accel(torch.from_numpy(pos), torch.from_numpy(mass),
                 torch.from_numpy(alive), params)
    want = jengine.make_allpairs_accel()(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(alive),
        jconfig.Params.default())[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
    assert (got[40:] != 0).any()


def test_exact_sampled_matches_jax_rows():
    rng = np.random.default_rng(3)
    pos = (rng.random((3000, 2)) * 1000).astype(np.float32)
    mass = (rng.random(3000) * 10).astype(np.float32)
    mass[2500:] = 0.0
    sel = np.sort(rng.choice(3000, 300, replace=False))
    want = np.asarray(jforces.accel_allpairs(
        jnp.asarray(pos), jnp.asarray(mass), 80.0, 1.0))[sel]
    p = torch.from_numpy(pos)
    got = accuracy.exact_sampled(p[sel], p, torch.from_numpy(mass), 80.0,
                                 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_sampled_force_error_knobs():
    """The accuracy label on a small scene: finite, every sample drawn
    from alive bodies, NGP worse than CIC, and knobs passed through."""
    cfg = tconfig.SimConfig(**dict(BASE, capacity=4096, mesh_level=9))
    eng = tengine.Engine(cfg, solver="pm", device="cpu", seed=4)
    eng.reset_default_scene(n1=3000, n2=800)
    g = torch.Generator().manual_seed(0)
    cic = accuracy.sampled_force_error(eng.state, cfg, eng.params, 256, g)
    ngp = accuracy.sampled_force_error(
        (eng.state.pos, eng.state.mass, eng.state.alive), cfg, eng.params,
        256, g, order=1)
    hot = accuracy.sampled_force_error(eng.state, cfg, eng.params, 5000, g,
                                       rescue_k=2, rescue_k_hot=8)
    assert cic["samples"] == 256 and hot["samples"] == 3800
    for e in (cic, ngp, hot):
        assert 0 < e["p50"] <= e["p99"] <= e["max"] and np.isfinite(e["max"])
    assert ngp["mean"] > cic["mean"]
    assert hot["rescue_hot"] > 0 and hot["rescue_need"] > 2


# -- the numpy oracle's cases (tests/test_integrate.py, tests/test_merge.py)


def _two_body():
    """Circular softened binary: m1 = m2 = 1, separation 10, G = 80."""
    G, soft2, d = 80.0, 1.0, 10.0
    a = G / (d * d + soft2) * (d / np.sqrt(d * d + soft2))
    v = np.sqrt(a * d / 2)
    pos = np.array([[-d / 2, 0.0], [d / 2, 0.0]], np.float32)
    vel = np.array([[0.0, -v], [0.0, v]], np.float32)
    return pos, vel, np.ones(2, np.float32)


def _state(pos, vel, mass):
    return tstate.from_arrays(np.asarray(pos, np.float32),
                              np.asarray(vel, np.float32),
                              np.asarray(mass, np.float32), device="cpu")


def test_kdk_matches_oracle_trajectory(rng):
    n = 32
    pos = rng.random((n, 2)) * 200 + 1100
    vel = rng.standard_normal((n, 2)) * 2
    mass = rng.random(n) + 0.5
    params = tconfig.Params.default(merge_min_dist=0.0)
    s = _state(pos, vel, mass)
    opos, ovel = pos.copy(), vel.copy()
    for _ in range(20):
        s = tintegrate.kdk_step(s, params, _accel)
        opos, ovel = oracle.kdk_step(
            opos, ovel, mass, 0.005,
            lambda p, m: oracle.exact_accel(p, m, 80.0, 1.0))
    np.testing.assert_allclose(s.pos.numpy(), opos, rtol=1e-3, atol=2e-2)


def test_kdk_reuse_matches_kdk_without_merge():
    params = tconfig.Params.default(dt=0.01, merge_min_dist=0.0)
    s_lit = s_re = _state(*_two_body())
    acc = _accel(s_re.pos, s_re.mass, s_re.alive, params)
    for _ in range(20):
        s_lit = tintegrate.kdk_step(s_lit, params, _accel)
        s_re, acc = tintegrate.kdk_reuse_step(s_re, acc, params, _accel)
    np.testing.assert_allclose(s_lit.pos.numpy(), s_re.pos.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_time_reversal():
    pos, vel, mass = _two_body()
    params = tconfig.Params.default(dt=0.01, merge_min_dist=0.0)
    s = _state(pos, vel, mass)
    for p in (params, params.replace(dt=-0.01)):
        for _ in range(25):
            s = tintegrate.kdk_step(s, p, _accel)
    np.testing.assert_allclose(s.pos.numpy(), pos, atol=1e-2)


def test_euler_step_semantics():
    """Semi-implicit Euler: v' = v + a dt, x' = x + v' dt (GPU.kt:147-148)."""
    pos = np.array([[0.0, 0.0], [10.0, 0.0]], np.float32)
    vel = np.array([[0.0, 1.0], [0.0, -1.0]], np.float32)
    params = tconfig.Params.default(dt=0.25, merge_min_dist=0.0)
    s = _state(pos, vel, np.ones(2))
    a = _accel(s.pos, s.mass, s.alive, params).numpy()
    s2 = tintegrate.euler_step(s, params, _accel)
    vexp = vel + a * 0.25
    np.testing.assert_allclose(s2.vel.numpy(), vexp, rtol=1e-6)
    np.testing.assert_allclose(s2.pos.numpy(), pos + vexp * 0.25, rtol=1e-6)


def _merged(pos, vel, mass):
    out, _ = tmerge.merge_bodies(_state(pos, vel, mass),
                                 tconfig.Params.default())
    kept = np.flatnonzero(out.alive.numpy())
    return kept, out.mass.numpy()[kept]


def test_merge_matches_sequential_oracle(rng):
    """Random clustered configs against the literal sequential rule, the
    heavies kept more than 8 px apart (the documented deviation needs
    three heavies within 8 px of each other)."""
    for trial in range(10):
        n = 40
        pos = rng.random((n, 2)) * 60.0
        vel = rng.standard_normal((n, 2))
        mass = rng.random(n) * 100.0
        heavy = rng.choice(n, size=3, replace=False)
        mass[heavy] = 5000.0 + rng.random(3) * 1000
        pos[heavy] = [[10.0, 10.0], [30.0, 30.0], [50.0, 10.0]]
        _, _, omass, okept = oracle.merge_sequential(
            pos.copy(), vel.copy(), mass.copy(), 4000.0, 8.0)
        kept, kmass = _merged(pos, vel, mass)
        assert kept.tolist() == okept.tolist(), f"trial {trial}"
        np.testing.assert_allclose(kmass, omass, rtol=1e-5)


def test_merge_overlapping_heavy_pair_with_satellites():
    pos = np.array([[0.0, 0.0], [4.0, 0.0], [2.0, 3.0], [100.0, 0.0]])
    mass = np.array([5000.0, 7000.0, 5.0, 5.0])
    _, _, omass, okept = oracle.merge_sequential(
        pos.copy(), np.zeros_like(pos), mass.copy(), 4000.0, 8.0)
    kept, kmass = _merged(pos, np.zeros_like(pos), mass)
    assert kept.tolist() == okept.tolist()
    np.testing.assert_allclose(kmass, omass, rtol=1e-5)
