"""Port parity: the engine's Barnes–Hut solver (kdk and kdk_reuse, cap
retune, tighten_caps, strict_parity, tree_boxes, Caps) against
tpu_nbody.engine on the same bodies, and the sampled force error of every
solver."""

import numpy as np
import pytest
import torch

from tpu_nbody import config as jconfig
from tpu_nbody import engine as jengine
from tpu_nbody.ops import traverse as jtraverse
from tpu_nbody_torch import accuracy
from tpu_nbody_torch import config as tconfig
from tpu_nbody_torch import convert
from tpu_nbody_torch import engine as tengine
from tpu_nbody_torch.ops import traverse as ttraverse

torch.set_num_threads(2)

# the caps of tests/test_engine.py; group_cap 16 keeps the padded pair
# blocks small (the scenes here form 8 to 10 groups)
SMALL = dict(max_depth=7, group_chunk=16, approx_cap=1024,
             direct_body_cap=2048, frontier_cap=512, leaf_list_cap=256,
             group_cap=16)


def _engines(cfg_kw, n1, n2, params_kw=None, **kw):
    """The two engines on the JAX engine's scene."""
    params_kw = params_kw or {}
    jeng = jengine.Engine(jconfig.SimConfig(**cfg_kw),
                          jconfig.Params.default(**params_kw), **kw)
    jeng.reset_default_scene(n1=n1, n2=n2)
    teng = tengine.Engine(tconfig.SimConfig(**cfg_kw),
                          tconfig.Params.default(**params_kw), device="cpu",
                          **kw)
    teng.state = convert.state_from_numpy(
        *[np.asarray(x) for x in jeng.state], device="cpu")
    return jeng, teng


def _host_needs(st):
    return {f: int(getattr(st, f)) for f in st._fields if f != "cand_need"}


@pytest.mark.parametrize("integrator,traversal", [
    ("kdk", "auto"), ("kdk_reuse", "auto"), ("kdk_reuse", "hier"),
    ("euler", "bfs")])
def test_bh_engine_5_steps_matches_jax(integrator, traversal):
    """Merging on (a black hole dropped on the disk centre is absorbed).
    Positions within 1e-2 px of the JAX engine after 5 steps; alive masks,
    needs and caps equal."""
    cfg = dict(capacity=2048, bh_traversal=traversal,
               bh_hier_sizes=(8, 2), bh_hier_cand_caps=(1024, 512), **SMALL)
    jeng, teng = _engines(cfg, 1200, 400, solver="bh", integrator=integrator,
                          seed=3)
    for eng in (jeng, teng):
        eng.add_black_hole(1204.0, 400.0)
    jeng.step(5)
    teng.step(5)
    js, ts = jeng.state, teng.state
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    assert int(ts.step) == int(js.step) == 5
    assert int(ts.alive.sum()) < 1601             # merging really happened
    np.testing.assert_allclose(ts.mass.numpy(), np.asarray(js.mass),
                               rtol=1e-6)
    alive = np.asarray(js.alive)
    dpos = np.abs(ts.pos.numpy() - np.asarray(js.pos))[alive].max()
    assert dpos <= 1e-2, dpos
    assert _host_needs(teng.last_stats) == _host_needs(jeng.last_stats)
    if traversal == "hier":
        assert list(teng.last_stats.cand_need) == \
            np.asarray(jeng.last_stats.cand_need).tolist()
    assert teng.caps.as_dict() == jeng.caps.as_dict()
    assert teng.last_heavy_need == jeng.last_heavy_need


def test_defaults_are_the_jax_engines():
    eng = tengine.Engine(tconfig.SimConfig(capacity=256, **SMALL),
                         device="cpu")
    jeng = jengine.Engine(jconfig.SimConfig(capacity=256, **SMALL))
    assert (eng.solver, eng.integrator) == (jeng.solver, jeng.integrator) \
        == ("bh", "kdk")
    assert eng.strict_parity is False and eng.last_stats is None
    assert eng.caps.as_dict() == jeng.caps.as_dict()
    eng.reset_default_scene(n1=150, n2=50)
    eng.step(1)
    assert eng.last_stats.group_need > 0
    assert torch.isfinite(eng.state.pos).all()


def test_bh_config_defaults_match_jax():
    fields = ("leaf_size", "max_depth", "node_capacity", "group_size",
              "group_cap", "approx_cap", "leaf_list_cap", "direct_body_cap",
              "frontier_cap", "group_chunk", "bh_traversal", "bh_hier_sizes",
              "bh_hier_cand_caps", "bh_hier_batch", "num_nodes", "num_groups")
    for kw in (dict(capacity=1 << 20), dict(capacity=100, leaf_size=4),
               dict(capacity=5000, node_capacity=77, group_cap=9)):
        j, t = jconfig.SimConfig(**kw), tconfig.SimConfig(**kw)
        assert [getattr(t, f) for f in fields] == \
            [getattr(j, f) for f in fields]
    assert not hasattr(tconfig.SimConfig(capacity=8), "bh_stream_split")


def test_step_stream_matches_step():
    cfg = tconfig.SimConfig(capacity=512, **SMALL)
    a = tengine.Engine(cfg, solver="bh", integrator="kdk_reuse", seed=5,
                       device="cpu")
    b = tengine.Engine(cfg, solver="bh", integrator="kdk_reuse", seed=5,
                       device="cpu")
    a.reset_default_scene(n1=300, n2=100)
    b.reset_default_scene(n1=300, n2=100)
    a.step(4)
    b.step_stream(4)
    assert int(b.state.step) == 4
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)
    assert a.last_stats == b.last_stats


def test_cap_auto_retune():
    """Undersized caps grow until the recorded needs fit, to the caps the
    JAX engine reaches, and the step is redone from the pre-run state."""
    cfg = dict(capacity=1024, max_depth=7, group_chunk=16, approx_cap=64,
               direct_body_cap=64, frontier_cap=64, leaf_list_cap=16,
               group_cap=16)
    jeng, teng = _engines(cfg, 600, 200, solver="bh", integrator="kdk")
    before = teng.state
    jeng.step(1)
    teng.step(1)
    caps = teng.caps
    assert caps.direct_body_cap > 64 and caps.leaf_list_cap > 16
    assert not teng.last_stats.overflowed(caps.as_dict())
    assert caps.as_dict() == jeng.caps.as_dict()
    assert int(teng.state.step) == 1 and int(before.step) == 0
    dpos = np.abs(teng.state.pos.numpy() - np.asarray(jeng.state.pos)).max()
    assert dpos <= 1e-3, dpos
    # with the retune off the overflow stays on record
    off = tengine.Engine(tconfig.SimConfig(**cfg), solver="bh",
                         auto_retune=False, device="cpu")
    off.state = before
    with pytest.warns(RuntimeWarning, match="after 0 retune rounds"):
        off.step(1)
    assert off.caps == tengine.Caps.from_config(off.cfg)
    assert off.last_stats.overflowed(off.caps.as_dict())


@pytest.mark.parametrize("field", ttraverse.TraversalStats._fields)
def test_overflows_names_the_cap_that_grows(field):
    """A need over its cap alone is reported against the one cap that
    Caps.grown grows for it, and fits the grown caps."""
    caps = tengine.Caps(*[8] * 7, cand_caps=(8, 8))
    vals = dict.fromkeys(ttraverse.TraversalStats._fields, 4)
    vals["cand_need"] = (4, 4)
    vals[field] = (4, 100) if field == "cand_need" else 100
    st = ttraverse.TraversalStats(**vals)
    (name, cap, need), = st.overflows(caps.as_dict())
    before, after = caps.as_dict(), caps.grown(st).as_dict()
    assert [k for k in after if after[k] != before[k]] == [name]
    assert cap == before[name] and need == vals[field]
    assert st.overflowed(before) and not st.overflowed(after)


def test_tighten_caps_shrinks_and_stays_correct():
    cfg = tconfig.SimConfig(capacity=1024, max_depth=7, group_chunk=16,
                            approx_cap=4096, direct_body_cap=4096,
                            frontier_cap=2048, leaf_list_cap=1024,
                            group_cap=16)
    eng = tengine.Engine(cfg, solver="bh", integrator="kdk", seed=5,
                         device="cpu")
    assert not eng.tighten_caps()                  # nothing observed yet
    eng.reset_default_scene(n1=600, n2=200)
    start = eng.state
    eng.step(1)
    before = eng.caps
    pos_ref = eng.state.pos.clone()
    assert eng.tighten_caps()
    after = eng.caps
    assert after.approx_cap < before.approx_cap \
        and after.direct_body_cap < before.direct_body_cap
    assert not eng.last_stats.overflowed(after.as_dict())
    assert not eng.tighten_caps()                  # hysteresis: settled
    # the same step from the same state under the tight caps: same forces
    eng.state = start
    eng.step(1)
    assert eng.caps == after
    np.testing.assert_allclose(eng.state.pos.numpy(), pos_ref.numpy(),
                               rtol=1e-6, atol=1e-4)


def _stats(cls, vals, cand, arr):
    return cls(*[arr(v) for v in vals], None if cand is None else arr(cand))


@pytest.mark.parametrize("vals,cand", [
    ((86, 171, 1601, 0, 8, 235, 50), None),
    ((5000, 600, 20000, 3000, 3000, 2_000_000, 700), None),
    ((0, 1375, 10177, 0, 2048, 179375, 16), (72923, 23589, 2534)),
    ((0, 3000, 40000, 0, 5432, 140000, 16), (140000, 10, 5000)),
    ((0, 100, 900, 0, 40, 3000, 16), (0, 464)),     # fewer levels than caps
])
def test_caps_grown_and_tightened_match_jax(vals, cand):
    cfg = dict(capacity=1 << 20, approx_cap=1024, direct_body_cap=16384,
               frontier_cap=1024, leaf_list_cap=2048, group_cap=2080,
               node_capacity=1 << 20)
    jcaps = jengine.Caps.from_config(jconfig.SimConfig(**cfg))
    tcaps = tengine.Caps.from_config(tconfig.SimConfig(**cfg))
    jst = _stats(jtraverse.TraversalStats, vals, cand,
                 lambda v: np.asarray(v, np.int32))
    host = ttraverse.TraversalStats(*vals, cand)
    dev = _stats(ttraverse.TraversalStats, vals, cand,
                 lambda v: torch.tensor(v, dtype=torch.int32))
    for st in (host, dev):
        assert tcaps.grown(st).as_dict() == jcaps.grown(jst).as_dict()
        assert tcaps.tightened(st).as_dict() == \
            jcaps.tightened(jst).as_dict()
        assert bool(st.overflowed(tcaps.as_dict())) == \
            bool(jst.overflowed(jcaps.as_dict()))


def test_strict_parity_outside_root():
    """Outside-root bodies exert nothing in strict mode
    (BarnesHutAlg.kt:126) but are still pulled; both as in the JAX
    engine."""
    pos = np.array([[1200.0, 400.0], [1210.0, 400.0], [99999.0, 99999.0]],
                   np.float32)
    vel = np.zeros_like(pos)
    mass = np.array([10.0, 10.0, 1e9], np.float32)
    out = {}
    for strict in (True, False):
        jeng, teng = _engines(dict(capacity=256, **SMALL), 0, 0,
                              dict(dt=0.001, merge_min_dist=0.0),
                              solver="bh", integrator="kdk",
                              strict_parity=strict)
        jeng.set_bodies(pos, vel, mass)
        teng.set_bodies(pos, vel, mass)
        jeng.step(1)
        teng.step(1)
        np.testing.assert_allclose(teng.state.vel.numpy(),
                                   np.asarray(jeng.state.vel), rtol=1e-4,
                                   atol=1e-7)
        out[strict] = teng.state.vel.numpy()
    assert np.abs(out[True][:2]).max() < 1.0       # the outsider pulls nobody
    assert np.abs(out[False][:2]).max() > np.abs(out[True][:2]).max()
    assert np.abs(out[True][2]).max() > 0          # but it is pulled


@pytest.mark.parametrize("integrator", ["kdk", "kdk_reuse"])
def test_strict_parity_nudges_coincident_bodies(integrator):
    """Two bodies an ulp apart are pushed 1e-3 px apart before the force
    pass, as the JAX engine's pre-step does."""
    b0 = np.array([100.0, 300.0], np.float32)
    pos = np.stack([b0, np.nextafter(b0, np.float32(1e9)),
                    np.array([600.0, 200.0], np.float32)])
    vel = np.zeros_like(pos)
    mass = np.full(3, 10.0, np.float32)
    jeng, teng = _engines(dict(capacity=64, **SMALL), 0, 0,
                          dict(merge_min_dist=0.0), solver="bh",
                          integrator=integrator, strict_parity=True)
    jeng.set_bodies(pos, vel, mass)
    teng.set_bodies(pos, vel, mass)
    jeng.step(2)
    teng.step(2)
    got = teng.state.pos.numpy()
    assert np.abs(got[0] - got[1]).max() > 1e-3
    np.testing.assert_allclose(got, np.asarray(jeng.state.pos), rtol=0,
                               atol=1e-4)


def test_strict_parity_raises_outside_bh():
    cfg = tconfig.SimConfig(capacity=64, mesh_level=6, mesh_band=32,
                            mesh_chunk=64)
    tengine.Engine(cfg, solver="bh", strict_parity=True, device="cpu")
    for solver in ("pm", "allpairs"):
        with pytest.raises(ValueError, match="strict_parity"):
            tengine.Engine(cfg, solver=solver, strict_parity=True,
                           device="cpu")


def test_bh_refusals():
    with pytest.raises(ValueError, match="bh_traversal"):
        tengine.Engine(tconfig.SimConfig(capacity=64, bh_traversal="waves"),
                       device="cpu")
    with pytest.raises(ValueError, match="2\\^24"):
        tengine.Engine(tconfig.SimConfig(capacity=(1 << 24) + 1),
                       device="cpu")
    with pytest.raises(ValueError, match="dim=3"):
        tengine.Engine(tconfig.SimConfig(capacity=64, dim=3), device="cpu")


def test_tree_boxes_match_jax():
    jeng, teng = _engines(dict(capacity=512, **SMALL), 300, 100, solver="bh")
    jc, js = jeng.tree_boxes()
    tc, ts = teng.tree_boxes()
    assert tc.shape[0] == ts.shape[0] > 0 and (ts > 0).all()
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ts, js)


def test_one_host_read_per_step(monkeypatch):
    """Every need reaches the host in the single ``tolist`` of a step(n)."""
    eng = tengine.Engine(tconfig.SimConfig(capacity=256, **SMALL),
                         solver="bh", integrator="kdk_reuse", device="cpu")
    eng.reset_default_scene(n1=150, n2=50)
    calls = []
    real = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist",
                        lambda self: calls.append(self.shape) or real(self))
    eng.step(3)
    assert calls == [torch.Size([4 + 7])]
    assert isinstance(eng.last_stats.direct_need, int)


def test_bh_force_error_is_the_jax_packages():
    """The error of theta = 0.5 against exact forces is a property of the
    math: on the same bodies both packages' passes read the same mean."""
    from tpu_nbody_torch.ops import forces as tforces
    cfg = dict(capacity=4096, group_cap=64)
    jeng, teng = _engines(cfg, 2400, 600, dict(theta=0.5), solver="bh")
    js, ts = jeng.state, teng.state
    jacc, _ = jengine.make_bh_accel(jeng.cfg, jeng.caps)(
        js.pos, js.mass, js.alive, jeng.params)
    tacc, _ = tengine.make_bh_accel(teng.cfg, teng.caps)(
        ts.pos, ts.mass, ts.alive, teng.params)
    idx = torch.from_numpy(np.random.default_rng(0).choice(3000, 512, False))
    exact = tforces.accel_allpairs(ts.pos, ts.mass, 80.0, 1.0,
                                   targets=ts.pos[idx])

    def mean_err(acc):
        return float(((acc[idx] - exact).norm(dim=1)
                      / (exact.norm(dim=1) + 1e-9)).mean())

    err_t = mean_err(tacc)
    err_j = mean_err(torch.from_numpy(np.array(jacc)))
    assert 5e-5 < err_t < 1e-3
    assert abs(err_t - err_j) <= 0.01 * err_j, (err_t, err_j)


@pytest.mark.parametrize("solver", ["bh", "allpairs"])
def test_sampled_force_error_of_any_solver(solver):
    cfg = tconfig.SimConfig(capacity=2048, direct_body_cap=256, group_cap=32)
    eng = tengine.Engine(cfg, tconfig.Params.default(theta=0.5), solver=solver,
                         device="cpu", seed=4)
    eng.reset_default_scene(n1=1500, n2=400)
    g = torch.Generator().manual_seed(0)
    e = accuracy.sampled_force_error(eng.state, cfg, eng.params, 200, g,
                                     solver=solver)
    assert e["samples"] == 200
    if solver == "allpairs":
        assert e["max"] < 1e-5
    else:
        assert 1e-5 < e["mean"] < 2e-3 and e["p99"] <= e["max"]
        assert e["direct_need"] > 256              # the pass was refitted
        assert e["caps"].direct_body_cap >= e["direct_need"]
    with pytest.raises(ValueError, match="solver"):
        accuracy.sampled_force_error(eng.state, cfg, eng.params, 8, g,
                                     solver="tree")
