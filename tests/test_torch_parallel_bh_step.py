"""The sharded Barnes–Hut step (local trees + locally-essential export)
against tpu_nbody.parallel.sharded_bh on the 8-device CPU mesh: its forces
and needs, and the boundary clump whose near forces ride the body
export."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nbody import config as jconfig
from tpu_nbody import engine as jengine
from tpu_nbody import state as jstate
from tpu_nbody.models import scenes as jscenes
from tpu_nbody.ops import morton as jmorton
from tpu_nbody.parallel import mesh as jmesh
from tpu_nbody.parallel import sharded_bh as jbh
from tpu_nbody.parallel import sharded_pm as jpm
from tpu_nbody_torch import config as tconfig
from tpu_nbody_torch import convert
from tpu_nbody_torch import engine as tengine
from tpu_nbody_torch.parallel import mesh as tmesh
from tpu_nbody_torch.parallel import sharded_bh as tbh
from tpu_nbody_torch.parallel.collectives import ThreadGroup

torch.set_num_threads(1)

# tests/test_sharded_bh.py's caps
SMALL = dict(max_depth=7, group_chunk=16, approx_cap=1024,
             direct_body_cap=2048, frontier_cap=512, leaf_list_cap=256,
             node_capacity=2048)
LET = dict(let_approx_cap=1024, let_body_cap=1024, let_leaf_cap=256,
           let_frontier_cap=2048)


def _np(st):
    return [np.asarray(x) for x in st]


def _disk(cap=2048, n1=1200, n2=400):
    p, v, m = jscenes.default_two_disk_scene(jax.random.PRNGKey(1), n1=n1,
                                             n2=n2)
    st = jstate.from_arrays(p, v, m, capacity=cap)
    return st._replace(vel=jnp.zeros_like(st.vel))


def _clump():
    """tests/test_sharded_bh.py::test_let_body_export_carries_boundary_clump
    _force: a 40-body clump on the 2nd shard boundary of 8 (cap 1024)."""
    rng = np.random.default_rng(42)
    cap = 1024
    cfg = jconfig.SimConfig(capacity=cap, **SMALL)
    pos = np.zeros((cap, 2), np.float32)
    pos[:900] = rng.random((900, 2)) * [2400, 800]
    mass = np.zeros(cap, np.float32)
    mass[:900] = 1.0
    origin = (cfg.root_center[0] - cfg.root_half,
              cfg.root_center[1] - cfg.root_half)
    codes = np.asarray(jmorton.hilbert_codes(
        jnp.asarray(pos[:900]), jnp.asarray(origin, jnp.float32),
        jnp.float32(2 * cfg.root_half), jnp.ones(900, bool)))
    anchor = pos[:900][np.argsort(codes)][2 * (cap // 8) - 20]
    pos[900:940] = anchor + rng.random((40, 2)).astype(np.float32) * 2.0
    mass[900:940] = 50.0
    st = jstate.SimState(jnp.asarray(pos), jnp.zeros((cap, 2), jnp.float32),
                         jnp.asarray(mass), jnp.asarray(np.arange(cap) < 940),
                         jnp.int32(0))
    return cap, st


def _jstep(P, cfg_kw, st, params, n_steps):
    jcfg = jconfig.SimConfig(**cfg_kw)
    jm = jmesh.make_mesh(P)
    sst = jpm.reshard_by_hilbert(st, jm, jcfg)
    step = jbh.make_sharded_bh_step(jm, jcfg, jengine.Caps.from_config(jcfg),
                                    **LET)
    out, stats = step(sst, params, n_steps=n_steps)
    return jax.tree.map(np.asarray, sst), jax.tree.map(np.asarray, out), \
        stats


def _tstep(P, cfg_kw, sst, params, n_steps, **kw):
    """The port's step from the JAX-resharded state; also returns its
    seed force pass (``step.accel``)."""
    tcfg = tconfig.SimConfig(**cfg_kw)
    g = ThreadGroup(P, "cpu", timeout=120)
    step = tbh.make_sharded_bh_step(g, tcfg, tengine.Caps.from_config(tcfg),
                                    **LET, **kw)
    local = convert.sharded_state_from_numpy(_np(sst), g)
    out, stats = step(local, params, n_steps=n_steps)
    acc = torch.cat([a for a, _ in step.accel(local, params)])
    return tmesh.gather_state(out, g), stats, acc


@pytest.mark.parametrize("P,integrator", [(2, "kdk_reuse"), (8, "kdk")])
def test_sharded_bh_step_matches_jax(P, integrator):
    """One step from rest at dt = 1e-4 (merging off): the velocity is the
    mean of the two force passes times dt, within 6e-7 of its max / dt
    between the packages (no MAC decision differs), and every need of
    ShardedBHStats equal; "kdk" runs the same kdk_reuse step."""
    cfg_kw = dict(capacity=2048, **SMALL)
    jp = jconfig.Params.default(dt=1e-4, merge_min_dist=0.0)
    sst, want, jstats = _jstep(P, cfg_kw, _disk(), jp, 1)
    got, stats, acc = _tstep(P, cfg_kw, sst, tconfig.Params.default(
        dt=1e-4, merge_min_dist=0.0), 1, integrator=integrator)
    a_want = want.vel / 1e-4
    np.testing.assert_allclose(got.vel.numpy() / 1e-4, a_want, rtol=0,
                               atol=6e-7 * np.abs(a_want).max())
    # the seed pass alone against that mean: the second pass sees bodies
    # moved by a dt^2 / 2, up to 3e-4 px next to the heavy centre
    np.testing.assert_allclose(acc.numpy(), a_want, rtol=0,
                               atol=1e-4 * np.abs(a_want).max())
    for name in ("export_need", "let_approx_need", "let_leaf_need",
                 "let_frontier_need", "heavy_need"):
        assert int(getattr(stats, name)) == int(np.asarray(
            getattr(jstats, name))), name
    assert int(stats.let_approx_need) + int(stats.let_body_need) >= int(
        stats.export_need) >= int(stats.let_body_need) > 0
    for name in ("approx_need", "leaf_need", "direct_need", "group_need",
                 "node_need", "group_size_need"):
        assert int(getattr(stats.trav, name)) == int(np.asarray(
            getattr(jstats.trav, name))), name


def test_sharded_bh_boundary_clump_matches_jax():
    """The clump split across ranks 1 and 2 of 8: its bodies' accelerations
    (velocity after one step from rest at dt = 1e-4) within 6e-7 of the
    clump's largest, and leaves really exported."""
    cap, st = _clump()
    cfg_kw = dict(capacity=cap, **SMALL)
    jp = jconfig.Params.default(dt=1e-4, merge_min_dist=0.0)
    sst, want, jstats = _jstep(8, cfg_kw, st, jp, 1)
    cl = sst.mass == 50.0
    assert len(set(np.nonzero(cl)[0] // (cap // 8))) >= 2
    got, stats, _ = _tstep(8, cfg_kw, sst, tconfig.Params.default(
        dt=1e-4, merge_min_dist=0.0), 1)
    a_want = want.vel[cl] / 1e-4
    np.testing.assert_allclose(got.vel.numpy()[cl] / 1e-4, a_want, rtol=0,
                               atol=6e-7 * np.abs(a_want).max())
    assert int(stats.let_leaf_need) == int(np.asarray(
        jstats.let_leaf_need)) > 0
