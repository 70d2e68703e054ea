"""The sharded Barnes–Hut export (tpu_nbody.parallel.sharded_bh._let_exports)
against the JAX package on the 8-device CPU mesh, and the step's refusals;
the step itself is in test_torch_parallel_bh_step.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from tpu_nbody import config as jconfig
from tpu_nbody import state as jstate
from tpu_nbody.models import scenes as jscenes
from tpu_nbody.ops import traverse as jtraverse
from tpu_nbody.ops import tree as jtree
from tpu_nbody.parallel import mesh as jmesh
from tpu_nbody.parallel import sharded_bh as jbh
from tpu_nbody.parallel import sharded_pm as jpm
from tpu_nbody_torch import config as tconfig
from tpu_nbody_torch import convert
from tpu_nbody_torch import engine as tengine
from tpu_nbody_torch.ops import tree as ttree
from tpu_nbody_torch.parallel import sharded_bh as tbh
from tpu_nbody_torch.parallel.collectives import ThreadGroup, run_spmd

torch.set_num_threads(1)

# tests/test_sharded_bh.py's caps
SMALL = dict(max_depth=7, group_chunk=16, approx_cap=1024,
             direct_body_cap=2048, frontier_cap=512, leaf_list_cap=256,
             node_capacity=2048)


def _np(st):
    return [np.asarray(x) for x in st]


def _disk(cap=2048, n1=1200, n2=400):
    p, v, m = jscenes.default_two_disk_scene(jax.random.PRNGKey(1), n1=n1,
                                             n2=n2)
    st = jstate.from_arrays(p, v, m, capacity=cap)
    return st._replace(vel=jnp.zeros_like(st.vel))


@pytest.mark.parametrize("P", [2, 4, 8])
def test_let_exports_match_jax(P):
    """Each rank's (P, E, 3) export rows and its needs (the JAX function's
    four and the body need), from the same tree and domain boxes on both
    sides."""
    cap = 2048
    jcfg = jconfig.SimConfig(capacity=cap, **SMALL)
    sst = jax.tree.map(np.asarray, jpm.reshard_by_hilbert(
        _disk(), jmesh.make_mesh(P), jcfg))
    origin = (jcfg.root_center[0] - jcfg.root_half,
              jcfg.root_center[1] - jcfg.root_half)
    side = 2 * jcfg.root_half
    big = np.finfo(np.float32).max
    alive = sst.alive.reshape(P, -1)
    pos = sst.pos.reshape(P, -1, 2)
    bmin = np.where(alive[..., None], pos, big).min(axis=1)
    bmax = np.where(alive[..., None], pos, -big).max(axis=1)
    valid = alive.sum(axis=1) > 0
    theta2 = float(np.float32(0.3) * np.float32(0.3))
    kw = dict(max_depth=jcfg.max_depth, frontier_cap=2048, approx_cap=1024,
              leaf_list_cap=256, body_cap=1024)

    def jbody(p, m, al):
        me = jax.lax.axis_index("b")
        t = jtree.build_tree(p, jnp.where(al, m, 0.0), al, origin, side,
                             num_nodes=jcfg.num_nodes,
                             leaf_size=jcfg.leaf_size,
                             max_depth=jcfg.max_depth)
        ex, *needs = jbh._let_exports(t, jnp.asarray(bmin), jnp.asarray(bmax),
                                      jnp.asarray(valid), me, theta2, 1.0,
                                      **kw)
        # the body need, which the JAX function does not return
        gv = jnp.asarray(valid) & (jnp.arange(P) != me)
        _, _, leaves, l_len, _ = jtraverse._traverse_all(
            t, jnp.asarray(bmin), jnp.asarray(bmax), gv, theta2, 1.0,
            max_depth=kw["max_depth"], frontier_cap=kw["frontier_cap"],
            approx_cap=kw["approx_cap"], leaf_list_cap=kw["leaf_list_cap"])
        s_total = jtraverse._direct_partners_all(
            t, leaves, l_len, direct_body_cap=kw["body_cap"])[2]
        return ex, jnp.stack(needs + [jnp.max(s_total)])[None]

    f = jax.shard_map(jbody, mesh=jmesh.make_mesh(P),
                      in_specs=(PS("b"),) * 3,
                      out_specs=(PS("b"), PS("b")), check_vma=False)
    jex, jneeds = (np.asarray(x) for x in jax.jit(f)(sst.pos, sst.mass,
                                                      sst.alive))
    g = ThreadGroup(P, "cpu", timeout=120)
    local = convert.sharded_state_from_numpy(_np(sst), g)

    def tbody(s):
        t = ttree.build_tree(s.pos, torch.where(s.alive, s.mass, 0.0),
                             s.alive, origin, side, num_nodes=jcfg.num_nodes,
                             leaf_size=jcfg.leaf_size,
                             max_depth=jcfg.max_depth)
        ex, *needs = tbh._let_exports(
            t, torch.from_numpy(bmin), torch.from_numpy(bmax),
            torch.from_numpy(valid), g.rank, theta2, 1.0, **kw)
        return ex, [int(x) for x in needs]

    out = run_spmd(g, tbody, local)
    assert [o[1] for o in out] == jneeds.reshape(P, 5).tolist()
    got = torch.cat([o[0] for o in out]).numpy()
    np.testing.assert_allclose(got, jex, rtol=1e-6, atol=1e-6)
    assert jneeds[:, 2].max() > 0      # leaves were opened: bodies export


def test_sharded_bh_step_refusals(monkeypatch):
    """euler raises (the JAX step runs kdk_reuse whatever it is told), and
    the float32 id range is checked on a rank's capacity."""
    cfg = tconfig.SimConfig(capacity=4096, **SMALL)
    caps = tengine.Caps.from_config(cfg)
    with pytest.raises(ValueError, match="euler"):
        tbh.make_sharded_bh_step(ThreadGroup(2, "cpu"), cfg, caps,
                                 integrator="euler")
    monkeypatch.setattr(ttree, "MAX_EXACT_ID", 3000)
    tbh.make_sharded_bh_step(ThreadGroup(2, "cpu"), cfg, caps)  # 2048 a rank
    with pytest.raises(ValueError, match="2\\^24"):
        tbh.make_sharded_bh_step(ThreadGroup(1, "cpu"), cfg, caps)
