"""ShardedEngine with solver="bh" against tpu_nbody.parallel.engine.
ShardedEngine on the 8-device CPU mesh, and the growth of each LET pool
on its own need."""

import warnings

import jax
import torch

from tests.test_torch_parallel_engine import (_assert_same_bodies, _pair,
                                              _set_both)
from tpu_nbody.models import scenes as jscenes
from tpu_nbody_torch import config as tconfig
from tpu_nbody_torch.parallel import engine as tpengine
from tpu_nbody_torch.parallel import mesh as tmesh

torch.set_num_threads(1)


def test_sharded_engine_bh_matches_jax():
    """bh (kdk with force reuse) across two reshards with merging on,
    cap 1024 on 8 ranks: the same bodies merged, positions within 1e-3 /
    2e-2 px, the LET needs equal."""
    small = dict(max_depth=7, group_chunk=16, approx_cap=1024,
                 direct_body_cap=2048, frontier_cap=512, leaf_list_cap=256,
                 node_capacity=2048)
    j, t = _pair(dict(capacity=1024, **small), {}, solver="bh",
                 integrator="kdk_reuse", reshard_every=2,
                 let_approx_cap=1024, let_body_cap=1024, let_leaf_cap=256)
    p, v, m = jscenes.default_two_disk_scene(jax.random.PRNGKey(0), n1=600,
                                             n2=200)
    _set_both(j, t, p, v, m)
    j.step(5)
    t.step(5)
    _assert_same_bodies(j, t, 2e-2)
    assert t.last_export_need > 0 and t.last_stats.group_need > 0
    assert not t.last_stats.overflowed(t.caps.as_dict())


def test_sharded_engine_grows_each_let_pool():
    """A body pool that overflows while the node pool has room: the JAX
    engine tests only their sum (export_need <= approx + body caps) and
    drops the bodies past the cap; the port grows the body pool to twice
    its own need and ends with every pool fitting."""
    small = dict(max_depth=7, group_chunk=16, approx_cap=1024,
                 direct_body_cap=2048, frontier_cap=512, leaf_list_cap=256,
                 node_capacity=2048)
    eng = tpengine.ShardedEngine(
        tconfig.SimConfig(capacity=1024, **small),
        tconfig.Params.default(), mesh=tmesh.make_mesh(4, device="cpu"),
        solver="bh", integrator="kdk_reuse", let_approx_cap=4096,
        let_body_cap=16, device="cpu")
    eng.reset_default_scene(n1=600, n2=200)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        eng.step(1)
    need = eng._needs
    assert 16 < need["let_body_need"] <= eng.let_body_cap
    assert need["export_need"] <= 4096 + 16     # the sum alone fits
    assert eng.let_approx_cap == 4096
