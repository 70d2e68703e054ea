"""The sharded exact step (ring all-pairs, sharded merge, kdk/euler step)
against tpu_nbody.parallel.sharded on the 8-device CPU mesh, P in
{2, 4, 8}, the same bodies on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from tpu_nbody import config as jconfig
from tpu_nbody import state as jstate
from tpu_nbody.parallel import mesh as jmesh
from tpu_nbody.parallel import sharded as jsharded
from tpu_nbody_torch import config as tconfig
from tpu_nbody_torch import convert
from tpu_nbody_torch.parallel import mesh as tmesh
from tpu_nbody_torch.parallel import sharded as tsharded
from tpu_nbody_torch.parallel.collectives import ThreadGroup, run_spmd

torch.set_num_threads(1)

SIZES = [2, 4, 8]


def _scene(cap=256, n=200, seed=7):
    """Bodies in a 500 px square with dead slots among them, and heavies
    with satellites that the sharding splits across ranks."""
    rng = np.random.default_rng(seed)
    pos = (rng.random((cap, 2)) * 500).astype(np.float32)
    vel = rng.standard_normal((cap, 2)).astype(np.float32)
    mass = (rng.random(cap) + 0.5).astype(np.float32)
    alive = np.arange(cap) < n
    alive[[5, 77]] = False
    for h, at in ((0, 30), (31, 30), (64, 250), (130, 400), (131, 403)):
        mass[h] = 5000.0 + h
        pos[h] = [at, at]
    pos[40:48] = pos[31] + rng.standard_normal((8, 2)).astype(np.float32)
    pos[100:104] = pos[130] + rng.standard_normal((4, 2)).astype(np.float32)
    return pos, vel, np.where(alive, mass, 0).astype(np.float32), alive


def _jax_state(arrays):
    pos, vel, mass, alive = arrays
    return jstate.SimState(jnp.asarray(pos), jnp.asarray(vel),
                           jnp.asarray(mass), jnp.asarray(alive),
                           jnp.int32(0))


def _port(arrays, P):
    g = ThreadGroup(P, "cpu", timeout=120)
    return g, convert.sharded_state_from_numpy((*arrays, 0), g)


@pytest.mark.parametrize("P", SIZES)
def test_ring_allpairs_accel_matches_jax(P):
    """Within 1e-5 of max |a|."""
    pos, _, mass, alive = _scene()
    m = np.where(alive, mass, 0).astype(np.float32)
    f = jax.shard_map(
        lambda p, mm: jsharded.ring_allpairs_accel(p, mm, 80.0, 1.0,
                                                   n_shards=P),
        mesh=jmesh.make_mesh(P), in_specs=(PS("b"), PS("b")),
        out_specs=PS("b"), check_vma=False)
    want = np.asarray(jax.jit(f)(pos, m))
    g = ThreadGroup(P, "cpu", timeout=120)
    got = torch.cat(run_spmd(
        g, lambda p, mm: tsharded.ring_allpairs_accel(p, mm, 80.0, 1.0,
                                                      group=g),
        list(torch.from_numpy(pos).chunk(P)),
        list(torch.from_numpy(m).chunk(P)))).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("hcap", [1, 16])
@pytest.mark.parametrize("P", SIZES)
def test_merge_sharded_matches_jax(P, hcap):
    """Masses rtol 1e-6, alive flags and heavy_need equal; at hcap=1 the
    lightest heavies of a rank are left out, as in the JAX rule."""
    arrays = _scene()
    jp = jconfig.Params.default(merge_min_dist=8.0)

    def jbody(pos, vel, mass, alive):
        st = jstate.SimState(pos, vel, mass, alive, jnp.int32(0))
        out, need = jsharded._merge_sharded(st, jp, axis="b", n_shards=P,
                                            heavy_cap_local=hcap)
        return out.mass, out.alive, need

    f = jax.shard_map(jbody, mesh=jmesh.make_mesh(P),
                      in_specs=(PS("b"),) * 4,
                      out_specs=(PS("b"), PS("b"), PS()), check_vma=False)
    jmass, jalive, jneed = jax.jit(f)(*arrays)
    g, local = _port(arrays, P)
    tp = tconfig.Params.default(merge_min_dist=8.0)
    out = run_spmd(g, lambda s: tsharded._merge_sharded(
        s, tp, group=g, heavy_cap_local=hcap), local)
    got = tmesh.gather_state([s for s, _ in out], g)
    assert all(int(n) == int(jneed) for _, n in out)
    assert int(jneed) >= 2
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(jalive))
    assert got.alive.sum() < int(arrays[3].sum())      # merging happened
    np.testing.assert_allclose(got.mass.numpy(), np.asarray(jmass),
                               rtol=1e-6)


@pytest.mark.parametrize("P", SIZES)
@pytest.mark.parametrize("integrator", ["kdk", "euler"])
def test_sharded_step_matches_jax(integrator, P):
    """3 steps with merging on: positions within rtol 2e-4, atol 2e-4 (the
    JAX test's own tolerance), alive flags and heavy_need equal."""
    arrays = _scene()
    jstep = jsharded.make_sharded_step(jmesh.make_mesh(P),
                                       integrator=integrator)
    jparams = jconfig.Params.default(dt=0.002)
    want, jneed = jstep(jmesh.shard_state(_jax_state(arrays),
                                          jmesh.make_mesh(P)),
                        jparams, n_steps=3)
    g, local = _port(arrays, P)
    tstep = tsharded.make_sharded_step(g, integrator=integrator)
    out, need = tstep(local, tconfig.Params.default(dt=0.002), n_steps=3)
    got = tmesh.gather_state(out, g)
    assert int(got.step) == 3 and int(need) == int(jneed)
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.mass.numpy(), np.asarray(want.mass),
                               rtol=1e-6)


def test_sharded_step_refuses_other_integrators():
    g = ThreadGroup(2, "cpu")
    for bad in ("kdk_reuse", "leapfrog"):
        with pytest.raises(ValueError, match="integrator|runs"):
            tsharded.make_sharded_step(g, integrator=bad)
