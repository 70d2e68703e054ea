"""The sharded P3M pieces and step against tpu_nbody.parallel.sharded_pm on
the 8-device CPU mesh, P in {2, 4, 8}: slab FFT and FD window on the same
density, the cross-shard rescue on the boundary-pair scene, one force
pass, the reshards, the kdk / kdk_reuse / euler steps, and the refusals."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from tpu_nbody import config as jconfig
from tpu_nbody import state as jstate
from tpu_nbody.models import scenes as jscenes
from tpu_nbody.ops import morton as jmorton
from tpu_nbody.parallel import mesh as jmesh
from tpu_nbody.parallel import sharded_pm as jpm
from tpu_nbody_torch import config as tconfig
from tpu_nbody_torch import convert
from tpu_nbody_torch.ops import mesh as tmesh_ops
from tpu_nbody_torch.parallel import mesh as tmesh
from tpu_nbody_torch.parallel import sharded_pm as tpm
from tpu_nbody_torch.parallel.collectives import ThreadGroup, run_spmd

torch.set_num_threads(1)

SIZES = [2, 4, 8]


def _np(st):
    return [np.asarray(x) for x in st]


def _close(got, want, frac=1e-5):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * np.abs(want).max())


@pytest.mark.parametrize("ny_rect", [False, True])
@pytest.mark.parametrize("P", SIZES)
def test_slab_fft_and_fd_window_match_jax(P, ny_rect):
    """The same partial densities and kernel on both sides: the φ window
    slabs and the gathered force window within 1e-5 of their max."""
    nw = 128
    ny = 64 if ny_rect else nw
    grid, grid_y = 2 * nw, 2 * ny
    rng = np.random.default_rng(P)
    rho = np.zeros((P * grid_y, grid), np.float32)
    for r in range(P):
        rho[r * grid_y:r * grid_y + ny + 2, :nw + 1] = rng.random(
            (ny + 2, nw + 1))
    side = 2404.0
    phi_hat = np.array(jpm.mesh_ops.kernel_hats_for(
        side, 1.0, mesh_level=7, split_cells=4.0, mesh_ny=ny if ny_rect
        else 0)[2])
    h = np.float32(side) / np.float32(nw)
    mesh = jmesh.make_mesh(P)
    f = jax.shard_map(
        lambda x: jpm._slab_fft_phi(x, phi_hat, axis="b", n_shards=P,
                                    grid=grid, grid_y=grid_y, ny=ny),
        mesh=mesh, in_specs=PS("b"), out_specs=PS("b"), check_vma=False)
    want_phi = np.asarray(jax.jit(f)(rho))
    fd = jax.shard_map(
        lambda x: jpm._fd_force_window(x, jnp.float32(h), axis="b",
                                       n_shards=P, nw=nw, ny=ny),
        mesh=mesh, in_specs=PS("b"), out_specs=(PS(), PS()),
        check_vma=False)
    want_fx, want_fy = (np.asarray(x) for x in jax.jit(fd)(want_phi))

    g = ThreadGroup(P, "cpu", timeout=120)
    ph = torch.from_numpy(phi_hat)
    got_phi = run_spmd(g, lambda x: tpm._slab_fft_phi(
        x, ph, group=g, grid=grid, grid_y=grid_y, ny=ny),
        list(torch.from_numpy(rho).chunk(P)))
    _close(torch.cat(got_phi).numpy(), want_phi)
    got = run_spmd(g, lambda x: tpm._fd_force_window(
        x, float(h), group=g, nw=nw, ny=ny),
        list(torch.from_numpy(want_phi.copy()).chunk(P)))
    for fx, fy in got:
        _close(fx.numpy(), want_fx)
        _close(fy.numpy(), want_fy)


def test_fd_window_needs_three_rows_a_rank():
    g = ThreadGroup(2, "cpu")
    with pytest.raises(ValueError, match="3 window rows"):
        run_spmd(g, lambda x: tpm._fd_force_window(x, 1.0, group=g, nw=8,
                                                   ny=8),
                 [torch.zeros(2, 16)] * 2)


def _boundary_scene():
    """tests/test_sharded.py::test_cross_shard_rescue_recovers_boundary_pair:
    four tight clusters either side of the world-centre cross, which the
    Hilbert curve puts on different shards."""
    rng = np.random.default_rng(99)
    cap = 1024
    cfg = jconfig.SimConfig(capacity=cap, mesh_level=9, mesh_band=32,
                            mesh_chunk=128, mesh_rescue=4, mesh_xrescue=8,
                            mesh_xrescue_export=16)
    cx, cy = cfg.root_center
    pos = np.zeros((cap, 2), np.float32)
    pos[:920] = rng.random((920, 2)) * [2400, 800]
    mass = np.zeros(cap, np.float32)
    mass[:920] = 1.0
    for q, (sx, sy) in enumerate([(-1, -1), (1, -1), (-1, 1), (1, 1)]):
        sl = slice(920 + 8 * q, 928 + 8 * q)
        pos[sl] = [cx + 2.0 * sx, cy + 2.0 * sy]
        pos[sl] += rng.random((8, 2)).astype(np.float32) * 0.5
        mass[sl] = 20.0
    alive = np.arange(cap) < 952
    st = jstate.SimState(jnp.asarray(pos), jnp.zeros((cap, 2), jnp.float32),
                         jnp.asarray(mass), jnp.asarray(alive), jnp.int32(0))
    return cfg, st


def _geometry(cfg):
    nw = 1 << cfg.mesh_level
    h = np.float32(np.float32(2 * cfg.root_half) / np.float32(nw))
    return float(np.float32(cfg.mesh_split * h))


@pytest.mark.parametrize("P", [4, 8])
def test_cross_shard_rescue_matches_jax(P):
    """The boundary-pair scene: accelerations within 1e-5 of their max,
    export and import needs equal (and nonzero: pairs do cross ranks)."""
    cfg, st = _boundary_scene()
    sst = jax.tree.map(np.asarray, jpm.reshard_by_hilbert(
        st, jmesh.make_mesh(P), cfg))
    a = _geometry(cfg)

    def jbody(p, m, al):
        acc, e, i = jpm._cross_shard_rescue(
            p, m, al, 1.0, jnp.float32(a), band=32, k=8, export_cap=16,
            chunk=128, axis="b", n_shards=P)
        return acc, e[None], i[None]

    f = jax.shard_map(
        jbody,
        mesh=jmesh.make_mesh(P), in_specs=(PS("b"),) * 3,
        out_specs=(PS("b"), PS("b"), PS("b")), check_vma=False)
    want, jexp, jimp = (np.asarray(x) for x in jax.jit(f)(
        sst.pos, sst.mass, sst.alive))
    g = ThreadGroup(P, "cpu", timeout=120)
    local = convert.sharded_state_from_numpy(_np(sst), g)
    out = run_spmd(g, lambda s: tpm._cross_shard_rescue(
        s.pos, s.mass, s.alive, 1.0, a, band=32, k=8, export_cap=16,
        chunk=128, group=g), local)
    _close(torch.cat([o[0] for o in out]).numpy(), want)
    assert [int(o[1]) for o in out] == jexp.reshape(-1).tolist()
    assert [int(o[2]) for o in out] == jimp.reshape(-1).tolist()
    assert max(jimp.reshape(-1)) > 0


PM_CFG = dict(capacity=1024, mesh_level=9, mesh_band=32, mesh_chunk=128)


def _disk_state(cap=1024, n1=700, n2=200):
    p, v, m = jscenes.default_two_disk_scene(jax.random.PRNGKey(1), n1=n1,
                                             n2=n2)
    return jstate.from_arrays(p, v, m, capacity=cap)


@pytest.mark.parametrize("P,knobs", [
    (2, {}), (4, dict(mesh_ny=256, mesh_interlace=True)), (8, {}),
    (8, dict(mesh_order=1, mesh_rescue=0))])
def test_pm_accel_local_sorted_matches_jax(P, knobs):
    """One force pass of the resharded two-disk scene: accelerations within
    1e-5 of their max, the four needs equal."""
    cfg = jconfig.SimConfig(**PM_CFG, **knobs)
    sst = jax.tree.map(np.asarray, jpm.reshard_by_hilbert(
        _disk_state(), jmesh.make_mesh(P), cfg))
    origin = (cfg.root_center[0] - cfg.root_half,
              cfg.root_center[1] - cfg.root_half)
    kw = dict(mesh_level=cfg.mesh_level, split_cells=cfg.mesh_split,
              band=cfg.mesh_band, chunk=cfg.mesh_chunk,
              rescue_k=cfg.mesh_rescue, n_shards=P, order=cfg.mesh_order,
              interlace=cfg.mesh_interlace, mesh_ny=cfg.mesh_ny,
              xrescue_k=cfg.mesh_xrescue,
              xrescue_export=cfg.mesh_xrescue_export)

    def jbody(p, m, al):
        acc, stats = jpm._pm_accel_local_sorted(
            p, m, al, 80.0, 1.0, origin, 2 * cfg.root_half, axis="b", **kw)
        return acc, tuple(x[None] for x in stats)

    f = jax.shard_map(
        jbody,
        mesh=jmesh.make_mesh(P), in_specs=(PS("b"),) * 3,
        out_specs=(PS("b"), (PS("b"),) * 4), check_vma=False)
    want, jstats = jax.jit(f)(sst.pos, sst.mass, sst.alive)
    g = ThreadGroup(P, "cpu", timeout=120)
    local = convert.sharded_state_from_numpy(_np(sst), g)
    kw.pop("n_shards")
    out = run_spmd(g, lambda s: tpm._pm_accel_local_sorted(
        s.pos, s.mass, s.alive, 80.0, 1.0, origin, 2 * cfg.root_half,
        group=g, **kw), local)
    _close(torch.cat([o[0] for o in out]).numpy(), np.asarray(want))
    for i, js in enumerate(jstats):
        assert [int(o[1][i]) for o in out] == np.asarray(js).reshape(
            -1).tolist()
    # the step's own pass: the same accelerations, needs max over ranks
    step = tpm.make_sharded_pm_step(g, tconfig.SimConfig(**PM_CFG, **knobs))
    res = step.accel(local, tconfig.Params.default())
    np.testing.assert_array_equal(torch.cat([r[0] for r in res]).numpy(),
                                  torch.cat([o[0] for o in out]).numpy())
    assert res[0][1].tolist() == [max(int(o[1][i]) for o in out)
                                  for i in range(4)]


def _codes(cfg, st):
    origin = (cfg.root_center[0] - cfg.root_half,
              cfg.root_center[1] - cfg.root_half)
    return np.asarray(jmorton.hilbert_codes(
        jnp.asarray(np.asarray(st.pos)), jnp.asarray(origin, jnp.float32),
        jnp.float32(2 * cfg.root_half), jnp.asarray(np.asarray(st.alive))))


def _rows(st, sl=slice(None)):
    x = np.concatenate([np.asarray(st.pos)[sl], np.asarray(st.vel)[sl],
                        np.asarray(st.mass)[sl, None]], 1)
    return x[np.lexsort(x.T)]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("P", SIZES)
def test_reshards_match_jax(P, ties):
    """From a shuffled sharding with dead slots spread through it. The host
    reshard equals the JAX package's bit for bit. The device reshard gives
    the host reshard's global code order, alive flags and bodies; without
    equal codes it equals the JAX device reshard bit for bit and holds the
    same bodies on every rank as the host path. With 40 pairs of bodies at
    one position (``ties``) the JAX device reshard duplicates some and
    drops others where such a pair straddles a rank split; the port's does
    not."""
    cap, n = 1024, 900
    cfg = tconfig.SimConfig(capacity=cap, mesh_level=9)
    jcfg = jconfig.SimConfig(capacity=cap, mesh_level=9)
    rng = np.random.default_rng(5)
    pos = np.zeros((cap, 2), np.float32)
    pos[:n] = rng.random((n, 2)) * [2400.0, 800.0]
    if ties:
        pos[n - 40:n] = pos[:40]
    vel = np.zeros((cap, 2), np.float32)
    vel[:n] = rng.standard_normal((n, 2))
    mass = np.zeros(cap, np.float32)
    mass[:n] = rng.random(n) + 0.5
    perm = rng.permutation(cap)
    arrays = [pos[perm], vel[perm], mass[perm], (np.arange(cap) < n)[perm],
              np.int32(0)]
    jst = jstate.SimState(*(jnp.asarray(x) for x in arrays))
    jm = jmesh.make_mesh(P)
    want_host = jax.tree.map(np.asarray, jpm.reshard_by_hilbert(jst, jm,
                                                                jcfg))
    want_dev = jax.tree.map(np.asarray, jpm.make_device_reshard(jm, jcfg)(
        jmesh.shard_state(jst, jm)))
    g = ThreadGroup(P, "cpu", timeout=120)
    host = tmesh.gather_state(tpm.reshard_by_hilbert(
        convert.state_from_numpy(*arrays, device="cpu"), g, cfg), g)
    dev = tmesh.gather_state(tpm.make_device_reshard(g, cfg)(
        convert.sharded_state_from_numpy(arrays, g)), g)
    for a, b in zip(host[:4], want_host[:4]):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(_codes(jcfg, dev), _codes(jcfg, host))
    np.testing.assert_array_equal(dev.alive.numpy(), host.alive.numpy())
    np.testing.assert_array_equal(_rows(dev), _rows(host))
    if not ties:
        for a, b in zip(dev[:4], want_dev[:4]):
            np.testing.assert_array_equal(a.numpy(), b)
        c = cap // P
        for r in range(P):
            sl = slice(r * c, (r + 1) * c)
            np.testing.assert_array_equal(_rows(dev, sl), _rows(host, sl))
    elif P == 8:
        assert not np.array_equal(_rows(want_dev), _rows(host))


@pytest.mark.parametrize("integrator,P,knobs,steps", [
    ("kdk", 8, {}, 2),
    ("euler", 2, dict(mesh_rescue=16, mesh_xrescue=16), 2),
    ("kdk_reuse", 4, dict(mesh_ny=256, mesh_interlace=True, mesh_rescue=16,
                          mesh_xrescue=16, pm_resort_every=2), 4),
    ("kdk_reuse", 8, {}, 3),
])
def test_sharded_pm_step_matches_jax(integrator, P, knobs, steps):
    """Positions within rtol 1e-3, atol 5e-3 after the steps (merging on),
    alive flags and every PmShardStats need equal."""
    cfg = dict(PM_CFG, **knobs)
    jcfg = jconfig.SimConfig(**cfg)
    jmesh_ = jmesh.make_mesh(P)
    sst = jpm.reshard_by_hilbert(_disk_state(), jmesh_, jcfg)
    jparams = jconfig.Params.default(dt=0.002)
    want, jstats = jpm.make_sharded_pm_step(jmesh_, jcfg,
                                            integrator=integrator)(
        sst, jparams, n_steps=steps)
    g = ThreadGroup(P, "cpu", timeout=120)
    local = convert.sharded_state_from_numpy(
        _np(jax.tree.map(np.asarray, sst)), g)
    out, stats = tpm.make_sharded_pm_step(
        g, tconfig.SimConfig(**cfg), integrator=integrator)(
        local, tconfig.Params.default(dt=0.002), n_steps=steps)
    got = tmesh.gather_state(out, g)
    assert int(got.step) == steps
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               rtol=1e-3, atol=5e-3)
    np.testing.assert_allclose(got.mass.numpy(), np.asarray(want.mass),
                               rtol=1e-6)
    assert [int(x) for x in stats] == [int(np.asarray(x)) for x in jstats]
    assert int(stats.heavy_need) > 0


@pytest.mark.parametrize("bad", [
    dict(cfg=dict(pm_mesh_every=2)), dict(cfg=dict(pm_heavy_cap=4)),
    dict(cfg=dict(mesh_rescue_hot=8)), dict(cfg=dict(mesh_order=3)),
    dict(integrator="leapfrog")], ids=str)
def test_sharded_pm_step_refusals(bad):
    """The three knobs the JAX step ignores, TSC and an unknown integrator
    raise when the step is built."""
    cfg = tconfig.SimConfig(**PM_CFG, **bad.get("cfg", {}))
    with pytest.raises(ValueError):
        tpm.make_sharded_pm_step(ThreadGroup(2, "cpu"), cfg,
                                 integrator=bad.get("integrator", "kdk"))
    with pytest.raises(ValueError):
        tmesh_ops._check_order(4)


def test_xrescue_config_matches_jax():
    """The two SimConfig fields only the sharded pm step reads, with the
    JAX defaults."""
    j, t = jconfig.SimConfig(capacity=64), tconfig.SimConfig(capacity=64)
    assert (t.mesh_xrescue, t.mesh_xrescue_export) == \
        (j.mesh_xrescue, j.mesh_xrescue_export) == (4, 64)
    t2 = dataclasses.replace(t, mesh_xrescue=0)
    assert t2.mesh_xrescue == 0
