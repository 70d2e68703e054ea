"""Port parity: the Barnes–Hut traversals (dense, bfs, hier) against
tpu_nbody on the same tree inputs, the caps of tests/test_bh.py.

Each JAX traversal is compiled once (module fixture, the same static caps
for both opening angles). Forces must agree within 2e-5 of max |a| and every
need stat exactly; a mismatch in the needs names the first node whose MAC
decision differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nbody import config as jconfig
from tpu_nbody.models import scenes as jscenes
from tpu_nbody.ops import traverse as jtraverse
from tpu_nbody.ops import tree as jtree
from tpu_nbody_torch.ops import forces as tforces
from tpu_nbody_torch.ops import traverse as ttraverse
from tpu_nbody_torch.ops import tree as ttree

torch.set_num_threads(2)

MAX_DEPTH = 8
CAPS = dict(group_size=64, group_cap=512, max_depth=MAX_DEPTH,
            frontier_cap=1024, approx_cap=2048, leaf_list_cap=512,
            direct_body_cap=4096, group_chunk=16)
CAPS_DICT = {"approx_cap": 2048, "leaf_list_cap": 512,
             "direct_body_cap": 4096, "frontier_cap": 1024, "group_cap": 512,
             "group_size": 64}
THETAS = (0.3, 0.7)
TRAVERSALS = ("dense", "bfs", "hier")
NEEDS = ("approx_need", "leaf_need", "direct_need", "frontier_need",
         "group_need", "node_need", "group_size_need")


def _galaxy(n, cap):
    p, _, m = jscenes.make_galaxy_disk(jax.random.PRNGKey(42), n, r=300.0)
    pos = np.zeros((cap, 2), np.float32)
    pos[:n] = np.asarray(p)
    mass = np.zeros(cap, np.float32)
    mass[:n] = np.asarray(m)
    return pos, mass, np.arange(cap) < n


def _trees(pos, mass, alive):
    cfg = jconfig.SimConfig(capacity=pos.shape[0])
    origin = (cfg.root_center[0] - cfg.root_half,
              cfg.root_center[1] - cfg.root_half)
    kw = dict(num_nodes=cfg.num_nodes, leaf_size=8, max_depth=MAX_DEPTH)
    jt = jtree.build_tree(jnp.asarray(pos), jnp.asarray(mass),
                          jnp.asarray(alive), origin, 2 * cfg.root_half, **kw)
    tt = ttree.build_tree(torch.from_numpy(pos), torch.from_numpy(mass),
                          torch.from_numpy(alive), origin, 2 * cfg.root_half,
                          **kw)
    return jt, tt, cfg.num_nodes


def _jax_pass(jt, theta, **kw):
    acc, st = jtraverse.bh_accel_from_tree(
        jt, jnp.float32(theta), jnp.float32(1.0), jnp.float32(80.0),
        **dict(CAPS, **kw))
    return np.asarray(acc), st


def _torch_pass(tt, theta, **kw):
    return ttraverse.bh_accel_from_tree(tt, theta, 1.0, 80.0,
                                        **dict(CAPS, **kw))


@pytest.fixture(scope="module")
def passes():
    """{(package, traversal, theta): (acc, stats)} on the 1500-body galaxy,
    and the two trees."""
    jt, tt, num_nodes = _trees(*_galaxy(1500, 1536))
    out = {"trees": (jt, tt), "num_nodes": num_nodes}
    for trav in TRAVERSALS:
        for theta in THETAS:
            out["jax", trav, theta] = _jax_pass(jt, theta, traversal=trav)
            out["torch", trav, theta] = _torch_pass(tt, theta,
                                                    traversal=trav)
    return out


def _first_flip(jt, tt, theta):
    """Which (group, node) pass decision differs between the packages, for
    the message of a failed need comparison."""
    gv, gs, gc, _ = ttraverse.make_groups(tt, 64, 512)
    gmin, gmax = ttraverse._group_aabb(tt.spos, gs, gc, gv, 64)
    rows = tt.node_rows
    theta2 = float(np.float32(theta) * np.float32(theta))
    got = ttraverse._box_pass(gmin, gmax, rows[:, 3], rows[:, 4],
                              0.5 * rows[:, 5], rows[:, 5] * rows[:, 5],
                              theta2, 1.0).numpy()
    jrows = jt.node_rows
    want = np.asarray(jtraverse._box_pass(
        jnp.asarray(gmin.numpy()), jnp.asarray(gmax.numpy()), jrows[:, 3],
        jrows[:, 4], 0.5 * jrows[:, 5], jrows[:, 5] * jrows[:, 5],
        jnp.float32(theta) * jnp.float32(theta), jnp.float32(1.0)))
    bad = np.argwhere(got != want)
    if not len(bad):
        return "no pass decision differs on the port's group boxes"
    g, n = bad[0]
    return (f"{len(bad)} MAC decisions flipped; first: group {g} box "
            f"{gmin[g].tolist()}..{gmax[g].tolist()} node {n} centre "
            f"({float(rows[n, 3])}, {float(rows[n, 4])}) side "
            f"{float(rows[n, 5])}: port {got[g, n]} jax {want[g, n]}")


@pytest.mark.parametrize("theta", THETAS)
@pytest.mark.parametrize("trav", TRAVERSALS)
def test_traversal_matches_jax(passes, trav, theta):
    want, jst = passes["jax", trav, theta]
    got, tst = passes["torch", trav, theta]
    needs = {f: (int(getattr(tst, f)), int(getattr(jst, f))) for f in NEEDS}
    if any(a != b for a, b in needs.values()):
        pytest.fail(f"needs (port, jax) {needs}: "
                    f"{_first_flip(*passes['trees'], theta)}")
    if trav == "hier":
        np.testing.assert_array_equal(tst.cand_need.numpy(),
                                      np.asarray(jst.cand_need))
    else:
        assert tst.cand_need is None and jst.cand_need is None
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-5 * np.abs(want).max())
    caps = dict(CAPS_DICT, num_nodes=passes["num_nodes"])
    assert not bool(tst.overflowed(caps))


@pytest.mark.parametrize("theta", THETAS)
def test_dense_equals_bfs_bitwise(passes, theta):
    acc_d, st_d = passes["torch", "dense", theta]
    acc_b, st_b = passes["torch", "bfs", theta]
    assert torch.equal(acc_d, acc_b)
    for f in NEEDS:
        if f != "frontier_need":
            assert int(getattr(st_d, f)) == int(getattr(st_b, f)), f
    assert int(st_b.frontier_need) > 0 == int(st_d.frontier_need)


@pytest.mark.parametrize("theta", THETAS)
def test_hier_equals_dense(passes, theta):
    acc_d, st_d = passes["torch", "dense", theta]
    acc_h, st_h = passes["torch", "hier", theta]
    scale = float(acc_d.abs().max())
    torch.testing.assert_close(acc_h, acc_d, rtol=0, atol=2e-5 * scale)
    # hier counts direct bodies per final chunk, a superset of each member
    # group's list
    assert int(st_h.direct_need) >= int(st_d.direct_need)
    assert int(st_h.group_size_need) == int(st_d.group_size_need)
    assert int(st_h.cand_need.max()) > 0


def test_flatten_offsets_ignore_tf32(passes):
    """The hier partner flatten finds its slots with integer searches, so
    the forces are the same bits whatever the matmul precision flag says."""
    _, tt = passes["trees"]
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        acc, _ = _torch_pass(tt, 0.3, traversal="hier")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert torch.equal(acc, passes["torch", "hier", 0.3][0])


def test_flatten_ranges_matches_repeat():
    """Slots against numpy's run-length expansion, past 2^20 bodies."""
    rng = np.random.default_rng(0)
    G, L, DB = 5, 40, 300
    counts = rng.integers(0, 17, (G, L)).astype(np.int32)
    counts[0] = 0                                   # a row with no partner
    counts[1, :] = 16                               # a row that overflows DB
    lstart = rng.integers(0, (1 << 20) + 5000, (G, L)).astype(np.int32)
    slots, leaf, valid, total = ttraverse._flatten_ranges(
        torch.from_numpy(lstart), torch.from_numpy(counts), DB)
    assert slots.dtype == torch.int32
    np.testing.assert_array_equal(total.numpy(), counts.sum(1))
    assert int(total[1]) > DB
    for g in range(G):
        want = np.concatenate([lstart[g, l] + np.arange(counts[g, l])
                               for l in range(L)] + [np.zeros(0, int)])[:DB]
        k = len(want)
        assert valid[g].numpy().tolist() == [True] * k + [False] * (DB - k)
        np.testing.assert_array_equal(slots[g, :k].numpy(), want)
        assert (slots[g, k:] == 0).all()
        np.testing.assert_array_equal(
            leaf[g, :k].numpy(), np.repeat(np.arange(L), counts[g])[:DB])


def test_compact_rows_matches_nonzero():
    rng = np.random.default_rng(1)
    mask = rng.random((6, 50)) < 0.3
    mask[0] = False
    mask[1] = True
    idx, length, total = ttraverse._compact_rows(torch.from_numpy(mask), 12)
    assert idx.shape == (6, 12) and idx.dtype == torch.int32
    for g in range(6):
        ids = np.flatnonzero(mask[g])
        assert int(total[g]) == len(ids)
        assert int(length[g]) == min(len(ids), 12)
        want = np.zeros(12, int)
        want[:min(len(ids), 12)] = ids[:12]
        np.testing.assert_array_equal(idx[g].numpy(), want)


@pytest.mark.parametrize("G,sizes,want", [
    (2080, (1024, 64, 8), ([1024, 64, 8], [0, 1, 2])),
    (512, (1024, 64, 8), ([64, 8], [1, 2])),
    (512, (64, 48, 8), ([64, 8], [0, 2])),          # 48 does not divide 64
    (4, (1024, 64, 8), ([4], [2])),                 # no level below G
])
def test_hier_levels(G, sizes, want):
    got_sizes, kcaps, lvl_map = ttraverse._hier_levels(
        G, 1000, sizes, (131072, 32768, 512))
    assert (got_sizes, lvl_map) == want
    assert kcaps == [min(c, 1000) for c in
                     [(131072, 32768, 512)[i] for i in lvl_map]]


def test_overflow_is_reported():
    jt, tt, num_nodes = _trees(*_galaxy(1000, 1024))
    _, jst = _jax_pass(jt, 0.3, direct_body_cap=16)
    _, tst = _torch_pass(tt, 0.3, direct_body_cap=16)
    assert int(tst.direct_need) == int(jst.direct_need) > 16
    caps = dict(CAPS_DICT, num_nodes=num_nodes, direct_body_cap=16)
    assert bool(tst.overflowed(caps))
    assert not bool(tst.overflowed(dict(caps, direct_body_cap=4096)))


def test_hier_cand_overflow_is_reported(passes):
    jt, tt = passes["trees"]
    kw = dict(traversal="hier", hier_sizes=(64, 8), cand_caps=(16, 16))
    _, jst = _jax_pass(jt, 0.3, **kw)
    _, tst = _torch_pass(tt, 0.3, **kw)
    np.testing.assert_array_equal(tst.cand_need.numpy(),
                                  np.asarray(jst.cand_need))
    caps = dict(CAPS_DICT, num_nodes=passes["num_nodes"])
    assert bool(tst.overflowed(dict(caps, cand_caps=(16, 16))))
    assert not bool(tst.overflowed(dict(caps, cand_caps=(100000, 100000))))
    host = tst.on_host(tst.flat().tolist())         # the same on host ints
    assert host.overflowed(dict(caps, cand_caps=(16, 16))) is True
    assert host.overflowed(dict(caps, cand_caps=(100000, 100000))) is False


def test_max_stats_takes_every_field():
    a = ttraverse.TraversalStats(*[torch.tensor(i, dtype=torch.int32)
                                   for i in (1, 9, 3, 0, 5, 6, 7)],
                                 torch.tensor([0, 4, 2], dtype=torch.int32))
    b = ttraverse.TraversalStats(*[torch.tensor(i, dtype=torch.int32)
                                   for i in (2, 8, 3, 1, 4, 7, 7)],
                                 torch.tensor([1, 3, 2], dtype=torch.int32))
    m = ttraverse.max_stats(a, b)
    assert m.flat().tolist() == [2, 9, 3, 1, 5, 7, 7, 1, 4, 2]
    assert ttraverse.max_stats(None, a) is a
    assert ttraverse.max_stats(a, None) is a
    assert ttraverse.max_stats(None, None) is None


def test_bh_matches_exact_at_tiny_theta():
    """theta -> 0 opens everything: BH == all-pairs to f32 precision."""
    pos, mass, alive = _galaxy(300, 512)
    _, tt, _ = _trees(pos, mass, alive)
    acc, st = _torch_pass(tt, 1e-3, direct_body_cap=512, approx_cap=4096,
                          frontier_cap=2048)
    assert int(st.direct_need) == 300
    ref = tforces.accel_allpairs(torch.from_numpy(pos),
                                 torch.from_numpy(mass), 80.0, 1.0)
    rel = ((acc - ref).norm(dim=1) / (ref.norm(dim=1) + 1e-9))[
        torch.from_numpy(alive)]
    assert float(rel.max()) < 1e-3


def test_unknown_traversal_raises(passes):
    with pytest.raises(ValueError, match="traversal"):
        _torch_pass(passes["trees"][1], 0.3, traversal="waves")
