"""Port parity: Morton and Hilbert codes, the flat quadtree build, the
strict-parity nudge and the merger scene, against tpu_nbody on the same
numpy inputs; plus the tree invariants of tests/test_tree.py on the port's
tree and the accuracy of its range sums at a large coordinate offset."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nbody import config as jconfig
from tpu_nbody.models import scenes as jscenes
from tpu_nbody.ops import morton as jmorton
from tpu_nbody.ops import tree as jtree
from tpu_nbody_torch import config as tconfig
from tpu_nbody_torch.models import scenes as tscenes
from tpu_nbody_torch.ops import morton as tmorton
from tpu_nbody_torch.ops import tree as ttree

torch.set_num_threads(2)

MAX_DEPTH = 8
INT_FIELDS = ("code", "level", "start", "count", "child", "n_children",
              "parent", "n_nodes", "node_need", "sidx", "unsort", "n_alive")
# node_rows columns that come from integers: cell and parent-cell geometry,
# child, nchild, start, count, has_parent
GEOMETRY_COLS = [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13]


def _origin_side():
    cfg = tconfig.SimConfig(capacity=1)
    return ((cfg.root_center[0] - cfg.root_half,
             cfg.root_center[1] - cfg.root_half), 2 * cfg.root_half)


def _random_scene(seed, n, cap):
    rng = np.random.default_rng(seed)
    pos = np.zeros((cap, 2), np.float32)
    pos[:n] = rng.random((n, 2)) * [2400, 800]
    mass = np.zeros(cap, np.float32)
    mass[:n] = rng.random(n) + 0.5
    return pos, mass, np.arange(cap) < n


def _galaxy(n, cap):
    p, _, m = jscenes.make_galaxy_disk(jax.random.PRNGKey(42), n, r=300.0)
    pos = np.zeros((cap, 2), np.float32)
    pos[:n] = np.asarray(p)
    mass = np.zeros(cap, np.float32)
    mass[:n] = np.asarray(m)
    return pos, mass, np.arange(cap) < n


def _tbuild(pos, mass, alive, cap_nodes=4096, leaf=8, max_depth=MAX_DEPTH):
    origin, side = _origin_side()
    return ttree.build_tree(torch.from_numpy(pos), torch.from_numpy(mass),
                            torch.from_numpy(alive), origin, side,
                            num_nodes=cap_nodes, leaf_size=leaf,
                            max_depth=max_depth)


def _jbuild(pos, mass, alive, cap_nodes=4096, leaf=8):
    origin, side = _origin_side()
    return jtree.build_tree(jnp.asarray(pos), jnp.asarray(mass),
                            jnp.asarray(alive), origin, side,
                            num_nodes=cap_nodes, leaf_size=leaf,
                            max_depth=MAX_DEPTH)


# -- morton -----------------------------------------------------------------


@pytest.mark.parametrize("fn", ["encode2d", "hilbert2d"])
def test_codes_bit_equal(fn):
    rng = np.random.default_rng(0)
    ix = rng.integers(0, 1 << 15, 4000).astype(np.int32)
    iy = rng.integers(0, 1 << 15, 4000).astype(np.int32)
    ix[:4], iy[:4] = [0, 32767, 0, 32767], [0, 0, 32767, 32767]
    want = np.asarray(getattr(jmorton, fn)(jnp.asarray(ix), jnp.asarray(iy)))
    got = getattr(tmorton, fn)(torch.from_numpy(ix), torch.from_numpy(iy))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fn", ["decode2d", "hilbert2d_inverse"])
def test_inverse_codes_bit_equal_and_roundtrip(fn):
    rng = np.random.default_rng(1)
    code = rng.integers(0, 1 << 30, 4000).astype(np.int32)
    code[:2] = [0, (1 << 30) - 1]
    wx, wy = getattr(jmorton, fn)(jnp.asarray(code))
    gx, gy = getattr(tmorton, fn)(torch.from_numpy(code))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))
    forward = {"decode2d": tmorton.encode2d,
               "hilbert2d_inverse": tmorton.hilbert2d}[fn]
    np.testing.assert_array_equal(forward(gx, gy).numpy(), code)


def test_morton_codes_match_jax():
    pos, _, alive = _random_scene(2, 700, 1024)
    pos[5] = [-50.0, 9000.0]                       # clamps to an edge cell
    origin, side = _origin_side()
    want = np.asarray(jmorton.morton_codes(jnp.asarray(pos), origin, side,
                                           jnp.asarray(alive)))
    got = tmorton.morton_codes(torch.from_numpy(pos), origin, side,
                               torch.from_numpy(alive))
    np.testing.assert_array_equal(got.numpy(), want)


# -- build_tree against the JAX package -------------------------------------


@pytest.mark.parametrize("scene,cap_nodes,leaf", [
    (("random", 3, 900, 1024), 4096, 8), (("random", 4, 500, 512), 4096, 4),
    (("random", 5, 300, 512), 4096, 8), (("galaxy", 1500, 1536), 1600, 8),
    (("random", 6, 900, 1024), 200, 4),            # a saturated node table
], ids=lambda x: "-".join(map(str, x)) if isinstance(x, tuple) else str(x))
def test_build_tree_matches_jax(scene, cap_nodes, leaf):
    pos, mass, alive = (_random_scene(*scene[1:]) if scene[0] == "random"
                        else _galaxy(*scene[1:]))
    want = _jbuild(pos, mass, alive, cap_nodes, leaf)
    got = _tbuild(pos, mass, alive, cap_nodes, leaf)
    for f in INT_FIELDS:
        g = getattr(got, f)
        assert g.dtype == torch.int32, f
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("spos", "smass", "body_rows", "origin", "root_side"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    rows, jrows = got.node_rows.numpy(), np.asarray(want.node_rows)
    np.testing.assert_array_equal(rows[:, GEOMETRY_COLS],
                                  jrows[:, GEOMETRY_COLS])
    np.testing.assert_allclose(rows[:, :3], jrows[:, :3], rtol=1e-6)
    np.testing.assert_allclose(got.mass.numpy(), np.asarray(want.mass),
                               rtol=1e-6)
    np.testing.assert_allclose(got.com.numpy(), np.asarray(want.com),
                               rtol=1e-6)
    if cap_nodes == 200:
        assert int(got.node_need) > 200 == int(got.n_nodes)


def test_cell_geometry_and_debug_boxes_match_jax():
    pos, mass, alive = _random_scene(7, 500, 512)
    want = jtree.debug_boxes(_jbuild(pos, mass, alive, leaf=4))
    got = ttree.debug_boxes(_tbuild(pos, mass, alive, leaf=4))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the invariants of tests/test_tree.py on the port's tree ------------------


def _np_tree(t):
    n = int(t.n_nodes)
    return n, {f: getattr(t, f).numpy()[:n]
               for f in ("child", "n_children", "count", "start", "mass")}


def test_tree_mass_and_com():
    pos, mass, alive = _random_scene(8, 900, 1024)
    t = _tbuild(pos, mass, alive)
    np.testing.assert_allclose(float(t.mass[0]), float(mass.sum()), rtol=1e-5)
    want_com = (mass[:, None] * pos).sum(0) / mass.sum()
    np.testing.assert_allclose(t.com[0].numpy(), want_com, rtol=1e-4)
    assert int(t.n_alive) == 900


def test_tree_children_partition_parent():
    pos, mass, alive = _random_scene(9, 900, 1024)
    n, t = _np_tree(_tbuild(pos, mass, alive))
    for i in range(n):
        if t["child"][i] >= 0:
            c, k = t["child"][i], t["n_children"][i]
            assert 1 <= k <= 4
            assert t["count"][c:c + k].sum() == t["count"][i]
            assert (t["count"][c:c + k] > 0).all()   # only occupied children
            assert t["start"][c] == t["start"][i]
            for j in range(k - 1):                   # contiguous, in order
                assert t["start"][c + j] + t["count"][c + j] \
                    == t["start"][c + j + 1]
            np.testing.assert_allclose(t["mass"][c:c + k].sum(),
                                       t["mass"][i], rtol=1e-4)
        else:
            assert t["n_children"][i] == 0


def test_tree_leaves_partition_bodies():
    pos, mass, alive = _random_scene(10, 500, 512)
    n, t = _np_tree(_tbuild(pos, mass, alive, leaf=4))
    leaves = sorted((t["start"][i], t["count"][i]) for i in range(n)
                    if t["child"][i] < 0 and t["count"][i] > 0)
    covered = 0
    for s, c in leaves:
        assert s == covered
        covered += c
    assert covered == 500


def test_leaf_cells_contain_their_bodies():
    pos, mass, alive = _random_scene(11, 500, 512)
    tree = _tbuild(pos, mass, alive, leaf=4)
    n, t = _np_tree(tree)
    center, side = tree.cell_geometry(
        torch.arange(tree.code.shape[0], dtype=torch.int32))
    center, side, spos = center.numpy(), side.numpy(), tree.spos.numpy()
    for i in range(n):
        if t["child"][i] < 0 and t["count"][i] > 0:
            b = spos[t["start"][i]:t["start"][i] + t["count"][i]]
            assert (b >= center[i] - side[i] / 2 - 1e-3).all()
            assert (b <= center[i] + side[i] / 2 + 1e-3).all()


def test_dead_bodies_excluded():
    pos, mass, alive = _random_scene(12, 300, 512)
    t = _tbuild(pos, mass, alive)
    assert int(t.count[0]) == 300
    assert (t.smass.numpy()[300:] == 0).all()


def test_range_sums_keep_accuracy_at_a_large_offset():
    """131,072 bodies far from the origin: every leaf's centre of mass is
    within 1e-3 px of the float64 one, where differencing a plain float32
    cumsum of the same terms is off by more than ten times that."""
    rng = np.random.default_rng(13)
    n = 1 << 17
    pos = (rng.random((n, 2)) * [300, 300] + [2050, 450]).astype(np.float32)
    mass = (rng.random(n) + 0.5).astype(np.float32)
    tree = _tbuild(pos, mass, np.ones(n, bool), cap_nodes=1 << 16, leaf=16,
                   max_depth=10)
    n_nodes = int(tree.n_nodes)
    assert int(tree.node_need) == n_nodes
    leaf = (tree.child.numpy()[:n_nodes] < 0)
    start = tree.start.numpy()[:n_nodes][leaf]
    end = start + tree.count.numpy()[:n_nodes][leaf]
    spos, smass = tree.spos.numpy(), tree.smass.numpy()
    terms = smass[:, None] * spos                          # float32 products

    def com_from(prefix_m, prefix_mx):
        return (prefix_mx[end] - prefix_mx[start]) \
            / (prefix_m[end] - prefix_m[start])[:, None]

    def prefix(x, dtype):
        return np.concatenate([np.zeros((1,) + x.shape[1:], dtype),
                               np.cumsum(x.astype(dtype), axis=0,
                                         dtype=dtype)])

    exact = com_from(prefix(smass, np.float64), prefix(terms, np.float64))
    plain = com_from(prefix(smass, np.float32), prefix(terms, np.float32))
    got = tree.com.numpy()[:n_nodes][leaf]
    err = np.abs(got - exact).max()
    assert err <= 1e-3, err
    assert np.abs(plain - exact).max() > 10 * max(err, 1e-4)


def test_ids_past_float32_exactness_raise():
    with pytest.raises(ValueError, match="2\\^24"):
        ttree.check_id_range((1 << 24) + 1, 1024)
    pos = torch.zeros((8, 2))
    with pytest.raises(ValueError, match="2\\^24"):
        ttree.build_tree(pos, torch.ones(8), torch.ones(8, dtype=torch.bool),
                         (0.0, 0.0), 8.0, num_nodes=(1 << 24) + 1,
                         leaf_size=4, max_depth=4)
    ttree.check_id_range(1 << 24, 1 << 24)


# -- strict_parity_nudge ------------------------------------------------------


def _nudge_case():
    """The coincident pair, spectator and dead twin of
    tests/test_engine.py::test_strict_nudge_rule_and_masking."""
    cfg = tconfig.SimConfig(capacity=8)
    origin, side = _origin_side()
    d = math.ceil(math.log2(cfg.root_half / 1e-3))
    s = side / (1 << d)
    cx = (np.floor((np.float32(100.0) - origin[0]) / s) + 0.5) * s + origin[0]
    cy = (np.floor((300.0 - origin[1]) / s) + 0.5) * s + origin[1]
    b0 = np.array([cx, cy], np.float32)
    pos = np.zeros((8, 2), np.float32)
    pos[0], pos[1] = b0, np.nextafter(b0, np.float32(1e9), dtype=np.float32)
    pos[2] = pos[3] = [600.0, 200.0]
    alive = np.array([1, 1, 1, 0, 0, 0, 0, 0], bool)
    return pos, alive


def _crowd_case():
    """Many near-coincident clumps, some outside the root, some dead."""
    rng = np.random.default_rng(14)
    centres = rng.random((40, 2)) * [2400, 800]
    pos = (np.repeat(centres, 5, axis=0)
           + rng.random((200, 2)) * 4e-4).astype(np.float32)
    pos[:5] += 9000.0                               # outside the root quad
    alive = rng.random(200) < 0.9
    return pos, alive


@pytest.mark.parametrize("case,rounds", [("pair", 1), ("pair", 3),
                                         ("crowd", 1), ("crowd", 3)])
def test_strict_parity_nudge_bit_equal(case, rounds):
    pos, alive = _nudge_case() if case == "pair" else _crowd_case()
    origin, side = _origin_side()
    want = np.asarray(jtree.strict_parity_nudge(
        jnp.asarray(pos), jnp.asarray(alive), origin, side, rounds=rounds))
    got = ttree.strict_parity_nudge(torch.from_numpy(pos),
                                    torch.from_numpy(alive), origin, side,
                                    rounds=rounds).numpy()
    np.testing.assert_array_equal(got, want)
    moved = (got != pos).any(axis=1)
    assert moved.any() and not moved[~alive].any()
    if case == "pair":
        assert moved.tolist() == [True, True] + [False] * 6


# -- the merger scene ---------------------------------------------------------


def test_multi_galaxy_merger_layout_matches_jax():
    """The draws differ (another generator), the layout does not: each
    galaxy's central body (row 0 of its disk) sits at the JAX package's
    centre with its drift, galaxy 0 takes the remainder, and the masses
    agree."""
    n, k = 1003, 4
    jp, jv, jm = jscenes.multi_galaxy_merger(jax.random.PRNGKey(0),
                                             n_total=n, n_galaxies=k)
    tp, tv, tm = tscenes.multi_galaxy_merger(torch.Generator().manual_seed(0),
                                             n_total=n, n_galaxies=k)
    assert tp.shape == (n, 2) and tv.shape == (n, 2) and tm.shape == (n,)
    firsts = [0, 253, 503, 753]
    np.testing.assert_allclose(tp.numpy()[firsts], np.asarray(jp)[firsts],
                               rtol=1e-6)
    np.testing.assert_allclose(tv.numpy()[firsts], np.asarray(jv)[firsts],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.sort(tm.numpy()), np.sort(np.asarray(jm)),
                               rtol=1e-6)
    # satellites orbit: speeds of the same order as the JAX package's
    assert 0.5 < np.abs(tv.numpy()).mean() / np.abs(np.asarray(jv)).mean() < 2
