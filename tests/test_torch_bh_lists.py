"""The hier traversal's candidate lists and their needs
(``traverse.hier_lists``, kernel ``csrc/bh_lists.cu``) against their plain
version ``traverse.hier_lists_ref`` (``_hier_lists`` and ``_hier_needs``).

On the CPU: the launch plan of each level (widths, segments, child
blocks, the scratch it takes), the bytes count, the CPU path (the plain
version, no launch), and the wrapper's refusals (dtype, shape, levels,
slots, mixed devices, tensors off the CPU where no card is).

On the card (marker ``cuda``, skipped without one): every level's ids,
validity and exact totals, the last level's validity, ``leaf_need``,
``direct_need`` and ``cand_need`` ``torch.equal`` to the plain version's
on the same card tensors, on two-disk scenes at small N with several
(sizes, caps) sets (hier sizes (64, 8) among them, more than 32 children a
parent, one level), caps that overflow (lists clipped, totals exact),
groups padded to whole chunks, coincident bodies, a root without mass,
and at the Barnes–Hut cell's shape (N = 1M, its configuration's caps);
and a whole ``bh_accel_from_tree(traversal="hier")`` pass bitwise equal,
accelerations and needs, with the kernel's lists and with the plain
ones.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_nbody_torch.kernels import _build
from tpu_nbody_torch.ops import traverse as ttraverse
from tpu_nbody_torch.ops import tree as ttree

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
BH_CELL = ROOT / "nbody_bench" / "configs" / "collide1m_bh.json"
ORIGIN, SIDE = (-2.0, -1202.0), 2404.0
SOFT2 = 1.0


def _bodies(n, cap, seed, *, clumps=0, negative=False):
    """Two disks of ``n`` bodies (4/5 and 1/5) in ``cap`` slots, numpy.
    ``clumps`` piles that many bodies of the small disk on one point
    each of three points; ``negative`` gives every other body of the
    large disk a negative mass, so the root holds none."""
    rng = np.random.default_rng(seed)
    n2 = n // 5
    pos = np.zeros((cap, 2), np.float32)
    mass = np.zeros(cap, np.float32)
    for lo, hi, cx, cy, rad in ((0, n - n2, 1200.0, 400.0, 300.0),
                                (n - n2, n, 1200.0, 160.0, 100.0)):
        r = rad * np.sqrt(rng.random(hi - lo))
        th = 2 * np.pi * rng.random(hi - lo)
        pos[lo:hi, 0] = cx + r * np.cos(th)
        pos[lo:hi, 1] = cy + r * np.sin(th)
        mass[lo:hi] = rng.uniform(0.5, 2.0, hi - lo)
    for k in range(3 if clumps else 0):
        s = n - n2 + k * clumps
        pos[s:s + clumps] = pos[s]
    if negative:
        mass[0:n - n2:2] *= -3.0
    return pos, mass, np.arange(cap) < n


def _tree(pos, mass, alive, dev, leaf_size=8):
    cap = pos.shape[0]
    t = lambda x: torch.from_numpy(x).to(dev)   # noqa: E731
    return ttree.build_tree(t(pos), t(mass), t(alive), ORIGIN, SIDE,
                            num_nodes=8 * (cap // 8) + 64,
                            leaf_size=leaf_size, max_depth=10)


def _captured(tree, theta, *, group_size, group_cap, sizes, caps,
              leaf_list_cap=1 << 20):
    """The arguments a hier pass over ``tree`` hands ``hier_lists``:
    (positional, keyword). The pass builds and measures the lists only."""
    got = {}
    real = ttraverse.hier_lists

    def spy(*args, **kw):
        got.update(args=args, kw=kw)
        return real(*args, **kw)

    ttraverse.hier_lists = spy
    try:
        ttraverse.bh_accel_from_tree(
            tree, theta, SOFT2, 1.0, group_size=group_size,
            group_cap=group_cap, max_depth=10, frontier_cap=64,
            approx_cap=64, leaf_list_cap=leaf_list_cap,
            direct_body_cap=1 << 20, group_chunk=64, traversal="hier",
            hier_sizes=sizes, cand_caps=caps, hier_batch=5, evaluate=False)
    finally:
        ttraverse.hier_lists = real
    return got["args"], got["kw"]


def _small_case():
    pos, mass, alive = _bodies(600, 1024, 3)
    return _captured(_tree(pos, mass, alive, "cpu"), 0.5, group_size=16,
                     group_cap=128, sizes=(64, 8), caps=(512, 256))


# ---- on the CPU ----

def test_plan_at_the_bh_cell_shape():
    """The cell's levels: 7, 112 and 896 chunks; the first list as wide as
    the node table, the later ones clipped to the cap."""
    got = ttraverse._lists_plan(272384, 7168, (1024, 64, 8),
                                (272384, 131072, 131072))
    assert got == [ttraverse.ListsLevel(7, 7, 272384, 272384, 266, 1),
                   ttraverse.ListsLevel(112, 16, 272384, 131072, 266, 1),
                   ttraverse.ListsLevel(896, 8, 131072, 131072, 128, 1)]
    assert ttraverse._lists_scratch(got) == 16 * (7 + 112 + 896) + 4 * (
        7 * 266 + 112 * 266 + 896 * 128 + 896 * (128 + 2))


@pytest.mark.parametrize("NC,g_pad,sizes,kcaps,want", [
    # a width past the parent's is clipped to it; the first is not
    (100, 64, (16, 4), (5000, 9000),
     [(4, 4, 100, 5000, 1, 1), (16, 4, 5000, 5000, 5, 1)]),
    # 64 children a parent: two blocks of 32
    (3000, 512, (64, 1), (2048, 1024),
     [(8, 8, 3000, 2048, 3, 1), (512, 64, 2048, 1024, 2, 2)]),
    # one level of one chunk: the whole group table
    (40, 24, (24,), (40,), [(1, 1, 40, 40, 1, 1)]),
    # a width of 0 leaves nothing to refine
    (40, 16, (8, 4), (0, 7), [(2, 2, 40, 0, 1, 1), (4, 2, 0, 0, 0, 1)])])
def test_plan_widths_segments_and_blocks(NC, g_pad, sizes, kcaps, want):
    got = ttraverse._lists_plan(NC, g_pad, sizes, kcaps)
    assert [tuple(lv) for lv in got] == want


@pytest.mark.parametrize("sizes,kcaps", [
    ((48, 8), (64, 64)),         # 48 does not divide 512 groups
    ((64, 24), (64, 64)),        # 24 does not divide 64
    ((64, 8), (64,)),            # a cap short
    ((), ()),                    # no level
    ((64, 8), (64, -1)),         # a negative cap
    ((256, 128, 64, 32, 16, 8, 4, 2, 1), (8,) * 9)])   # past 8 levels
def test_plan_refuses_levels_the_kernel_cannot_take(sizes, kcaps):
    with pytest.raises(ValueError):
        ttraverse._lists_plan(1000, 512, sizes, kcaps)


def test_lists_work_counts_entries_lists_and_validity():
    """Level 0 reads the nodes in use (20 bytes each), level 1 each valid
    parent entry (24 bytes); both write their padded lists and totals."""
    levels = ttraverse._lists_plan(100, 16, (8, 4), (50, 30))
    totals = (torch.tensor([20, 70], dtype=torch.int32),
              torch.tensor([3, 0, 40, 9], dtype=torch.int32))
    w = ttraverse.lists_work(levels, totals, 90, 16)
    read = 90 * 20 + 16 * 16 + (20 + 50) * 24 + 16 * 16
    written = 2 * 51 * 4 + 4 * 31 * 4 + 4 * 30
    assert w == dict(bytes=read + written, flops=21 * (90 * 2 + 70 * 2))


def test_cpu_tensors_take_the_plain_version():
    """The wrapper's CPU path is hier_lists_ref, bit for bit; no launch."""
    args, kw = _small_case()
    n0 = _build.LAUNCHES["bh_lists"]
    got = ttraverse.hier_lists(*args, **kw)
    want = ttraverse.hier_lists_ref(*args, **kw)
    assert _build.LAUNCHES["bh_lists"] == n0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert got[2].shape == got[3].shape == ()
    assert got[4].shape == (2,) and bool((got[4] > 0).all())


@pytest.mark.parametrize("what,change,err", [
    ("gmin float64", lambda a: (a[0], a[1].double()) + a[2:], TypeError),
    ("node rows float64",
     lambda a: (a[0]._replace(node_rows=a[0].node_rows.double()),)
     + a[1:], TypeError),
    ("n_nodes int64",
     lambda a: (a[0]._replace(n_nodes=a[0].n_nodes.long()),) + a[1:],
     TypeError),
    ("gmin of 3 lanes",
     lambda a: (a[0], torch.cat([a[1], a[1][:, :1]], 1)) + a[2:],
     ValueError),
    ("gmax one group short", lambda a: a[:2] + (a[2][1:],) + a[3:],
     ValueError),
    ("node rows of 13 lanes",
     lambda a: (a[0]._replace(node_rows=a[0].node_rows[:, :13]),)
     + a[1:], ValueError),
    ("n_nodes of shape (1,)",
     lambda a: (a[0]._replace(n_nodes=a[0].n_nodes.reshape(1)),)
     + a[1:], ValueError)])
def test_hier_lists_refuses_bad_arguments(what, change, err):
    """Dtypes and shapes are checked on any device, before any path."""
    args, kw = _small_case()
    n0 = _build.LAUNCHES["bh_lists"]
    with pytest.raises(err):
        ttraverse.hier_lists(*change(args), **kw)
    assert _build.LAUNCHES["bh_lists"] == n0


@pytest.mark.parametrize("kw_change", [
    dict(slots=(0,)), dict(slots=(0, 2)), dict(sizes=(64, 7)),
    dict(kcaps=(512,))])
def test_hier_lists_refuses_bad_levels_and_slots(kw_change):
    args, kw = _small_case()
    with pytest.raises(ValueError):
        ttraverse.hier_lists(*args, **dict(kw, **kw_change))


def _meta_tree(tree):
    return tree._replace(node_rows=tree.node_rows.to("meta"),
                         n_nodes=tree.n_nodes.to("meta"))


def test_hier_lists_refuses_mixed_devices():
    """A tensor off the CPU sends the call to the kernel's checks, which
    refuse a CPU tensor beside it; the plain version is not taken."""
    args, kw = _small_case()
    n0 = _build.LAUNCHES["bh_lists"]
    for bad in ((args[0], args[1].to("meta")) + args[2:],
                (_meta_tree(args[0]),) + args[1:]):
        with pytest.raises(ValueError, match="CUDA tensor"):
            ttraverse.hier_lists(*bad, **kw)
    assert _build.LAUNCHES["bh_lists"] == n0


def test_hier_lists_refuses_tensors_off_the_cpu_without_a_card():
    """Every tensor off the CPU and no CUDA tensor among them (here: no
    card at all): the wrapper raises, with no launch and no fallback."""
    args, kw = _small_case()
    meta = (_meta_tree(args[0]), args[1].to("meta"),
            args[2].to("meta")) + args[3:]
    n0 = _build.LAUNCHES["bh_lists"]
    with pytest.raises(ValueError, match="CUDA tensor"):
        ttraverse.hier_lists(*meta, **kw)
    assert _build.LAUNCHES["bh_lists"] == n0


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _plain_levels(args, kw):
    """Each level's (ids, valid, totals) of the plain _hier_lists on the
    same tensors: the lists of each prefix of the levels, and the exact
    totals _compact_rows returns on the way, in call order."""
    tree, gmin, gmax, theta2, soft2 = args
    sizes, kcaps = kw["sizes"], kw["kcaps"]
    out = []
    for i in range(len(sizes)):
        ids, valid, _, _ = ttraverse._hier_lists(
            tree, gmin, gmax, theta2, soft2, g_pad=gmin.shape[0],
            sizes=sizes[:i + 1], kcaps=kcaps[:i + 1])
        out.append([ids, valid])
    seen = []
    real = ttraverse._compact_rows

    def spy(mask, cap_):
        res = real(mask, cap_)
        seen.append(res[2])
        return res

    ttraverse._compact_rows = spy
    try:
        ttraverse._hier_lists(tree, gmin, gmax, theta2, soft2,
                              g_pad=gmin.shape[0], sizes=sizes, kcaps=kcaps)
    finally:
        ttraverse._compact_rows = real
    totals = torch.cat(seen).split([ids.shape[0] for ids, _ in out])
    return [(ids, valid, t) for (ids, valid), t in zip(out, totals)]


def _kernel(args, kw):
    """The kernel's HierLists on captured hier_lists arguments."""
    tree, gmin, gmax, theta2, soft2 = args
    levels = ttraverse._lists_plan(tree.node_rows.shape[0], gmin.shape[0],
                                   kw["sizes"], kw["kcaps"])
    return ttraverse._lists_launch(
        tree.node_rows, tree.n_nodes, gmin, gmax, theta2, soft2, levels,
        kw["slots"], kw["n_slots"],
        min(kw["leaf_list_cap"], levels[-1].K))


def _assert_lists_equal(args, kw):
    """Every level's lists, validity and totals and the needs, bit for
    bit; one launch. Returns the kernel's HierLists."""
    n0 = _build.LAUNCHES["bh_lists"]
    got = _kernel(args, kw)
    want = _plain_levels(args, kw)
    ids, cvalid, leaf, direct, cand = ttraverse.hier_lists_ref(*args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bh_lists"] == n0 + 1
    for lvl, (g_ids, g_tot, (w_ids, w_valid, w_tot)) in enumerate(
            zip(got.ids, got.totals, want)):
        K = g_ids.shape[1]
        g_valid = torch.arange(K, device=g_ids.device)[None, :] \
            < torch.clamp(g_tot, max=K)[:, None]
        assert torch.equal(g_tot, w_tot), f"level {lvl}: totals"
        assert torch.equal(g_valid, w_valid), f"level {lvl}: validity"
        assert torch.equal(g_ids, w_ids), f"level {lvl}: ids"
    assert torch.equal(got.cvalid, cvalid) and torch.equal(got.ids[-1], ids)
    assert torch.equal(got.leaf_need, leaf)
    assert torch.equal(got.direct_need, direct)
    assert torch.equal(got.cand_need, cand)
    # the wrapper launches the same
    out = ttraverse.hier_lists(*args, **kw)
    for g, w in zip(out, (ids, cvalid, leaf, direct, cand)):
        assert torch.equal(g, w)
    return got


CASES = {
    # name: bodies kw, pass kw
    "disk (64, 8)": (dict(n=3000, cap=4096, seed=1),
                     dict(group_size=16, group_cap=512, sizes=(64, 8),
                          caps=(4096, 4096))),
    "three levels": (dict(n=6000, cap=8192, seed=2),
                     dict(group_size=16, group_cap=1024,
                          sizes=(256, 32, 4), caps=(8192, 4096, 2048))),
    "64 children a parent": (dict(n=3000, cap=4096, seed=3),
                             dict(group_size=16, group_cap=512,
                                  sizes=(64, 1), caps=(4096, 4096))),
    "one level": (dict(n=2000, cap=2048, seed=4),
                  dict(group_size=32, group_cap=256, sizes=(8,),
                       caps=(4096,))),
    "groups padded": (dict(n=3000, cap=4096, seed=5),
                      dict(group_size=16, group_cap=500, sizes=(64, 8),
                           caps=(4096, 4096))),
    "caps overflow": (dict(n=3000, cap=4096, seed=6),
                      dict(group_size=16, group_cap=512, sizes=(64, 8),
                           caps=(96, 40), leaf_list_cap=5)),
    "coincident bodies": (dict(n=3000, cap=4096, seed=7, clumps=150),
                          dict(group_size=16, group_cap=512,
                               sizes=(64, 8), caps=(4096, 4096),
                               leaf_list_cap=9)),
    "root without mass": (dict(n=3000, cap=4096, seed=8, negative=True),
                          dict(group_size=16, group_cap=512,
                               sizes=(64, 8), caps=(4096, 4096))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("theta", [0.3, 0.7])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_lists_equal_plain_on_card(cuda_device, case, theta):
    bodies, kw = CASES[case]
    pos, mass, alive = _bodies(**bodies)
    args, lkw = _captured(_tree(pos, mass, alive, cuda_device), theta, **kw)
    got = _assert_lists_equal(args, lkw)
    totals = [int(t.max()) for t in got.totals]
    if case == "caps overflow":
        # the first level's lists clipped, their totals past the width
        assert totals[0] > got.ids[0].shape[1]
        assert int(got.leaf_need) > 0
    else:
        assert all(t <= lv.shape[1] for t, lv in zip(totals, got.ids))
    if case == "groups padded":
        assert args[1].shape[0] > 500
    if case == "root without mass":
        # level 0's lists that hold any start past the root, so the later
        # tails are not 0
        held = got.ids[0][got.totals[0] > 0]
        assert held.shape[0] > 0 and int(held[:, 0].min()) > 0
        assert bool((got.ids[1][:, -1] != 0).any())


@pytest.mark.cuda
def test_kernel_lists_equal_plain_at_the_bh_cell_shape(cuda_device):
    """N = 1M on the cell's two-disk scene and its configuration's caps
    (node table, groups, hier sizes and candidate caps)."""
    from tpu_nbody_torch.config import SimConfig
    from tpu_nbody_torch.engine import Engine, make_bh_accel

    cell = json.loads(BH_CELL.read_text())
    sim = {k: tuple(v) if isinstance(v, list) else v
           for k, v in cell["sim_config"].items()}
    cfg = SimConfig(capacity=cell["capacity"], world_w=cell["world_w"],
                    world_h=cell["world_h"], **sim)
    eng = Engine(cfg, solver="bh", device=cuda_device, seed=5)
    n2 = cell["n_bodies"] // 5
    eng.reset_default_scene(n1=cell["n_bodies"] - n2, n2=n2)
    got = {}
    real = ttraverse.hier_lists

    def spy(*args, **kw):
        got.update(args=args, kw=kw)
        return real(*args, **kw)

    ttraverse.hier_lists = spy
    try:
        accel = make_bh_accel(cfg, eng.caps, evaluate=False)
        st = eng.state
        accel(st.pos, st.mass, st.alive, eng.params)
    finally:
        ttraverse.hier_lists = real
    args, kw = got["args"], got["kw"]
    assert kw["sizes"] == [1024, 64, 8] and args[1].shape[0] == 7168
    out = _assert_lists_equal(args, kw)
    assert [t.shape[0] for t in out.totals] == [7, 112, 896]


@pytest.mark.cuda
def test_hier_pass_with_kernel_lists_is_the_plain_lists_pass(cuda_device):
    """A whole bh_accel_from_tree(traversal="hier") pass, the evaluation
    included: accelerations and every need bit for bit whether its lists
    come from the kernel or from the plain version."""
    pos, mass, alive = _bodies(6000, 8192, 9)
    tree = _tree(pos, mass, alive, cuda_device)
    kw = dict(group_size=32, group_cap=1024, max_depth=10, frontier_cap=64,
              approx_cap=64, leaf_list_cap=4096, direct_body_cap=1 << 16,
              group_chunk=64, traversal="hier", hier_sizes=(128, 16, 4),
              cand_caps=(8192, 4096, 2048), hier_batch=7)
    n0 = _build.LAUNCHES["bh_lists"]
    acc, stats = ttraverse.bh_accel_from_tree(tree, 0.5, SOFT2, 80.0, **kw)
    assert _build.LAUNCHES["bh_lists"] == n0 + 1
    real = ttraverse.hier_lists
    ttraverse.hier_lists = ttraverse.hier_lists_ref
    try:
        acc_p, stats_p = ttraverse.bh_accel_from_tree(tree, 0.5, SOFT2,
                                                      80.0, **kw)
    finally:
        ttraverse.hier_lists = real
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bh_lists"] == n0 + 1
    assert torch.equal(acc, acc_p) and bool(acc.abs().max() > 0)
    assert torch.equal(stats.flat(), stats_p.flat())
