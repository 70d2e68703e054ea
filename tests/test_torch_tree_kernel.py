"""The Barnes–Hut tree build (``tree.build_tree``, kernels
``csrc/bh_tree.cu``) against its plain version ``tree.build_tree_ref``.

On the CPU: the CPU path (the plain version, no launch), the wrapper's
refusals (shapes, depth, leaf size, tensors off the CPU where no card
is), the bytes count and the float32 root geometry the kernels are
handed.

On the card (marker ``cuda``, skipped without one): the codes kernel bit
for bit against ``morton.hilbert_codes``, and every integer field of the
tree (node table, sorted order, inverse, counts), the sorted bodies, the
root geometry and the node rows' integer and geometry columns
``torch.equal`` to the plain version's on the same card tensors, with mass
and centre of mass within float32 rounding (1e-6 relative): on uniform and
two-disk scenes with dead slots between the alive ones and bodies outside
the root, no body and one body alive, coincident bodies down to the
deepest level, one crowded cell, node tables that overflow, several leaf
sizes and depths, and the Barnes–Hut cell's own state at 2^20 slots; one
``bh_tree`` launch a build, and the same bits from two builds.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_nbody_torch.kernels import _build
from tpu_nbody_torch.ops import morton
from tpu_nbody_torch.ops import tree as ttree

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
BH_CELL = ROOT / "nbody_bench" / "configs" / "collide1m_bh.json"
ORIGIN, SIDE = (-2.0, -1202.0), 2404.0
INT_FIELDS = ("code", "level", "start", "count", "child", "n_children",
              "parent", "n_nodes", "node_need", "sidx", "unsort", "n_alive")
EXACT_FIELDS = ("spos", "smass", "body_rows", "origin", "root_side")
# node_rows columns that come from integers and the cell geometry
EXACT_COLS = list(range(3, 14))


def _scene(kind, n, cap, seed):
    """(pos, mass, alive) numpy: ``n`` alive bodies scattered over ``cap``
    slots (the rest dead, at random positions). ``kind``: "uniform" over
    the world (a few outside the root), "disks" (two disks, 4/5 and 1/5),
    "coincident" (disks, with three piles of 100 bodies on one point),
    "crowded" (disks, with 1,500 bodies in a 1e-3 px square)."""
    rng = np.random.default_rng(seed)
    pos = (rng.random((cap, 2)) * [2400.0, 800.0]).astype(np.float32)
    body = np.zeros((n, 2), np.float32)
    if kind == "uniform":
        body[:] = rng.random((n, 2)) * [2400.0, 800.0]
        edge = np.array([[-50.0, 9000.0], [3000.0, -1500.0], [1e9, 1e9],
                         [-2.0, -1202.0], [2402.0, 1202.0]], np.float32)
        body[:min(n, 5)] = edge[:min(n, 5)]
    else:
        n2 = n // 5
        for lo, hi, cx, cy, rad in ((0, n - n2, 1200.0, 400.0, 300.0),
                                    (n - n2, n, 1200.0, 160.0, 100.0)):
            r = rad * np.sqrt(rng.random(hi - lo))
            th = 2 * np.pi * rng.random(hi - lo)
            body[lo:hi, 0] = cx + r * np.cos(th)
            body[lo:hi, 1] = cy + r * np.sin(th)
        if kind == "coincident":
            for k in range(3):
                body[100 * k:100 * (k + 1)] = body[100 * k]
        if kind == "crowded":
            body[:1500] = [700.0, 300.0] + rng.random((1500, 2)) * 1e-3
    slots = rng.permutation(cap)[:n]
    pos[slots] = body
    alive = np.zeros(cap, bool)
    alive[slots] = True
    mass = np.where(alive, rng.uniform(0.5, 2.0, cap), 0.0).astype(np.float32)
    return pos, mass, alive


def _build_on(dev, pos, mass, alive, fn=ttree.build_tree, **kw):
    t = lambda x: torch.from_numpy(x).to(dev)   # noqa: E731
    return fn(t(pos), t(mass), t(alive), ORIGIN, SIDE, **kw)


# ---- on the CPU ----

def test_cpu_tensors_take_the_plain_version():
    """The wrapper's CPU path is build_tree_ref, bit for bit; no launch."""
    pos, mass, alive = _scene("disks", 600, 1024, 1)
    kw = dict(num_nodes=700, leaf_size=8, max_depth=10)
    n0 = _build.LAUNCHES["bh_tree"]
    got = _build_on("cpu", pos, mass, alive, **kw)
    want = _build_on("cpu", pos, mass, alive, fn=ttree.build_tree_ref, **kw)
    assert _build.LAUNCHES["bh_tree"] == n0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got.n_alive) == 600 and int(got.n_nodes) > 1


@pytest.mark.parametrize("what,change", [
    ("pos of 3 lanes", lambda a: (torch.zeros((64, 3)),) + a[1:]),
    ("pos of one dimension", lambda a: (torch.zeros(128),) + a[1:]),
    ("no slot", lambda a: (torch.zeros((0, 2)), torch.zeros(0),
                           torch.zeros(0, dtype=torch.bool))),
    ("mass one short", lambda a: (a[0], a[1][1:], a[2])),
    ("alive one long",
     lambda a: a[:2] + (torch.ones(65, dtype=torch.bool),))])
def test_build_tree_refuses_bad_shapes(what, change):
    args = (torch.zeros((64, 2)), torch.ones(64),
            torch.ones(64, dtype=torch.bool))
    n0 = _build.LAUNCHES["bh_tree"]
    with pytest.raises(ValueError):
        ttree.build_tree(*change(args), ORIGIN, SIDE, num_nodes=100,
                         leaf_size=4, max_depth=8)
    assert _build.LAUNCHES["bh_tree"] == n0


@pytest.mark.parametrize("max_depth,leaf_size,what", [
    (-1, 4, "max_depth"), (16, 4, "max_depth"), (8, -1, "leaf_size")])
def test_build_tree_refuses_depths_and_leaves_out_of_range(max_depth,
                                                          leaf_size, what):
    """Depths the 15 code levels cannot resolve, and a negative leaf."""
    with pytest.raises(ValueError, match=what):
        ttree.build_tree(torch.zeros((64, 2)), torch.ones(64),
                         torch.ones(64, dtype=torch.bool), ORIGIN, SIDE,
                         num_nodes=100, leaf_size=leaf_size,
                         max_depth=max_depth)


@pytest.mark.parametrize("which", [(0,), (1,), (0, 1, 2)])
def test_build_tree_refuses_tensors_off_the_cpu_without_a_card(which):
    """A tensor off the CPU (here on the meta device: no card at all)
    sends the call to the kernel's checks, which raise; the plain version
    is not taken and nothing is launched."""
    args = [torch.zeros((64, 2)), torch.ones(64),
            torch.ones(64, dtype=torch.bool)]
    for k in which:
        args[k] = args[k].to("meta")
    n0 = _build.LAUNCHES["bh_tree"]
    with pytest.raises(ValueError, match="CUDA tensor"):
        ttree.build_tree(*args, ORIGIN, SIDE, num_nodes=100, leaf_size=4,
                         max_depth=8)
    assert _build.LAUNCHES["bh_tree"] == n0


def test_build_work_counts_bodies_and_slots():
    """65 bytes a slot, 96 a node-table slot, 24 for the counts and the
    root; the scratch holds three float64 prefixes, the CTA tables, the
    sorted codes and the level masks."""
    assert ttree.build_work(1 << 20, 272384) == dict(
        flops=0, bytes=65 * (1 << 20) + 96 * 272384 + 24)
    assert ttree._tree_scratch(1000, 7) == (
        24 * 1001 + 24 * 7 + 4 * 1000 + 64 * 7 + 2 * 1000)


def test_geometry_rounds_as_the_plain_build():
    """The root corner, side, finest cell and cell-coordinate multiply the
    kernels take are the float32 values the plain build computes with."""
    ox, oy, scale, unit, side = ttree._geometry(ORIGIN, SIDE)
    pos, mass, alive = _scene("disks", 60, 64, 2)
    t = _build_on("cpu", pos, mass, alive, fn=ttree.build_tree_ref,
                  num_nodes=64, leaf_size=8, max_depth=8)
    assert t.origin.tolist() == [ox, oy] and float(t.root_side) == side
    assert unit == float(t.root_side / (1 << morton.COORD_BITS))
    assert scale == float(torch.tensor((1 << morton.COORD_BITS) / side,
                                       dtype=torch.float32))


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _assert_tree_equal(got, want):
    for f in INT_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == torch.int32 and g.shape == w.shape, f
        assert torch.equal(g, w), f
    for f in EXACT_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(got.node_rows[:, EXACT_COLS],
                       want.node_rows[:, EXACT_COLS])
    for g, w in ((got.mass, want.mass), (got.com, want.com),
                 (got.node_rows[:, :3], want.node_rows[:, :3])):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=0.0)


def _check(dev, pos, mass, alive, **kw):
    """One kernel build against the plain one on the same card tensors;
    one ``bh_tree`` launch. Returns the kernel's tree."""
    n0 = _build.LAUNCHES["bh_tree"]
    got = _build_on(dev, pos, mass, alive, **kw)
    assert _build.LAUNCHES["bh_tree"] == n0 + 1
    want = _build_on(dev, pos, mass, alive, fn=ttree.build_tree_ref, **kw)
    torch.cuda.synchronize()
    _assert_tree_equal(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "disks", "coincident",
                                  "crowded"])
def test_codes_kernel_equals_hilbert_codes_on_card(cuda_device, kind):
    pos, _, alive = _scene(kind, 3000, 4096, 2)
    p = torch.from_numpy(pos).to(cuda_device)
    a = torch.from_numpy(alive).to(cuda_device)
    got = ttree._codes_launch(p, a, ttree._geometry(ORIGIN, SIDE))
    want = morton.hilbert_codes(p, ORIGIN, float(np.float32(SIDE)), a)
    assert torch.equal(got, want)
    assert int((got == morton.DEAD_CODE).sum()) == 4096 - 3000


@pytest.mark.cuda
@pytest.mark.parametrize("leaf,depth", [(16, 14), (8, 10), (1, 15),
                                        (64, 14)])
@pytest.mark.parametrize("kind", ["uniform", "disks"])
def test_kernel_tree_equals_plain_on_card(cuda_device, kind, leaf, depth):
    pos, mass, alive = _scene(kind, 6000, 8192, 3)
    t = _check(cuda_device, pos, mass, alive, num_nodes=8 * 8192 + 64,
               leaf_size=leaf, max_depth=depth)
    assert int(t.n_alive) == 6000
    assert int(t.node_need) == int(t.n_nodes) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["coincident", "crowded"])
@pytest.mark.parametrize("depth", [14, 15])
def test_kernel_tree_equals_plain_on_piled_bodies_on_card(cuda_device, kind,
                                                          depth):
    """Bodies on one point reach the deepest level in one leaf; a crowded
    cell runs a long chain of one-child nodes."""
    pos, mass, alive = _scene(kind, 3000, 4096, 4)
    t = _check(cuda_device, pos, mass, alive, num_nodes=4096,
               leaf_size=16, max_depth=depth)
    level = t.level[:int(t.n_nodes)]
    assert int(level.max()) == depth
    deepest = t.count[:int(t.n_nodes)][level == depth]
    assert int(deepest.max()) >= (100 if kind == "coincident" else 17)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1])
def test_kernel_tree_equals_plain_with_no_or_one_body_on_card(cuda_device,
                                                              n):
    pos, mass, alive = _scene("uniform", n, 512, 5) if n else (
        np.zeros((512, 2), np.float32), np.zeros(512, np.float32),
        np.zeros(512, bool))
    t = _check(cuda_device, pos, mass, alive, num_nodes=64, leaf_size=8,
               max_depth=14)
    assert int(t.n_alive) == n and int(t.node_need) == n


@pytest.mark.cuda
@pytest.mark.parametrize("num_nodes", [1, 50, 700])
def test_kernel_tree_equals_plain_when_the_table_overflows_on_card(
        cuda_device, num_nodes):
    """The first ``num_nodes`` nodes, child ids past the table as the
    plain path leaves them, and the unclipped need."""
    pos, mass, alive = _scene("disks", 3000, 4096, 6)
    t = _check(cuda_device, pos, mass, alive, num_nodes=num_nodes,
               leaf_size=8, max_depth=14)
    assert int(t.node_need) > num_nodes == int(t.n_nodes)


@pytest.mark.cuda
def test_kernel_tree_equals_plain_at_the_bh_cell_state(cuda_device):
    """The Barnes–Hut cell's two-disk scene at N = 1M in 2^20 slots, its
    node table, leaf size and depth, after two engine steps (merges leave
    dead slots among the alive); a second build gives the same bits."""
    from tpu_nbody_torch.config import Params, SimConfig
    from tpu_nbody_torch.engine import Engine, _root

    cell = json.loads(BH_CELL.read_text())
    sim = {k: tuple(v) if isinstance(v, list) else v
           for k, v in cell["sim_config"].items()}
    cfg = SimConfig(capacity=cell["capacity"], world_w=cell["world_w"],
                    world_h=cell["world_h"], **sim)
    eng = Engine(cfg, Params.default(**cell["params"]), solver="bh",
                 integrator="kdk_reuse", device=cuda_device, seed=7)
    n2 = cell["n_bodies"] // 5
    eng.reset_default_scene(n1=cell["n_bodies"] - n2, n2=n2)
    eng.step(2)
    st = eng.state
    origin, side = _root(cfg)
    kw = dict(num_nodes=cell["sim_config"]["node_capacity"],
              leaf_size=cfg.leaf_size, max_depth=cfg.max_depth)
    mass = torch.where(st.alive, st.mass, 0.0)
    n0 = _build.LAUNCHES["bh_tree"]
    got = ttree.build_tree(st.pos, mass, st.alive, origin, side, **kw)
    again = ttree.build_tree(st.pos, mass, st.alive, origin, side, **kw)
    assert _build.LAUNCHES["bh_tree"] == n0 + 2
    want = ttree.build_tree_ref(st.pos, mass, st.alive, origin, side, **kw)
    torch.cuda.synchronize()
    _assert_tree_equal(got, want)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    assert int(got.n_alive) == int(st.alive.sum()) > 990_000
    assert 100_000 < int(got.n_nodes) <= kw["num_nodes"]
