"""The rescue kernel's sub-tile skip (``csrc/rescue.cu`` under poly4), its
helpers in ``ops/band.py`` and the block rows and boxes of the selection
(``mesh._block_boxes``, kernel ``csrc/block_boxes.cu``).

On the CPU: every sub-tile pair that ``band.rescue_near_tiles`` marks far
holds only terms of weight exactly 0 (zeroing its partner masses leaves
``rescue_pair_sum_ref`` bit for bit as it was) and no pair within the
cutoff, on a random scene, a clustered one and a constructed one with
pairs and box gaps a few ulps either side of 2a and of the skip margin;
``rescue_cutoff_pairs`` and ``band_cutoff_pairs`` against numpy counts;
``rescue_pair_work`` under exp4; the plain walked count; ``_block_boxes_ref`` against a numpy model of
the JAX package's box rule (``tpu_nbody/ops/mesh.py:286-300``).

On the card (marker ``cuda``, skipped without one): the kernel with the
skip against itself without it bit for bit, its counter against
``rescue_near_tiles``, a repeat, exp4 walking every sub-tile, scenes that
skip nothing and all but one sub-tile, and the boxes kernel bit for bit.
"""

import math

import numpy as np
import pytest
import torch

from tpu_nbody_torch.kernels import _build
from tpu_nbody_torch.ops import band as tband
from tpu_nbody_torch.ops import mesh as tmesh

torch.set_num_threads(2)

SOFT2 = 1.0
ORIGIN, SIDE = (0.0, 0.0), 400.0
A = 12.0


def _sorted(pos, mass, alive, device="cpu"):
    spos, smass, salive, _ = tmesh._hilbert_sort(
        torch.from_numpy(pos).to(device), torch.from_numpy(mass).to(device),
        torch.from_numpy(alive).to(device), ORIGIN, SIDE)
    return spos.contiguous(), smass.contiguous(), salive


def _scene(kind, n, cap, seed=0, device="cpu"):
    """``n`` alive bodies in ``cap`` slots, Hilbert-sorted: uniform in the
    400 px square ("random"), or three tight clusters ("clustered")."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((cap, 2), np.float32)
    if kind == "random":
        pos[:n] = rng.uniform(0.0, SIDE, (n, 2)).astype(np.float32)
    else:
        centres = np.array([[100.0, 120.0], [260.0, 300.0], [300.0, 90.0]])
        pos[:n] = (centres[rng.integers(0, 3, n)]
                   + rng.normal(0.0, 12.0, (n, 2))).astype(np.float32)
    mass = np.zeros(cap, np.float32)
    mass[:n] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return _sorted(pos, mass, np.arange(cap) < n, device)


def _base_args(spos, smass, salive, S, k, mixed=False):
    """The base tier's (trows, tid, prows, pidx, pvalid) of a scene;
    ``mixed``: every second partner slot moved to another block (valid),
    as a cross-shard import list names blocks the selection did not
    choose, so the blocks' own boxes are not all near."""
    sel = tmesh._rescue_select(spos, torch.where(salive, smass, 0.0), salive,
                               A, band=S, k=k, chunk=4 * S)
    rows, pidx, pvalid = sel.rows, sel.midx, sel.mval > 0
    if mixed:
        moved = torch.arange(k, device=rows.device) % 2 == 1
        pidx = torch.where(moved, (pidx * 7 + 3) % rows.shape[0], pidx)
        pvalid = pvalid | moved
    return (rows, torch.arange(rows.shape[0], device=rows.device), rows,
            pidx, pvalid)


def _edge_args(S):
    """One target block against k = 4 partner blocks whose bodies sit a
    few ulps either side of the cutoff 2a and of the skip threshold: the
    targets on x = 0 (y in [0, 20]), the bodies of each partner sub-tile on
    one line x = d: in turn 2a within 4 ulps a body (pairs either side of
    the cutoff), sqrt(cut) within 3 ulps a sub-tile (box gaps either side
    of the threshold), and just past it."""
    cut = tband._cull_cut(SOFT2, A, "poly4")
    two_a = np.float32(2.0 * A)
    edge = np.float32(math.sqrt(cut))
    eps = np.float32(2.0 ** -23)
    k, nt = 4, -(-S // 32)
    trow = np.zeros((S, 3), np.float32)
    trow[:, 1] = np.linspace(0.0, 20.0, S, dtype=np.float32)
    trow[:, 2] = 1.0
    rng = np.random.default_rng(5)
    prows = np.zeros((k, S, 3), np.float32)
    for b in range(k):
        for t in range(nt):
            kind = (b * nt + t) % 3
            j = slice(32 * t, min(32 * t + 32, S))
            n = j.stop - j.start
            if kind == 0:
                ulps = rng.integers(-4, 5, n)
                d = two_a * (np.float32(1) + ulps.astype(np.float32) * eps)
            elif kind == 1:
                d = edge * (np.float32(1)
                            + np.float32(rng.integers(-3, 4)) * eps)
            else:
                d = edge * np.float32(1 + 2 ** -9)
            prows[b, j, 0] = d
            prows[b, j, 1] = trow[j, 1]       # dy = 0 against its own row
            prows[b, j, 2] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    # one sub-tile well inside the cutoff, so the sums are not all the
    # few-ulp weights of the edge (where the kernel's and the plain
    # formula's roundings of 1 - r²/(2a)² part by ulps of the result)
    prows[k - 1, 32 * (nt - 1):, 0] = np.float32(A)
    t = torch.from_numpy(trow.reshape(1, 3 * S))
    p = torch.from_numpy(prows.reshape(k, 3 * S))
    return (t, torch.zeros(1, dtype=torch.int64), p,
            torch.arange(k).reshape(1, k), torch.ones((1, k), dtype=bool))


def _args(kind, S):
    if kind == "edge":
        return _edge_args(S)
    spos, smass, salive = _scene(kind, 3000, 3000 + 41)
    return _base_args(spos, smass, salive, S, 4, mixed=True)


def _masked_ref(args, mask):
    """``rescue_pair_sum_ref`` with the partner masses of every sub-tile
    far from a target run zeroed, that run's rows taken from its own
    call: each (output, partner slot) gets a private copy of its block."""
    trows, tid, prows, pidx, pvalid = args
    m, k = pidx.shape
    S = trows.shape[1] // 3
    rows = 32
    own = prows[pidx].reshape(m, k, S, 3)
    out = torch.empty((m, S, 2))
    for g in range(mask.shape[1]):
        near = mask[:, g].repeat_interleave(32, dim=-1)[..., :S]  # (m, k, S)
        p = own.clone()
        p[..., 2] = torch.where(near | ~pvalid[:, :, None], p[..., 2], 0.0)
        got = tband.rescue_pair_sum_ref(
            trows, tid, p.reshape(m * k, 3 * S),
            torch.arange(m * k).reshape(m, k), pvalid, SOFT2, A, "poly4")
        out[:, g * rows:(g + 1) * rows] = got[:, g * rows:(g + 1) * rows]
    return out


@pytest.mark.parametrize("S", [32, 100, 128, 256])
@pytest.mark.parametrize("kind", ["random", "clustered", "edge"])
def test_far_tiles_hold_only_zero_terms(kind, S):
    """Zeroing the partner masses of the far sub-tiles changes no bit of
    the plain sum, and the scene skips some sub-tiles and keeps others."""
    args = _args(kind, S)
    near = tband.rescue_near_tiles(*args, SOFT2, A, "poly4")
    valid = args[4][:, None, :, None].expand_as(near.mask)
    assert 0 < near.tiles < int(valid.sum())
    want = tband.rescue_pair_sum_ref(*args, SOFT2, A, "poly4")
    assert torch.equal(_masked_ref(args, near.mask), want)


def _pair_tiles(args):
    """(m, G, k, G): sub-tile pairs holding a pair with r² < rcut2."""
    trows, tid, prows, pidx, pvalid = args
    m, k = pidx.shape
    S = trows.shape[1] // 3
    ctr = trows[tid].reshape(m, S, 3).numpy()
    part = prows[pidx].reshape(m, k * S, 3).numpy()
    dx = part[:, None, :, 0] - ctr[:, :, None, 0]
    dy = part[:, None, :, 1] - ctr[:, :, None, 1]
    inside = (dx * dx + dy * dy) < np.float32(tband._rcut2_f32(A))
    G = nt = -(-S // 32)
    out = np.zeros((m, G, k, nt), bool)
    for g in range(G):
        for t in range(nt):
            blk = inside[:, 32 * g:32 * (g + 1)].reshape(
                m, -1, k, S)[..., 32 * t:32 * t + 32]
            out[:, g, :, t] = blk.any(axis=(1, 3))
    return torch.from_numpy(out) & pvalid[:, None, :, None]


@pytest.mark.parametrize("S", [32, 100, 128])
@pytest.mark.parametrize("kind", ["random", "clustered", "edge"])
def test_no_pair_in_cutoff_is_far(kind, S):
    args = _args(kind, S)
    near = tband.rescue_near_tiles(*args, SOFT2, A, "poly4")
    inside = _pair_tiles(args)
    assert int(inside.sum()) > 0
    assert not (inside & ~near.mask).any()


@pytest.mark.parametrize("kind", ["random", "clustered", "edge"])
def test_cutoff_pairs_brute_force(kind):
    """Pairs within 2a whose partner has mass, over the valid blocks."""
    args = _args(kind, 32)
    trows, tid, prows, pidx, pvalid = args
    m, k = pidx.shape
    S = trows.shape[1] // 3
    ctr = trows[tid].reshape(m, S, 3).numpy()
    part = prows[pidx].reshape(m, k, S, 3).numpy()
    rcut2 = np.float32((2.0 * A) ** 2)
    want = 0
    for o in range(m):
        for p in range(k):
            if not bool(pvalid[o, p]):
                continue
            dx = part[o, p, None, :, 0] - ctr[o, :, None, 0]
            dy = part[o, p, None, :, 1] - ctr[o, :, None, 1]
            want += int(((dx * dx + dy * dy < rcut2)
                         & (part[o, p, None, :, 2] > 0)).sum())
    assert want > 0
    for chunk in (1, 7, 256):
        assert tband.rescue_cutoff_pairs(*args, A, "poly4",
                                         chunk=chunk) == want


@pytest.mark.parametrize("S,cap", [(32, 1000), (100, 777)])
def test_band_cutoff_pairs_brute_force(S, cap):
    """The band pass's pairs within 2a whose partner has mass: each body
    against its own and both neighbour blocks (the cutoff count beside
    ``band.pair_work``'s every window pair)."""
    rng = np.random.default_rng(S)
    pos = rng.uniform(0.0, 100.0, (cap, 2)).astype(np.float32)
    mass = rng.uniform(0.0, 2.0, cap).astype(np.float32)
    mass[::7] = 0.0
    a = 3.0
    rcut2 = np.float32((2.0 * a) ** 2)
    want = 0
    for i in range(cap):
        b = i // S
        js = np.arange(max(0, (b - 1) * S), min(cap, (b + 2) * S))
        dx = pos[js, 0] - pos[i, 0]
        dy = pos[js, 1] - pos[i, 1]
        want += int(((dx * dx + dy * dy < rcut2) & (mass[js] > 0)).sum())
    got = tband.band_cutoff_pairs(torch.from_numpy(pos),
                                  torch.from_numpy(mass), a, band=S,
                                  chunk=4 * S)
    assert got == want
    assert 0 < got < tband.pair_work(cap, S)["pairs"]


def test_exp4_work_is_every_valid_pair():
    """exp4 counts and walks every valid pair: its weight is never 0."""
    args = _args("clustered", 32)
    valid = int(args[4].sum())
    m, k = args[3].shape
    assert tband.rescue_cutoff_pairs(*args, A, "exp4") == valid * 32 * 32
    near = tband.rescue_near_tiles(*args, SOFT2, A, "exp4")
    assert near.tiles == valid and near.pairs == valid * 32 * 32
    w = tband.rescue_pair_work(m, k, 32, valid, m, "exp4", near_pairs=5)
    assert w["pairs"] == valid * 32 * 32 == w["walked"]
    assert w["flops"] == 18 * w["pairs"]
    poly = tband.rescue_pair_work(m, k, 32, valid, m, "poly4", near_pairs=5,
                                  walked_pairs=700)
    assert (poly["pairs"], poly["flops"], poly["walked"]) == (5, 105, 700)


@pytest.mark.parametrize("switch", ["poly4", "exp4"])
def test_plain_path_adds_the_walked_count(switch):
    args = _args("random", 128)
    walked = torch.zeros((), dtype=torch.int64)
    got = tband.rescue_pair_sum(*args, SOFT2, A, switch, walked=walked)
    near = tband.rescue_near_tiles(*args, SOFT2, A, switch)
    assert int(walked) == near.tiles
    assert torch.equal(got, tband.rescue_pair_sum_ref(*args, SOFT2, A,
                                                      switch))


def test_no_skip_where_softening_dwarfs_the_cutoff():
    """ε² above 2¹⁰ (2a)² leaves no margin for the kernel's rounding, so
    the skip is off; poly4's cut otherwise sits 2⁻¹⁰ above rcut2."""
    assert math.isnan(tband._cull_cut(2000.0 * 4 * A * A, A, "poly4"))
    assert math.isnan(tband._cull_cut(SOFT2, A, "exp4"))
    cut = tband._cull_cut(SOFT2, A, "poly4")
    assert cut == float(np.float32(np.float32(4 * A * A)
                                   * np.float32(1 + 2 ** -10)))


def test_nonfinite_bodies_never_skip():
    """A NaN or infinite coordinate (or mass) makes its sub-box NaN: the
    sub-tile is walked, and the plain sum reads NaN as the kernel's."""
    args = list(_args("random", 128))
    near0 = tband.rescue_near_tiles(*args, SOFT2, A, "poly4").mask
    o, g, p, t = (int(v) for v in torch.nonzero(~near0 & args[4][
        :, None, :, None])[0])
    prows = args[2].clone().reshape(-1, 128, 3)
    prows[args[3][o, p], 32 * t + 3, 0] = math.inf
    args[2] = prows.reshape(-1, 3 * 128)
    near = tband.rescue_near_tiles(*args, SOFT2, A, "poly4").mask
    assert bool(near[o, :, p, t].all())
    trows = args[0].clone().reshape(-1, 128, 3)
    trows[args[1][o], 32 * g, 2] = math.nan      # a target's mass: unused
    args[0] = trows.reshape(-1, 3 * 128)
    assert torch.equal(tband.rescue_near_tiles(*args, SOFT2, A,
                                               "poly4").mask, near)


def _jax_rule_boxes(pos, mass, alive, S):
    """Numpy model of ``tpu_nbody/ops/mesh.py:286-300``: zero-padded rows,
    alive-only min and max, ±finfo.max for a block with none alive."""
    cap = pos.shape[0]
    B = -(-cap // S)
    pad = B * S - cap
    fields = np.concatenate([np.concatenate([pos, mass[:, None]], axis=1),
                             np.zeros((pad, 3), np.float32)])
    lv = np.concatenate([alive, np.zeros(pad, bool)]).reshape(B, S)
    X = fields.reshape(B, S, 3)
    big = np.finfo(np.float32).max
    box = np.stack([np.where(lv, X[..., 0], big).min(1),
                    np.where(lv, X[..., 0], -big).max(1),
                    np.where(lv, X[..., 1], big).min(1),
                    np.where(lv, X[..., 1], -big).max(1)], axis=1)
    return X, box


@pytest.mark.parametrize("S", [1, 32, 100, 128])
def test_block_boxes_ref_matches_jax_rule(S):
    """A ragged capacity, dead bodies scattered and one all-dead block."""
    rng = np.random.default_rng(S)
    cap = 7 * 128 + 37
    pos = rng.uniform(-50.0, 350.0, (cap, 2)).astype(np.float32)
    mass = rng.uniform(0.0, 3.0, cap).astype(np.float32)
    alive = rng.uniform(size=cap) < 0.8
    alive[S:2 * S] = False                      # block 1 holds no alive body
    X, box = tmesh._block_boxes_ref(torch.from_numpy(pos),
                                    torch.from_numpy(mass),
                                    torch.from_numpy(alive), S)
    wX, wbox = _jax_rule_boxes(pos, mass, alive, S)
    assert np.array_equal(X.numpy(), wX) and np.array_equal(box.numpy(), wbox)
    big = np.finfo(np.float32).max
    assert box[1].tolist() == [big, -big, big, -big]


def test_block_boxes_wrapper_takes_the_plain_version_on_cpu():
    spos, smass, salive = _scene("random", 500, 577)
    n0 = _build.LAUNCHES["boxes"]
    X, box = tmesh._block_boxes(spos, smass, salive, 64)
    wX, wbox = tmesh._block_boxes_ref(spos, smass, salive, 64)
    assert torch.equal(X, wX) and torch.equal(box, wbox)
    assert _build.LAUNCHES["boxes"] == n0
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmesh._block_boxes(*(t.to("meta") for t in (spos, smass, salive)),
                           64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _on(args, dev):
    return tuple(t.to(dev) for t in args)


def _assert_close_to(got, want):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("T,R", [(1, 4), (2, 1), (2, 4), (4, 1), (4, 3)])
@pytest.mark.parametrize("kind", ["random", "clustered", "edge"])
def test_skip_changes_no_bit_on_card(cuda_device, kind, T, R):
    """The kernel with the skip equals itself without it bit for bit, is
    within 1e-5 of max |a| of the plain version, repeats bit for bit, and
    its counter reads rescue_near_tiles' count (walked in full: every
    valid sub-tile)."""
    args = _on(_args(kind, 128), cuda_device)
    m, k = args[3].shape
    plan = tband._rescue_plan(128, k, T=T, R=R)
    walked = torch.zeros((), dtype=torch.int64, device=cuda_device)
    full = torch.zeros((), dtype=torch.int64, device=cuda_device)
    got = tband._rescue_launch(*args, SOFT2, A, "poly4", plan, walked=walked)
    again = tband._rescue_launch(*args, SOFT2, A, "poly4", plan)
    nocull = tband._rescue_launch(*args, SOFT2, A, "poly4", plan,
                                  walked=full, cull=False)
    want = tband.rescue_pair_sum_ref(*args, SOFT2, A, "poly4", chunk=64)
    near = tband.rescue_near_tiles(*args, SOFT2, A, "poly4")
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, nocull)
    _assert_close_to(got, want)
    assert int(walked) == near.tiles < int(full)
    assert int(full) == int(args[4].sum()) * 4 * 4


@pytest.mark.cuda
@pytest.mark.parametrize("switch", ["poly4", "exp4"])
def test_walked_count_on_card(cuda_device, switch):
    """The wrapper's counter on the card equals the plain count; exp4 walks
    every sub-tile of the valid blocks."""
    spos, smass, salive = _scene("clustered", 20_000, 20_480 + 77,
                                 device=cuda_device)
    args = _base_args(spos, smass, salive, 128, 8)
    walked = torch.zeros((), dtype=torch.int64, device=cuda_device)
    got = tband.rescue_pair_sum(*args, SOFT2, A, switch, walked=walked)
    near = tband.rescue_near_tiles(*args, SOFT2, A, switch)
    want = tband.rescue_pair_sum_ref(*args, SOFT2, A, switch, chunk=64)
    torch.cuda.synchronize()
    assert int(walked) == near.tiles
    if switch == "exp4":
        assert near.tiles == int(args[4].sum()) * 4 * 4
    _assert_close_to(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("spread", ["nothing", "all_but_one"])
def test_skip_extremes_on_card(cuda_device, spread):
    """Every partner on the targets' own spot skips nothing; partners all
    far but one sub-tile skip all the others."""
    rng = np.random.default_rng(9)
    S, k, m = 128, 6, 40
    trows = rng.uniform(0.0, 5.0, (m, S, 3)).astype(np.float32)
    prows = rng.uniform(0.0, 5.0, (k * m, S, 3)).astype(np.float32)
    if spread == "all_but_one":
        prows[..., 0] += 1000.0
        prows[0, :32, 0] -= 1000.0
    pidx = torch.from_numpy(rng.integers(1, k * m, (m, k)))
    pidx[:, 0] = 0
    args = _on((torch.from_numpy(trows.reshape(m, 3 * S)), torch.arange(m),
                torch.from_numpy(prows.reshape(k * m, 3 * S)), pidx,
                torch.ones((m, k), dtype=torch.bool)), cuda_device)
    walked = torch.zeros((), dtype=torch.int64, device=cuda_device)
    got = tband.rescue_pair_sum(*args, SOFT2, A, "poly4", walked=walked)
    want = tband.rescue_pair_sum_ref(*args, SOFT2, A, "poly4", chunk=16)
    torch.cuda.synchronize()
    full = m * k * 4 * 4
    assert int(walked) == (full if spread == "nothing" else m * 4)
    _assert_close_to(got, want)
    assert float(want.abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 32, 100, 128, 1024])
@pytest.mark.parametrize("n,cap", [(1_000_000, 1 << 20), (3000, 3001),
                                   (0, 77)])
def test_block_boxes_on_card(cuda_device, S, n, cap):
    """The boxes kernel equals the plain version bit for bit at N = 1M and
    on ragged tails, dead bodies scattered and an all-dead block included;
    one launch a call."""
    rng = np.random.default_rng(cap)
    spos = torch.from_numpy(rng.uniform(0.0, SIDE, (cap, 2))
                            .astype(np.float32))
    smass = torch.from_numpy(rng.uniform(0.5, 2.0, cap).astype(np.float32))
    salive = torch.from_numpy((np.arange(cap) < n)
                              & (rng.uniform(size=cap) < 0.9))
    salive[S:2 * S] = False
    want = tmesh._block_boxes_ref(spos, smass, salive, S)
    n0 = _build.LAUNCHES["boxes"]
    got = tmesh._block_boxes(*_on((spos, smass, salive), cuda_device), S)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["boxes"] == n0 + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
