"""The P3M rescue's partner selection (``mesh.rescue_select``, kernel
``csrc/rescue_select.cu``) and its plain version ``mesh._rescue_select_ref``.

On the CPU: the plain version against an oracle written here with
``jax.numpy`` and ``jax.lax.top_k`` on the same boxes (the score lines of
the JAX package's ``one_chunk``, ``tpu_nbody/ops/mesh.py:316-330``, and
of ``tpu_nbody/parallel/sharded_pm.py:197``'s import picks): ``cnt``,
``need``, ``hot``, the scores on every slot and the indices on the valid
slots, exactly, on the two-disk bench scene at capacities 2^13-2^15, a
tie-heavy scene (every block overlaps every block), half-dead and all-dead
blocks, a block count that is not a multiple of the chunk, k >= B and the
two-tier case; ``_block_rescue`` and ``_cross_shard_rescue`` go through
the wrapper; the launch plan; the table of union boxes (the union of each
32 consecutive candidate boxes, NaN wherever a member's coordinate is NaN)
against ``mesh._union_boxes`` and a numpy union on ragged, inverted, NaN
and huge boxes, and the near-group count on such boxes. The JAX package is
imported inside the tests that use it, so the ``cuda`` tests also collect
where jax is missing.

On the card (marker ``cuda``, skipped without one): the kernel against
the plain version bit for bit on every scene, with the union table given
(built by ``csrc/block_boxes.cu``) and the wrapper's own (its union
kernel), with the union table in several tiles and with buffers small
enough to prune often, in the export and import modes, the cross-shard
calls at P = 2 and 4 thread ranks, ``_block_rescue`` against the CPU; both
union kernels bit for bit against ``mesh._union_boxes``; the selection
phase's two device operations.
"""

import math

import numpy as np
import pytest
import torch

from tpu_nbody_torch import config as tconfig
from tpu_nbody_torch import engine as tengine
from tpu_nbody_torch.config import SimConfig
from tpu_nbody_torch.models import scenes as tscenes
from tpu_nbody_torch.ops import band as tband
from tpu_nbody_torch.ops import mesh as tmesh

torch.set_num_threads(2)

SOFT2 = 1.0


def _two_disk(n, cap, seed):
    """The bench's two-disk collision at ``n`` bodies (n1 = n - n//5,
    n2 = n//5) from numpy uniforms, in ``cap`` slots, Hilbert-sorted over
    the bench's root; and the bench's split scale a (mesh level 12,
    mesh_ny 2048, 2.5 cells)."""
    rng = np.random.default_rng(seed)
    cfg = SimConfig(capacity=cap)
    w, h = cfg.world_w, cfg.world_h
    parts = []
    for m, kw in ((n - n // 5, dict(x=0.5 * w, y=0.5 * h, r=300.0,
                                    central_mass=50_000.0,
                                    total_satellite_mass=5_000.0)),
                  (n // 5, dict(x=0.5 * w, y=0.2 * h, r=100.0,
                                central_mass=5_000.0,
                                total_satellite_mass=500.0, vx=-50.0))):
        u = [torch.from_numpy(rng.random(m - 1, dtype=np.float32))
             for _ in range(3)]
        pos, _, mass = tscenes.galaxy_disk_from_uniforms(
            *u, min_r=tconfig.MIN_R, G=tconfig.G_DEFAULT, **kw)
        parts.append((pos, mass))
    pos = torch.zeros((cap, 2))
    mass = torch.zeros(cap)
    pos[:n] = torch.cat([p for p, _ in parts])
    mass[:n] = torch.cat([m for _, m in parts])
    alive = torch.arange(cap) < n
    origin, side = tengine._root(cfg)
    spos, smass, salive, _ = tmesh._hilbert_sort(pos, mass, alive, origin,
                                                 side)
    a = tmesh._pm_geometry(origin, side, 12, 2048, 2.5)[5]
    return spos.contiguous(), smass.contiguous(), salive, a


def _blob(cap, seed, side=5.0):
    """Every body in a ``side`` square: with a = 12 every block box
    overlaps every other (gap 0, score rcut2 exactly), so the partner
    choice is decided by the lower-index rule alone."""
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(
        (100.0 + side * rng.random((cap, 2))).astype(np.float32))
    mass = torch.from_numpy(rng.uniform(0.5, 2.0, cap).astype(np.float32))
    return pos, mass, torch.ones(cap, dtype=torch.bool), 12.0


def _half_dead(cap, seed):
    """The bench scene with every other body dead in a third of the
    blocks and every body dead in six blocks of the middle (inverted
    boxes between live ones)."""
    spos, smass, salive, a = _two_disk(cap - cap // 8, cap, seed)
    S = 32
    alive = salive.clone().reshape(-1, S)
    B = alive.shape[0]
    alive[::3, ::2] = False
    alive[B // 2:B // 2 + 6] = False
    return spos, smass, alive.reshape(-1), a


def _all_dead(cap, seed):
    spos, smass, _, a = _two_disk(cap // 2, cap, seed)
    return spos, smass, torch.zeros(cap, dtype=torch.bool), a


def _wide(cap, seed):
    """The bench scene with a cutoff 32 times wider: up to some 280
    partners a block at scores in no particular order, more than a buffer
    of kh + 128 keys holds, so the kernel prunes its buffers."""
    spos, smass, salive, a = _two_disk(cap, cap, seed)
    return spos, smass, salive, 32.0 * a


# name -> (scene, cap, S, k, k_hot, chunk in bodies)
SCENES = {
    "bench_8k": (lambda: _two_disk(8000, 1 << 13, 1), 32, 8, 0, 1024),
    "bench_16k_two_tier": (lambda: _two_disk(16000, 1 << 14, 2), 64, 4, 16,
                           2048),
    "bench_32k": (lambda: _two_disk(1 << 15, 1 << 15, 3), 128, 8, 0, 4096),
    "ties": (lambda: _blob(4096, 4), 32, 8, 0, 512),
    "ties_two_tier": (lambda: _blob(4096, 5), 32, 4, 40, 512),
    "half_dead": (lambda: _half_dead(4096, 6), 32, 8, 0, 512),
    "all_dead": (lambda: _all_dead(2048, 7), 32, 8, 0, 512),
    "ragged_chunk": (lambda: _two_disk(1001, 1001, 8), 32, 6, 0, 5 * 32),
    "k_ge_blocks": (lambda: _blob(1000, 9), 64, 20, 0, 256),
    "wide": (lambda: _wide(1 << 13, 10), 16, 8, 24, 1024),
}


def _scene(name):
    make, S, k, k_hot, chunk = SCENES[name]
    spos, smass, salive, a = make()
    return spos, smass, salive, a, S, k, k_hot, chunk


def _selection_args(name):
    """(bbox, rcut2, kh, k, cb) of a scene, as ``_rescue_select`` makes
    them."""
    spos, smass, salive, a, S, k, k_hot, chunk = _scene(name)
    _, bbox = tmesh._block_boxes(spos, smass, salive, S)
    B, cb, _ = tband._block_bounds(spos.shape[0], S, chunk)
    k = min(k, B)
    return bbox, a, max(k, min(k_hot, B)), k, cb


def _oracle(tbox, cbox, a, kh, k, tgid0=0, cgid=None, cvalid=None):
    """JAX's score lines on numpy boxes (eager ``jnp``, one op at a time):
    mval, midx, cnt, need, hot."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    bb, c = jnp.asarray(tbox), jnp.asarray(cbox)
    a = jnp.float32(a)
    rcut2 = (2.0 * a) * (2.0 * a)
    gx = jnp.maximum(0.0, jnp.maximum(bb[:, 0:1] - c[None, :, 1],
                                      c[None, :, 0] - bb[:, 1:2]))
    gy = jnp.maximum(0.0, jnp.maximum(bb[:, 2:3] - c[None, :, 3],
                                      c[None, :, 2] - bb[:, 3:4]))
    g2 = gx * gx + gy * gy
    tg = tgid0 + jnp.arange(bb.shape[0])
    cg = jnp.arange(c.shape[0]) if cgid is None else jnp.asarray(cgid)
    mask = (g2 < rcut2) & (jnp.abs(tg[:, None] - cg[None, :]) > 1)
    if cvalid is not None:
        mask = mask & jnp.asarray(cvalid)[None, :]
    cnt = jnp.sum(mask, axis=1)
    score = jnp.where(mask, rcut2 - g2, 0.0)
    mval, midx = jax.lax.top_k(score, kh)
    return (np.asarray(mval), np.asarray(midx), np.asarray(cnt),
            int(jnp.max(cnt)), int(jnp.sum(cnt > k)))


def _assert_same(got, mval, midx, cnt, need, hot):
    """Scores on every slot, indices on the valid slots, counts: exact."""
    np.testing.assert_array_equal(got.cnt.cpu().numpy(), cnt)
    assert (int(got.need), int(got.hot)) == (need, hot)
    gv = got.mval.cpu().numpy()
    np.testing.assert_array_equal(gv.view(np.int32), mval.view(np.int32))
    valid = mval > 0
    np.testing.assert_array_equal(got.midx.cpu().numpy()[valid],
                                  midx[valid])


@pytest.mark.parametrize("name", list(SCENES))
def test_plain_selection_matches_jax_top_k(name):
    """The plain version against JAX's score lines and ``top_k``."""
    bbox, a, kh, k, cb = _selection_args(name)
    got = tmesh._rescue_select_ref(bbox, bbox, tmesh._rcut2(a), kh, k=k,
                                   chunk=cb)
    want = _oracle(bbox.numpy(), bbox.numpy(), a, kh, k)
    _assert_same(got, *want)
    cnt, B = want[2], bbox.shape[0]
    if name.startswith("ties"):
        assert (cnt[1:-1] == B - 3).all() and (cnt[[0, -1]] == B - 2).all()
    if name == "all_dead":
        assert want[3] == 0
    if name.startswith("bench") or name in ("wide", "half_dead"):
        assert want[3] > k          # some block wants more than k
    if name == "wide":
        assert want[3] > -(-kh // 32) * 32 + 128


@pytest.mark.parametrize("P", [2, 4])
def test_plain_cross_shard_mode_matches_jax(P):
    """The import picks' form: other global ids, an invalid flag per
    candidate (own rank's exports and unused export slots, gid -10)."""
    bbox, a, _, _, _ = _selection_args("bench_8k")
    B = bbox.shape[0] // P
    me = P - 1
    rng = np.random.default_rng(P)
    E = 16
    pick = rng.choice(bbox.shape[0], P * E, replace=False)
    cbox = bbox[pick]
    cgid = torch.from_numpy(pick.astype(np.int64))
    cgid[::5] = -10
    shard = torch.arange(P).repeat_interleave(E)
    cvalid = (shard != me) & (cgid >= 0)
    tbox = bbox[me * B:(me + 1) * B].contiguous()
    got = tmesh._rescue_select_ref(tbox, cbox, tmesh._rcut2(a), 8,
                                   tgid0=me * B, cgid=cgid, cvalid=cvalid,
                                   chunk=7)
    want = _oracle(tbox.numpy(), cbox.numpy(), a, 8, 8, tgid0=me * B,
                   cgid=cgid.numpy(), cvalid=cvalid.numpy())
    _assert_same(got, *want)
    assert want[3] > 0


@pytest.mark.parametrize("name", ["bench_16k_two_tier", "ties_two_tier",
                                  "k_ge_blocks"])
def test_rescue_select_tiers(name):
    """``_rescue_select`` splits one ranking of kh into the base tier's
    ranks 0..k-1 and the hot tier's k..kh-1, with the rows and boxes of
    the blocks; the hot tier's ranks equal those of a top-kh of its own."""
    spos, smass, salive, a, S, k, k_hot, chunk = _scene(name)
    sel = tmesh._rescue_select(spos, smass, salive, a, band=S, k=k,
                               chunk=chunk, k_hot=k_hot)
    bbox, a, kh, k, cb = _selection_args(name)
    full = tmesh._rescue_select_ref(bbox, bbox, tmesh._rcut2(a), kh, k=k)
    B = bbox.shape[0]
    assert sel.k == k and sel.cb == cb and sel.rows.shape == (B, 3 * S)
    assert torch.equal(sel.bbox, bbox)
    assert torch.equal(sel.mval, full.mval[:, :k])
    assert torch.equal(sel.hot_mval, full.mval[:, k:])
    assert sel.hot_midx.shape == (B, kh - k)
    assert torch.equal(sel.cnt, full.cnt)
    assert int(sel.need) == int(full.need)
    if name == "k_ge_blocks":
        assert k == B == kh
    else:
        assert kh > k and int(sel.hot) > 0


def test_block_rescue_uses_the_selection_wrapper(monkeypatch):
    """Both tiers of ``_block_rescue`` take their partners from one call
    of the wrapper (the plain version only under it, on CPU tensors)."""
    calls, ref_devices = [], []
    real, real_ref = tmesh.rescue_select, tmesh._rescue_select_ref

    def spy(*args, **kw):
        calls.append(args[3])
        return real(*args, **kw)

    def ref_spy(tbox, *args, **kw):
        ref_devices.append(tbox.device.type)
        return real_ref(tbox, *args, **kw)

    monkeypatch.setattr(tmesh, "rescue_select", spy)
    monkeypatch.setattr(tmesh, "_rescue_select_ref", ref_spy)
    spos, smass, salive, a, S, k, k_hot, chunk = _scene("bench_16k_two_tier")
    n0 = tmesh.SELECT_LAUNCHES
    tmesh._block_rescue(spos, smass, salive, SOFT2, a, band=S, k=k,
                        chunk=chunk, k_hot=k_hot, hot_cap=8)
    assert calls == [k_hot] and ref_devices == ["cpu"]
    assert tmesh.SELECT_LAUNCHES == n0


def test_cross_shard_rescue_uses_the_selection_wrapper(monkeypatch):
    """The export scores and the import picks of every rank are two calls
    of the wrapper: kh = 1 against the remote boxes, then top-k of the
    imports."""
    from tpu_nbody_torch.parallel import sharded_pm as tpm
    from tpu_nbody_torch.parallel.collectives import ThreadGroup, run_spmd
    calls = []
    real = tmesh.rescue_select

    def spy(tbox, cbox, rcut2, kh, **kw):
        calls.append((kh, cbox.shape[0], kw.get("cgid") is not None))
        return real(tbox, cbox, rcut2, kh, **kw)

    monkeypatch.setattr(tmesh, "rescue_select", spy)
    spos, smass, salive, a = _two_disk(4000, 4096, 11)
    P = 2
    g = ThreadGroup(P, "cpu", timeout=120)
    n = 4096 // P
    local = [(spos[r * n:(r + 1) * n], smass[r * n:(r + 1) * n],
              salive[r * n:(r + 1) * n]) for r in range(P)]
    out = run_spmd(g, lambda x: tpm._cross_shard_rescue(
        *x, SOFT2, a, band=32, k=6, export_cap=16, chunk=256, group=g),
        local)
    assert sorted(calls) == sorted([(1, P * n // 32, False)] * P
                                   + [(6, P * 16, True)] * P)
    assert all(o[0].shape == (n, 2) for o in out)
    assert max(int(o[2]) for o in out) > 0


def _near_groups_np(tbox, cbox, rcut2):
    """(target, group of 32 candidates) pairs whose union box is nearer
    than the cutoff, counted with numpy float32 one target at a time."""
    pad = -cbox.shape[0] % 32
    inv = np.array([np.inf, -np.inf, np.inf, -np.inf], np.float32)
    c = np.concatenate([cbox, np.tile(inv, (pad, 1))]).reshape(-1, 32, 4)
    u = np.stack([c[..., 0].min(1), c[..., 1].max(1), c[..., 2].min(1),
                  c[..., 3].max(1)], axis=1)
    zero, cut = np.float32(0), np.float32(rcut2)
    n = 0
    for t in tbox:  # inverted boxes overflow to inf, as on the card
        gx = np.maximum(np.maximum(t[0] - u[:, 1], u[:, 0] - t[1]), zero)
        gy = np.maximum(np.maximum(t[2] - u[:, 3], u[:, 2] - t[3]), zero)
        n += int((~(gx * gx + gy * gy >= cut)).sum())
    return n


@pytest.mark.filterwarnings("ignore:overflow encountered")
@pytest.mark.parametrize("name", ["bench_8k", "bench_32k", "ties",
                                  "half_dead", "all_dead", "ragged_chunk"])
def test_plain_version_counts_the_kernels_near_groups(name):
    """``count_groups`` counts what the kernel's union-box skip lets
    through, whatever the chunk, and changes no selected bit."""
    bbox, a, kh, k, cb = _selection_args(name)
    rcut2 = tmesh._rcut2(a)
    plain = tmesh._rescue_select_ref(bbox, bbox, rcut2, kh, k=k, chunk=cb)
    assert plain.groups is None
    counted = [tmesh.rescue_select(bbox, bbox, rcut2, kh, k=k, chunk=c,
                                   count_groups=True) for c in (cb, None)]
    want = _near_groups_np(bbox.numpy(), bbox.numpy(), rcut2)
    B = bbox.shape[0]
    for sel in counted:
        assert int(sel.groups) == want
        assert torch.equal(sel.mval, plain.mval)
        assert torch.equal(sel.cnt, plain.cnt)
    assert want <= B * -(-B // 32)
    if name == "ties":
        assert want == B * (B // 32)       # every group is near
    if name == "all_dead":
        assert want == 0
    if name.startswith("bench"):
        assert 0 < want < B * -(-B // 32)  # some groups are skipped


def test_select_work_counts_the_near_groups():
    """32 box tests a near group, no union test (their number is the
    design's own); the boxes read once, the slots and counts written
    once."""
    w = tmesh.select_work(8192, 8192, 8, 0, boxes=8192)
    assert w == dict(flops=0, bytes=16 * 8192 + 8192 * (12 * 8 + 4) + 8)
    near = tmesh.select_work(8192, 8192, 8, 5000, boxes=8192)
    assert near["flops"] == 11 * 32 * 5000
    assert near["bytes"] == w["bytes"]
    cross = tmesh.select_work(256, 100, 6, 7)      # targets apart
    assert cross == dict(flops=11 * 32 * 7,
                         bytes=16 * 356 + 256 * (12 * 6 + 4) + 8)


@pytest.mark.parametrize("C,kh,want", [
    (8192, 8, (16, 8192, 0, 32 + 4096 + 1024)),
    (8192, 1, (16, 8192, 0, 32 + 4096 + 1024)),
    (4 * 2048, 4, (16, 8192, 0, 32 + 4096 + 1024)),
    (20_000, 8, (16, 20_000, 0, 32 + 10_000 + 2504)),
    (78_125, 8, (16, 78_144, 0, 32 + 39_072 + 9768)),
    (200_000, 8, (16, 131_072, 0, 32 + 65_536 + 16_384)),
    (100, 0, (16, 128, 0, 32 + 64 + 16)),
    (8192, 32, (16, 8192, 0, 32 + 4096 + 1024)),
    (8192, 40, (16, 8192, 192, 32 + 4096 + 1024 + 16 * 8 * 256)),
    (8192, 8192, (1, 8192, 8320, 32 + 4096 + 1024 + 8 * 16512)),
])
def test_select_plan(C, kh, want):
    """Warps, tile (candidates whose union boxes a shared tile holds),
    buffer, shared bytes (the head, the union boxes and their near list):
    the unions of up to 131,072 candidates (4096 boxes, 64 KB) in one
    tile, so the main path's 8192 blocks and the
    sharded export's 78,125 take one; up to 32 slots the best keys in
    registers (no buffer), past that a shared buffer a warp and the warps
    cut for a large kh; always within 227 KB."""
    plan = tmesh._select_plan(C, kh)
    assert tuple(plan) == want
    assert plan.smem <= 232448 and plan.tile % 32 == 0
    assert plan.smem == tmesh._plan_smem(plan.warps, plan.tile, plan.bufcap,
                                         kh)
    if kh <= 32:
        assert plan.bufcap == 0
    else:
        assert plan.bufcap >= -(-kh // 32) * 32 + 64
    assert plan.tile // 32 <= tmesh._SELECT_UNIONS


@pytest.mark.parametrize("C,kh", [(0, 1), (10, -1), (40_000, 40_000),
                                  (30_000, 14_500)])
def test_select_plan_refuses(C, kh):
    """No candidate, a negative kh, or a kh whose key buffers alone
    overflow the shared memory of a CTA."""
    with pytest.raises(ValueError):
        tmesh._select_plan(C, kh)


def _odd_boxes(name):
    """Candidate boxes (float32 numpy) with the cases the union rule must
    carry: a ragged count (not a multiple of 32), inverted boxes of empty
    blocks, NaN coordinates, coordinates past 2^126, their mixes, and
    infinite coordinates (a block whose alive bodies all lie at +-inf in
    x, or some of them)."""
    rng = np.random.default_rng(40 + ODD.index(name))
    C = {"ragged": 1001, "inverted": 96, "nan": 200, "huge": 161,
         "mixed": 333, "one": 1, "inf": 300}[name]
    lo = rng.uniform(-500.0, 500.0, (C, 2))
    hi = lo + rng.uniform(0.0, 20.0, (C, 2))
    box = np.stack([lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]], 1)
    box = box.astype(np.float32)
    big = np.finfo(np.float32).max
    inv = np.array([big, -big, big, -big], np.float32)
    if name in ("inverted", "mixed"):
        box[rng.choice(C, C // 3, replace=False)] = inv
    if name in ("nan", "mixed"):
        box[rng.choice(C, 7, replace=False), rng.integers(0, 4, 7)] = np.nan
    if name in ("huge", "mixed"):
        far = np.float32(2.0 ** 127)
        box[rng.choice(C, 9, replace=False)] = [far, 1.5 * far, -far, far]
        box[5] = [-1.5 * far, far, 0.0, 1.0]
    if name in ("inverted", "mixed"):
        box[32:64] = inv                    # a group of empty blocks only
    if name == "inf":                       # in y order, as blocks lie
        box = box[np.argsort(box[:, 2])]
        inf = np.float32(np.inf)
        rows = rng.choice(C, 24, replace=False)
        box[rows[:10], :2] = inf            # every alive x at +inf
        box[rows[10:16], :2] = -inf         # every alive x at -inf
        box[rows[16:], 1] = inf             # some alive x at +inf
    return box


def _numpy_unions(box):
    """The union of each 32 boxes with numpy's NaN-propagating min and
    max, the last group padded with the inverted infinite box."""
    pad = -box.shape[0] % 32
    inv = np.array([np.inf, -np.inf, np.inf, -np.inf], np.float32)
    g = np.concatenate([box, np.tile(inv, (pad, 1))]).reshape(-1, 32, 4)
    return np.stack([g[..., 0].min(1), g[..., 1].max(1), g[..., 2].min(1),
                     g[..., 3].max(1)], axis=1)


ODD = ["ragged", "inverted", "nan", "huge", "mixed", "one", "inf"]


@pytest.mark.filterwarnings("ignore:invalid value encountered")
@pytest.mark.parametrize("name", ODD)
def test_union_table_matches_numpy(name):
    """``select_unions`` (the plain version on the CPU) equals
    ``_union_boxes`` and a numpy union: NaN wherever a member's coordinate
    is NaN, the inverted box for a group of empty blocks, infinite
    coordinates kept; its stats are four zeroed int32 words."""
    box = _odd_boxes(name)
    table = tmesh.select_unions(torch.from_numpy(box))
    want = _numpy_unions(box)
    np.testing.assert_array_equal(table.boxes.numpy(), want)
    np.testing.assert_array_equal(
        tmesh._union_boxes(torch.from_numpy(box)).numpy(), want)
    assert table.stats.dtype == torch.int32
    assert table.stats.tolist() == [0, 0, 0, 0]
    assert table.boxes.shape == (-(-box.shape[0] // 32), 4)
    if name in ("nan", "mixed"):
        assert np.isnan(want).any()
    if name in ("inverted", "mixed"):
        big = np.finfo(np.float32).max
        assert (want[1] == [big, -big, big, -big]).all()


@pytest.mark.parametrize("name", ["bench_8k", "half_dead", "ragged_chunk",
                                  "all_dead"])
def test_block_boxes_unions_on_cpu(name):
    """``_block_boxes(..., unions=True)`` on CPU tensors: the plain rows and
    boxes, and the union table of those boxes with zeroed stats."""
    spos, smass, salive, _, S, _, _, _ = _scene(name)
    X, bbox, table = tmesh._block_boxes(spos, smass, salive, S, unions=True)
    wX, wbox = tmesh._block_boxes_ref(spos, smass, salive, S)
    assert torch.equal(X, wX) and torch.equal(bbox, wbox)
    np.testing.assert_array_equal(table.boxes.numpy(),
                                  _numpy_unions(wbox.numpy()))
    assert table.stats.tolist() == [0, 0, 0, 0]


@pytest.mark.filterwarnings("ignore:overflow encountered",
                            "ignore:invalid value encountered")
@pytest.mark.parametrize("name", ["nan", "huge", "mixed", "inverted", "inf"])
def test_near_groups_on_odd_boxes(name):
    """The plain near-group count on boxes with NaN, inverted and huge
    members equals the numpy count from NaN-propagating unions (a NaN
    union is near: its members are tested one by one), and counting
    changes no selected bit."""
    box = torch.from_numpy(_odd_boxes(name))
    rcut2 = tmesh._rcut2(12.0)
    plain = tmesh._rescue_select_ref(box, box, rcut2, 4, chunk=64)
    sel = tmesh._rescue_select_ref(box, box, rcut2, 4, chunk=64,
                                   count_groups=True)
    assert int(sel.groups) == _near_groups_np(box.numpy(), box.numpy(),
                                              rcut2)
    assert torch.equal(sel.mval.view(torch.int32),
                       plain.mval.view(torch.int32))
    assert torch.equal(sel.cnt, plain.cnt)


def _near_groups_cta_np(tbox, cbox, rcut2, W, inf_rule=True):
    """The kernel's two-level count of near groups, in numpy float32: a
    CTA of ``W`` consecutive targets lists the union boxes near the union
    of its targets (NaN-propagating; made NaN where a target has an
    infinite coordinate, unless ``inf_rule`` is off), and each target
    counts the listed ones near itself."""
    u = _numpy_unions(cbox)
    zero, cut = np.float32(0), np.float32(rcut2)

    def g2(t, b):
        gx = np.maximum(np.maximum(t[0] - b[:, 1], b[:, 0] - t[1]), zero)
        gy = np.maximum(np.maximum(t[2] - b[:, 3], b[:, 2] - t[3]), zero)
        return gx * gx + gy * gy

    n = 0
    for c0 in range(0, tbox.shape[0], W):
        ts = tbox[c0:c0 + W]
        tu = np.array([ts[:, 0].min(), ts[:, 1].max(), ts[:, 2].min(),
                       ts[:, 3].max()], np.float32)
        if inf_rule and np.isinf(ts).any():
            tu[:] = np.nan
        listed = u[~(g2(tu, u) >= cut)]
        n += sum(int((~(g2(t, listed) >= cut)).sum()) for t in ts)
    return n


@pytest.mark.filterwarnings("ignore:overflow encountered",
                            "ignore:invalid value encountered")
@pytest.mark.parametrize("name", ODD)
def test_cta_near_list_keeps_every_near_group(name):
    """A numpy model of the kernel's CTA near list (its plan's warps a
    CTA) counts the plain near groups on every odd box set; on the
    infinite one, a list from the targets' plain union would miss some
    (a target's inf - inf gap is NaN, near, where the union's is not)."""
    box = _odd_boxes(name)
    rcut2 = tmesh._rcut2(12.0)
    W = tmesh._select_plan(box.shape[0], min(4, box.shape[0])).warps
    want = _near_groups_np(box, box, rcut2)
    assert _near_groups_cta_np(box, box, rcut2, W) == want
    if name == "inf":
        assert _near_groups_cta_np(box, box, rcut2, W, inf_rule=False) < want


def test_union_table_is_single_use():
    """A selection takes its union table: a second selection with the
    same table raises, since the table's stats hold the first one's
    counts."""
    box = torch.from_numpy(_odd_boxes("ragged"))
    table = tmesh.select_unions(box)
    assert not table.used
    tmesh.rescue_select(box, box, tmesh._rcut2(12.0), 4, unions=table)
    assert table.used
    with pytest.raises(ValueError, match="served a selection"):
        tmesh.rescue_select(box, box, tmesh._rcut2(12.0), 4, unions=table)
    with pytest.raises(ValueError, match="served a selection"):
        tmesh.rescue_select(box[:0], box[:0], 1.0, 0, unions=table)


def test_select_wrapper_refusals():
    """A tensor that is neither on the CPU nor on a card raises; a CPU
    call counts no launch."""
    box = torch.zeros((8, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmesh.rescue_select(box.to("meta"), box.to("meta"), 1.0, 2)
    n0 = tmesh.SELECT_LAUNCHES
    sel = tmesh.rescue_select(box, box, 1.0, 2)
    assert sel.mval.shape == (8, 2) and int(sel.need) == 6
    assert tmesh.SELECT_LAUNCHES == n0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _assert_bits(got, want):
    """The kernel's selection equals the plain version's bit for bit:
    counts, scores on every slot, indices on the valid slots."""
    torch.cuda.synchronize()
    assert torch.equal(got.cnt.cpu(), want.cnt)
    assert (int(got.need), int(got.hot)) == (int(want.need), int(want.hot))
    gv = got.mval.cpu()
    assert torch.equal(gv.view(torch.int32), want.mval.view(torch.int32))
    valid = want.mval > 0
    assert torch.equal(got.midx.cpu()[valid], want.midx[valid])
    assert got.midx.min() >= 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_select_kernel_matches_plain_on_card(cuda_device, name):
    """Every scene, one launch, the same bits as the plain version."""
    bbox, a, kh, k, cb = _selection_args(name)
    want = tmesh._rescue_select_ref(bbox, bbox, tmesh._rcut2(a), kh, k=k,
                                    chunk=cb)
    box = bbox.to(cuda_device)
    n0, u0 = tmesh.SELECT_LAUNCHES, tmesh.UNION_LAUNCHES
    got = tmesh.rescue_select(box, box, tmesh._rcut2(a), kh, k=k)
    _assert_bits(got, want)
    assert tmesh.SELECT_LAUNCHES == n0 + 1
    assert tmesh.UNION_LAUNCHES == u0 + 1     # the wrapper's own table


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_select_kernel_given_unions_on_card(cuda_device, name):
    """Every scene with the union table that ``csrc/block_boxes.cu``
    builds beside the boxes (the main path's two launches): the unions bit
    for bit against ``_union_boxes``, the selection and its near-group
    counter against the plain version, no union launch of its own."""
    spos, smass, salive, a, S, k, k_hot, chunk = _scene(name)
    bbox, a, kh, k, cb = _selection_args(name)
    rcut2 = tmesh._rcut2(a)
    want = tmesh._rescue_select_ref(bbox, bbox, rcut2, kh, k=k, chunk=cb,
                                    count_groups=True)
    n0, u0, b0 = (tmesh.SELECT_LAUNCHES, tmesh.UNION_LAUNCHES,
                  tmesh.BOXES_LAUNCHES)
    _, box, table = tmesh._block_boxes(
        *(t.to(cuda_device) for t in (spos, smass, salive)), S, unions=True)
    got = tmesh.rescue_select(box, box, rcut2, kh, k=k, count_groups=True,
                              unions=table)
    _assert_bits(got, want)
    assert int(got.groups) == int(want.groups)
    assert torch.equal(box.cpu(), bbox)
    assert torch.equal(table.boxes.cpu(), tmesh._union_boxes(bbox))
    assert (tmesh.SELECT_LAUNCHES, tmesh.UNION_LAUNCHES,
            tmesh.BOXES_LAUNCHES) == (n0 + 1, u0, b0 + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bench_8k", "bench_32k", "ties",
                                  "all_dead", "ragged_chunk"])
@pytest.mark.parametrize("tile", [0, 96])
def test_select_kernel_counts_its_near_groups_on_card(cuda_device, name,
                                                      tile):
    """The kernel's counter equals the plain version's count, with the
    table in one tile (0: the default plan) or in tiles of 96, and the
    counter changes no selected bit."""
    bbox, a, kh, k, cb = _selection_args(name)
    rcut2 = tmesh._rcut2(a)
    want = tmesh._rescue_select_ref(bbox, bbox, rcut2, kh, k=k, chunk=cb,
                                    count_groups=True)
    box = bbox.to(cuda_device)
    plan = tmesh._select_plan(box.shape[0], kh)
    if tile:
        plan = plan._replace(tile=tile, smem=tmesh._plan_smem(
            plan.warps, tile, plan.bufcap, kh))
    got = tmesh._select_launch(box, box, rcut2, kh, k, 0, None, None, plan,
                               count_groups=True)
    _assert_bits(got, want)
    assert int(got.groups) == int(want.groups)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bench_8k", "ties", "wide", "half_dead"])
@pytest.mark.parametrize("warps,tile,slack", [(1, 32, 64), (4, 96, 64),
                                              (16, 1024, 128),
                                              (16, 64, 96)])
def test_select_kernel_plans_on_card(cuda_device, name, warps, tile, slack):
    """The shared key buffers (the path of kh > 32, here at any kh) with
    tiled union tables (down to one union box a tile), one to 16 warps
    and buffers that prune every two groups give the same bits."""
    bbox, a, kh, k, _ = _selection_args(name)
    want = tmesh._rescue_select_ref(bbox, bbox, tmesh._rcut2(a), kh, k=k)
    box = bbox.to(cuda_device)
    kp = -(-kh // 32) * 32
    plan = tmesh.SelectPlan(warps=warps, tile=tile, bufcap=kp + slack,
                            smem=tmesh._plan_smem(warps, tile, kp + slack,
                                                  kh))
    got = tmesh._select_launch(box, box, tmesh._rcut2(a), kh, k, 0, None,
                               None, plan)
    _assert_bits(got, want)


@pytest.mark.cuda
def test_select_kernel_tiles_a_large_table_on_card(cuda_device):
    """16,384 blocks (S = 8 at 2^17 bodies) with their union table in
    tiles of 128 boxes (4096 candidates): the table is loaded in four,
    with the same bits and near groups as the default plan's one tile."""
    spos, smass, salive, a = _two_disk(1 << 17, 1 << 17, 12)
    _, bbox = tmesh._block_boxes(spos, smass, salive, 8)
    kh = 8
    rcut2 = tmesh._rcut2(a)
    want = tmesh._rescue_select_ref(bbox, bbox, rcut2, kh, chunk=512,
                                    count_groups=True)
    box = bbox.to(cuda_device)
    plan = tmesh._select_plan(bbox.shape[0], kh)
    assert plan.tile == bbox.shape[0]
    for p in (plan, plan._replace(tile=4096, smem=tmesh._plan_smem(
            plan.warps, 4096, plan.bufcap, kh))):
        got = tmesh._select_launch(box, box, rcut2, kh, kh, 0, None, None,
                                   p, count_groups=True)
        _assert_bits(got, want)
        assert int(got.groups) == int(want.groups)
    assert int(want.need) > kh


@pytest.mark.cuda
@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("given", [False, True])
def test_select_kernel_cross_shard_modes_on_card(cuda_device, P, given):
    """The export mode (kh = 1, k = 0, a valid flag a candidate) and the
    import mode (other global ids, tgid0, invalid slots) of the sharded
    rescue, against the plain version bit for bit, with the union table
    given (``select_unions``) or the wrapper's own."""
    bbox, a, _, _, _ = _selection_args("bench_8k")
    rcut2 = tmesh._rcut2(a)
    B = bbox.shape[0] // P
    me = P - 1
    tbox = bbox[me * B:(me + 1) * B].contiguous()
    remote = (torch.arange(bbox.shape[0]) // B) != me
    rng = np.random.default_rng(P)
    E = 16
    pick = rng.choice(bbox.shape[0], P * E, replace=False)
    cbox = bbox[pick].contiguous()
    cgid = torch.from_numpy(pick.astype(np.int64))
    cgid[::5] = -10
    shard = torch.arange(P).repeat_interleave(E)
    cvalid = (shard != me) & (cgid >= 0)
    dev = cuda_device
    for tb, cb, kw in ((tbox, bbox, dict(kh=1, k=0, tgid0=me * B,
                                         cvalid=remote)),
                       (tbox, cbox, dict(kh=8, k=8, tgid0=me * B,
                                         cgid=cgid, cvalid=cvalid))):
        kh = kw.pop("kh")
        want = tmesh._rescue_select_ref(tb, cb, rcut2, kh, chunk=7, **kw)
        on = {key: (v.to(dev) if torch.is_tensor(v) else v)
              for key, v in kw.items()}
        cbd = cb.to(dev)
        table = tmesh.select_unions(cbd) if given else None
        got = tmesh.rescue_select(tb.to(dev), cbd, rcut2, kh, unions=table,
                                  **on)
        _assert_bits(got, want)
        assert int(want.need) > 0


@pytest.mark.cuda
@pytest.mark.filterwarnings("ignore:overflow encountered",
                            "ignore:invalid value encountered")
@pytest.mark.parametrize("name", ODD)
def test_select_unions_and_odd_boxes_on_card(cuda_device, name):
    """The union kernel bit for bit against ``_union_boxes`` on ragged,
    inverted, NaN and huge boxes (NaN propagates), its stats zeroed; the
    selection on those boxes against the plain version, its near-group
    counter equal to the plain count."""
    box = torch.from_numpy(_odd_boxes(name))
    dev = cuda_device
    u0 = tmesh.UNION_LAUNCHES
    table = tmesh.select_unions(box.to(dev))
    torch.cuda.synchronize()
    assert tmesh.UNION_LAUNCHES == u0 + 1
    np.testing.assert_array_equal(table.boxes.cpu().numpy(),
                                  _numpy_unions(box.numpy()))
    assert table.stats.cpu().tolist() == [0, 0, 0, 0]
    rcut2 = tmesh._rcut2(12.0)
    kh = min(4, box.shape[0])
    want = tmesh._rescue_select_ref(box, box, rcut2, kh, chunk=64,
                                    count_groups=True)
    got = tmesh.rescue_select(box.to(dev), box.to(dev), rcut2, kh,
                              count_groups=True, unions=table)
    _assert_bits(got, want)
    assert int(got.groups) == int(want.groups)


@pytest.mark.cuda
def test_selection_phase_is_two_device_ops_on_card(cuda_device):
    """The main path's selection phase (``_rescue_select``) enqueues two
    device operations, the boxes with their unions and the selection: no
    fill, no union kernel (counted from a profiler trace)."""
    from tpu_nbody_torch import profiling
    spos, smass, salive, a, S, k, k_hot, chunk = _scene("bench_32k")
    on = [t.to(cuda_device) for t in (spos, smass, salive)]
    ops = profiling.device_ops(lambda: tmesh._rescue_select(
        *on, a, band=S, k=k, chunk=chunk))
    assert len(ops) == 2, ops
    assert "block_boxes" in ops[0] and "select" in ops[1], ops


@pytest.mark.cuda
@pytest.mark.parametrize("P", [2, 4])
def test_cross_shard_selection_on_card(cuda_device, P, monkeypatch):
    """``_cross_shard_rescue`` on P thread ranks of the card: each of its
    selections (the export scores, the import picks) equals the plain
    version on the same inputs bit for bit, two launches a rank; the
    accelerations match the CPU ranks' within 1e-5 of max |a|, the needs
    exactly."""
    from tpu_nbody_torch.parallel import sharded_pm as tpm
    from tpu_nbody_torch.parallel.collectives import ThreadGroup, run_spmd
    real = tmesh.rescue_select
    checked = []

    def held(tbox, cbox, rcut2, kh, **kw):
        got = real(tbox, cbox, rcut2, kh, **kw)
        cpu = {key: (v.cpu() if torch.is_tensor(v) else v)
               for key, v in kw.items()}
        want = tmesh._rescue_select_ref(tbox.cpu(), cbox.cpu(), rcut2, kh,
                                        **cpu)
        _assert_bits(got, want)
        checked.append(kh)
        return got

    spos, smass, salive, a = _two_disk(30_000, 1 << 15, 13)
    n = (1 << 15) // P
    kw = dict(band=128, k=8, export_cap=64, chunk=4096)

    def run(device):
        g = ThreadGroup(P, device, timeout=120)
        local = [tuple(x[r * n:(r + 1) * n].to(device)
                       for x in (spos, smass, salive)) for r in range(P)]
        return run_spmd(g, lambda x: tpm._cross_shard_rescue(
            *x, SOFT2, a, group=g, switch="poly4", **kw), local)

    want = run("cpu")
    monkeypatch.setattr(tmesh, "rescue_select", held)
    n0 = tmesh.SELECT_LAUNCHES
    got = run(cuda_device)
    torch.cuda.synchronize()
    assert tmesh.SELECT_LAUNCHES == n0 + 2 * P and len(checked) == 2 * P
    for g_, w_ in zip(got, want):
        scale = float(w_[0].abs().max())
        assert float((g_[0].cpu() - w_[0]).abs().max()) <= 1e-5 * scale
        assert (int(g_[1]), int(g_[2])) == (int(w_[1]), int(w_[2]))
    assert max(int(w_[2]) for w_ in want) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bench_16k_two_tier", "ties_two_tier"])
def test_block_rescue_selection_on_card(cuda_device, name):
    """Both tiers on the card: one selection and two pair launches, the
    needs and the accelerations of the CPU run (within 1e-5 of max |a|,
    the tolerance of test_block_rescue_on_card_matches_cpu)."""
    spos, smass, salive, a, S, k, k_hot, chunk = _scene(name)
    kw = dict(band=S, k=k, chunk=chunk, k_hot=k_hot, hot_cap=16,
              switch="poly4")
    want, need, hot = tmesh._block_rescue(spos, smass, salive, SOFT2, a,
                                          **kw)
    s0, r0 = tmesh.SELECT_LAUNCHES, tband.RESCUE_LAUNCHES
    got, need_c, hot_c = tmesh._block_rescue(
        spos.to(cuda_device), smass.to(cuda_device), salive.to(cuda_device),
        SOFT2, a, **kw)
    torch.cuda.synchronize()
    assert tmesh.SELECT_LAUNCHES == s0 + 1
    assert tband.RESCUE_LAUNCHES == r0 + 2
    assert (int(need_c), int(hot_c)) == (int(need), int(hot))
    scale = float(want.abs().max())
    assert math.isfinite(scale) and scale > 0
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * scale
