"""The Barnes–Hut point-mass pair blocks (``traverse.point_accel``, kernel
``csrc/bh_pairs.cu``) and their plain version ``traverse._point_accel``.

On the CPU: ``point_accel`` at the hier call's shapes (C groups sharing
their candidates, each with its own masses) and the dense call's (C = 1)
equals the JAX package's ``_point_accel`` on the same numpy inputs within
1e-6 of each value (1e-6 of the largest magnitude near zero: the two sum
in different orders); the wrapper's plain path is ``_point_accel`` with
the sources broadcast over C, bit for bit; the plan (its splits too) and
the work count; the refusals. A numpy model of the split (each set's
source units dealt round robin to its CTAs, the units whose masses are all
0 skipped, the CTAs' sums added in split order) matches
``point_accel_ref`` within 1e-6 of the largest magnitude. The JAX package
is imported inside the tests that use it, so the ``cuda`` tests also
collect where jax is missing.

On the card (marker ``cuda``, skipped without one): the kernel against its
plain version within 1e-5 of the largest magnitude at small, ragged,
padded and all-zero shapes and at every split (the dense group and chunk
shapes, S not a multiple of a tile, NT < 32, a set whose only nonzero
mass is in its last unit), the same bits from run to run, one split bit
for bit with a model of the kernel before the split (the tiles of 256
sources in order, lane L their sources L, L + lanes, ..., each operation
rounded as the kernel rounds it, the lane sums added in lane order), the
launch count, and whole passes of the dense, bfs and hier traversals on
the card against the same passes on the CPU (hier through
csrc/bh_hier.cu, tests/test_torch_bh_hier.py).
"""

import numpy as np
import pytest
import torch

from tpu_nbody_torch.ops import traverse as ttraverse
from tpu_nbody_torch.ops import tree as ttree

torch.set_num_threads(2)

SOFT2 = 1.0


def _inputs(M, C, NT, S, seed=0, zero_frac=0.5, tail=0):
    """Targets (M, C, NT, 2) in a 300 px square, sources (M, S, 2) around
    them, masses (M, C, S) with ``zero_frac`` of them 0 (masked candidates)
    and the last ``tail`` slots 0 (padding), as numpy float32."""
    rng = np.random.default_rng(seed)
    tgt = (rng.random((M, C, NT, 2)) * 300.0).astype(np.float32)
    src = (rng.random((M, S, 2)) * 600.0 - 150.0).astype(np.float32)
    mass = rng.uniform(0.1, 5.0, (M, C, S)).astype(np.float32)
    mass[rng.random((M, C, S)) < zero_frac] = 0.0
    if tail:
        mass[..., S - tail:] = 0.0
    return tgt, src, mass


def _jax_point_accel(tgt, src, mass):
    """The JAX package's ``_point_accel`` over every (m, c) set."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from tpu_nbody.ops import traverse as jtraverse
    per_set = jax.vmap(jtraverse._point_accel, in_axes=(0, None, 0, None))
    f = jax.jit(jax.vmap(per_set, in_axes=(0, 0, 0, None)))
    return np.asarray(f(jnp.asarray(tgt), jnp.asarray(src),
                        jnp.asarray(mass), jnp.float32(SOFT2)))


@pytest.mark.parametrize("shape", [
    (3, 8, 64, 700),      # hier: 8 groups of a chunk share 700 candidates
    (5, 1, 64, 300),      # dense: one group a row
    (2, 3, 37, 257)])     # ragged: no multiple of a warp or a tile
def test_point_accel_matches_jax(shape):
    tgt, src, mass = _inputs(*shape, tail=40)
    want = _jax_point_accel(tgt, src, mass)
    got = ttraverse.point_accel(*map(torch.from_numpy, (tgt, src, mass)),
                                SOFT2).numpy()
    assert got.shape == shape[:3] + (2,)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_plain_path_is_point_accel_broadcast():
    tgt, src, mass = map(torch.from_numpy, _inputs(3, 8, 64, 500))
    got = ttraverse.point_accel(tgt, src, mass, SOFT2)
    want = torch.stack([ttraverse._point_accel(tgt[:, c], src, mass[:, c],
                                               SOFT2) for c in range(8)], 1)
    assert torch.equal(got, ttraverse._point_accel(tgt, src[:, None], mass,
                                                   SOFT2))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _galaxy_tree(n=1500, cap=1536, device="cpu"):
    rng = np.random.default_rng(7)
    r = 300.0 * np.sqrt(rng.random(n))
    th = 2 * np.pi * rng.random(n)
    pos = np.zeros((cap, 2), np.float32)
    pos[:n, 0] = 1200.0 + r * np.cos(th)
    pos[:n, 1] = r * np.sin(th)
    mass = np.zeros(cap, np.float32)
    mass[:n] = rng.uniform(0.5, 2.0, n)
    alive = np.arange(cap) < n
    t = lambda x: torch.from_numpy(x).to(device)   # noqa: E731
    return ttree.build_tree(t(pos), t(mass), t(alive), (-2.0, -1202.0),
                            2404.0, num_nodes=8 * (cap // 8) + 64,
                            leaf_size=8, max_depth=8)


CAPS = dict(group_size=64, group_cap=512, max_depth=8, frontier_cap=1024,
            approx_cap=2048, leaf_list_cap=512, direct_body_cap=4096,
            group_chunk=16)


@pytest.mark.parametrize("trav", ["dense", "bfs", "hier"])
def test_passes_use_the_wrapper(monkeypatch, trav):
    """Every traversal's force evaluation goes through ``point_accel``:
    the plain version runs only under it."""
    calls = []
    real = ttraverse.point_accel

    def spy(targets, sources, masses, soft2):
        calls.append((tuple(targets.shape), tuple(masses.shape)))
        return real(targets, sources, masses, soft2)

    monkeypatch.setattr(ttraverse, "point_accel", spy)
    plain = ttraverse._point_accel
    inside = []

    def spy_plain(*a):
        inside.append(len(calls))
        return plain(*a)

    monkeypatch.setattr(ttraverse, "_point_accel", spy_plain)
    acc, _ = ttraverse.bh_accel_from_tree(_galaxy_tree(), 0.5, SOFT2, 80.0,
                                          traversal=trav, **CAPS)
    assert calls and len(inside) == len(calls) and float(acc.abs().max()) > 0
    C = 8 if trav == "hier" else 1
    assert all(t[1] == C and m[1] == C for t, m in calls)


@pytest.mark.parametrize("NT,want", [
    (512, (8, 64, 4, 256)), (64, (8, 8, 32, 256)), (37, (8, 5, 51, 255)),
    (1, (1, 1, 256, 256)), (3, (2, 2, 128, 256)), (8192, (8, 1024, 1, 1024)),
    (2048, (8, 256, 1, 256))])
def test_pairs_plan(NT, want):
    """T, tpg, lanes, threads: every target held, at most 1024 threads,
    and the lane sums (threads × T float2) within 48 KB beside a tile
    and its unit flags; without the card's CTA count, one split."""
    plan = ttraverse._pairs_plan(NT)
    assert tuple(plan) == want + (1,)
    assert plan.tpg * plan.T >= NT and plan.threads <= 1024
    if plan.lanes > 1:
        assert plan.threads * plan.T * 8 + 256 * 16 + 36 <= 48 * 1024


@pytest.mark.parametrize("NT,S,sets,ctas,splits", [
    (512, 4096, 64, 396, 4),      # the dense chunk: half the card
    (512, 4096, 1, 396, 8),       # one group: the most splits a set
    (512, 4096, 200, 396, 1),     # enough sets: no split
    (512, 50, 1, 396, 2),         # a unit of sources a CTA at least
    (64, 700, 24, 1056, 8),
    (512, 4096, 64, 0, 1),        # no card count: no split
    (100, 0, 24, 396, 1),         # no sources
    (4096, 65536, 500, 1056, 2)])  # the partial sums capped at 32 MB
def test_pairs_plan_splits(NT, S, sets, ctas, splits):
    """splits: the sets' CTAs fill half the card where the sources, the
    cap of splits a set and the partial sums' bytes allow."""
    plan = ttraverse._pairs_plan(NT, S=S, sets=sets, ctas=ctas)
    assert plan.splits == splits
    assert 1 <= plan.splits <= ttraverse._PAIRS_MAX_SPLITS
    assert plan.splits == 1 or (
        sets * plan.splits * NT * 8 <= ttraverse._PAIRS_SCRATCH
        and (plan.splits - 1) * ttraverse._PAIRS_UNIT < S)
    assert tuple(plan)[:4] == tuple(ttraverse._pairs_plan(NT))[:4]


def _split_model(tgt, src, mass, splits):
    """csrc/bh_pairs.cu's split in numpy: set (m, c)'s source slots dealt
    in units of ``_PAIRS_UNIT`` (a tile of 256 with one split) to
    ``splits`` CTAs round robin, a unit whose masses are all 0 skipped,
    each CTA's sum (float32, numpy's order) kept where it walked a unit,
    and the kept sums added in split order from +0.0."""
    unit = ttraverse._PAIRS_TILE if splits == 1 else ttraverse._PAIRS_UNIT
    M, C, NT, _ = tgt.shape
    S = src.shape[1]
    out = np.zeros((M, C, NT, 2), np.float32)
    f = np.float32
    for m in range(M):
        for c in range(C):
            t = tgt[m, c]
            acc = np.zeros((NT, 2), np.float32)
            for sp in range(splits):
                slots = [j for u in range(sp, -(-S // unit), splits)
                         for j in range(u * unit, min(S, (u + 1) * unit))
                         if mass[m, c, u * unit:(u + 1) * unit].any()]
                if not slots:
                    continue
                d = src[m, slots][None, :, :] - t[:, None, :]
                r2 = (d * d).sum(-1, dtype=f) + f(SOFT2)
                wgt = mass[m, c, slots][None, :] / (r2 * np.sqrt(r2))
                acc = acc + (wgt[..., None] * d).sum(1, dtype=f)
            out[m, c] = acc
    return out


@pytest.mark.parametrize("splits", [1, 3, 8, 32])
def test_split_model_matches_plain(splits):
    """The split's order of sums, on a dense-like set (a prefix of nonzero
    masses with holes, then padding), a set whose only nonzero mass is in
    its last unit and an all-zero set."""
    tgt, src, mass = _inputs(1, 4, 64, 1000, zero_frac=0.3, tail=400)
    mass[0, 1] = 0.0
    mass[0, 1, -1] = 2.0
    mass[0, 2] = 0.0
    got = _split_model(tgt, src, mass, splits)
    want = ttraverse.point_accel_ref(*map(torch.from_numpy,
                                          (tgt, src, mass)), SOFT2).numpy()
    assert not got[0, 2].any()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("bad", [dict(NT=0), dict(NT=8193), dict(NT=64, T=3)])
def test_pairs_plan_refuses(bad):
    with pytest.raises(ValueError):
        ttraverse._pairs_plan(**bad)


def test_pair_work_counts_nonzero_masses():
    mass = torch.zeros((2, 3, 100))
    mass[0, 1, :7] = 1.0
    mass[1, 2, 50:55] = 2.0
    w = ttraverse.pair_work(mass, 64)
    assert w["pairs"] == 12 * 64 and w["flops"] == 13 * 12 * 64
    assert w["bytes"] == 4 * (2 * 3 * 64 * 4 + 2 * 100 * 2 + 2 * 3 * 100)


def test_point_accel_refusals():
    """A tensor neither on the CPU nor on a card raises; a CPU call counts
    no launch."""
    tgt, src, mass = map(torch.from_numpy, _inputs(2, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ttraverse.point_accel(tgt.to("meta"), src.to("meta"),
                              mass.to("meta"), SOFT2)
    n0 = ttraverse.LAUNCHES
    ttraverse.point_accel(tgt, src, mass, SOFT2)
    assert ttraverse.LAUNCHES == n0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _assert_close_to(got, want):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("M,C,NT,S,zero_frac,tail", [
    (3, 8, 64, 700, 0.5, 40), (5, 1, 64, 300, 0.0, 0),
    (2, 3, 37, 257, 0.3, 0), (4, 8, 512, 5000, 0.9, 3000),
    (1, 1, 1, 1, 0.0, 0), (2, 2, 3, 1000, 0.5, 999),
    (1, 2, 2048, 600, 0.2, 0), (6, 4, 100, 0, 0.0, 0)])
def test_point_accel_kernel_matches_plain_on_card(cuda_device, M, C, NT, S,
                                                  zero_frac, tail):
    """Group sizes 1 to 2048, sources below, at and past a tile, padded
    tails the kernel skips, no sources at all; one launch a call."""
    tgt, src, mass = (torch.from_numpy(x).to(cuda_device) for x in
                      _inputs(M, C, NT, S, zero_frac=zero_frac, tail=tail))
    n0 = ttraverse.LAUNCHES
    got = ttraverse.point_accel(tgt, src, mass, SOFT2)
    want = ttraverse._point_accel(tgt, src[:, None], mass, SOFT2)
    torch.cuda.synchronize()
    assert ttraverse.LAUNCHES == n0 + 1
    if S == 0:
        assert not got.any()
    else:
        _assert_close_to(got, want)


def _prefix_inputs(M, C, NT, S, live, seed=1):
    """The dense traversal's lists: each set's first ``live`` slots hold
    masses with a fifth of them 0 (holes), the rest is padding."""
    tgt, src, mass = _inputs(M, C, NT, S, seed=seed, zero_frac=0.2)
    mass[..., live:] = 0.0
    return tgt, src, mass


@pytest.mark.cuda
@pytest.mark.parametrize("M,C,NT,S,live", [
    (1, 1, 512, 4096, 1200),     # one dense group
    (64, 1, 512, 4096, 700),     # the dense chunk
    (5, 2, 100, 1000, 1000),     # S not a multiple of a tile
    (6, 3, 20, 700, 400)])       # NT < 32
@pytest.mark.parametrize("splits", [1, 2, 7, 16, 32])
def test_point_accel_splits_match_plain_on_card(cuda_device, M, C, NT, S,
                                                live, splits):
    """Every split against the plain version; the plan's own split
    twice, the same bits."""
    tgt, src, mass = (torch.from_numpy(x).to(cuda_device) for x in
                      _prefix_inputs(M, C, NT, S, live))
    want = ttraverse._point_accel(tgt, src[:, None], mass, SOFT2)
    plan = ttraverse._pairs_plan(NT)._replace(splits=splits)
    _assert_close_to(ttraverse._pairs_launch(tgt, src, mass, SOFT2, plan),
                     want)
    got = ttraverse.point_accel(tgt, src, mass, SOFT2)
    again = ttraverse.point_accel(tgt, src, mass, SOFT2)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_close_to(got, want)


def _fma32(a, b, c):
    """fmaf(a, b, c) of float32 tensors, rounded once: a b is exact in
    float64 and s + e the exact sum (TwoSum); s rounded to float32 is the
    answer unless s fell on a float32 midpoint that the exact sum is not
    on, where e says which neighbour."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    r = s.float()
    inf = torch.full_like(r, float("inf"))
    o = torch.nextafter(r, torch.where(s > r.double(), inf, -inf))
    tie = (s == (r.double() + o.double()) / 2) & (e != 0)
    return torch.where(tie, torch.where(e > 0, torch.maximum(r, o),
                                        torch.minimum(r, o)), r)


def _one_split_model(tgt, src, mass, soft2):
    """The kernel before the split, op by op, in torch on the card: set g
    walks the tiles of 256 source slots in order, skipping a tile whose
    masses are all 0; in a tile of n slots, lane L of the plan's lanes
    takes slots L, L + lanes, ... < n into its sums of each target i, a
    pair at a time: dx, dy rounded differences, r2 = fmaf(dx, dx,
    fmaf(dy, dy, soft2)), inv = rsqrt (the card's approximation, as
    torch.rsqrt gives it), f = m ((inv inv) inv), a = fmaf(f, d, a); the
    lanes' sums added in lane order from +0.0."""
    M, C, NT, _ = tgt.shape
    S = src.shape[1]
    lanes = ttraverse._pairs_plan(NT).lanes
    tile = ttraverse._PAIRS_TILE
    G = M * C
    tg = tgt.reshape(G, NT, 1, 2)
    rows = torch.arange(G, device=tgt.device) // C
    ms = mass.reshape(G, S)
    acc = torch.zeros((2, G, NT, lanes), dtype=torch.float32,
                      device=tgt.device)
    L = torch.arange(lanes, device=tgt.device)
    for t0 in range(0, S, tile):
        n = min(tile, S - t0)
        live = (ms[:, t0:t0 + n] != 0).any(1)
        for j0 in range(0, n, lanes):
            j = t0 + j0 + L
            ok = (live[:, None] & (j0 + L < n)[None, :])[:, None, :]
            j = j.clamp(max=S - 1)
            p = src[rows][:, j]                              # (G, lanes, 2)
            m = ms[:, j][:, None, :]
            dx = p[:, None, :, 0] - tg[..., 0]               # (G, NT, lanes)
            dy = p[:, None, :, 1] - tg[..., 1]
            r2 = _fma32(dx, dx, _fma32(dy, dy,
                                       torch.full_like(dy, soft2)))
            inv = torch.rsqrt(r2)
            f = m * ((inv * inv) * inv)
            acc = torch.where(ok, torch.stack([_fma32(f, dx, acc[0]),
                                               _fma32(f, dy, acc[1])]), acc)
    out = acc[..., 0]
    if lanes > 1:
        out = torch.zeros_like(out)
        for q in range(lanes):
            out = out + acc[..., q]
    return out.permute(1, 2, 0).reshape(M, C, NT, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("M,C,NT,S,zero_frac,tail", [
    (2, 3, 64, 700, 0.5, 300),    # 32 lanes, a dead tile, a short tile
    (1, 2, 512, 1000, 0.2, 0),    # the dense group's 4 lanes
    (3, 1, 20, 300, 0.9, 0),      # NT < 32: 85 lanes of 3 threads
    (1, 1, 2048, 300, 0.3, 0)])   # one lane
def test_one_split_is_the_kernel_before_the_split_on_card(
        cuda_device, M, C, NT, S, zero_frac, tail):
    """One split, the path of the many-set sharded imports, gives the
    bits of the kernel before the split: its tile order modelled op by
    op."""
    tgt, src, mass = (torch.from_numpy(x).to(cuda_device) for x in
                      _inputs(M, C, NT, S, zero_frac=zero_frac, tail=tail))
    plan = ttraverse._pairs_plan(NT)
    assert plan.splits == 1
    got = ttraverse._pairs_launch(tgt, src, mass, SOFT2, plan)
    want = _one_split_model(tgt, src, mass, SOFT2)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 4, 32])
def test_point_accel_last_unit_only_on_card(cuda_device, splits):
    """A set whose only nonzero mass is in its last (short) unit, beside
    an all-zero set: the last CTA's sum alone, and exact zeros."""
    tgt, src, mass = (torch.from_numpy(x).to(cuda_device) for x in
                      _inputs(1, 2, 64, 4000, zero_frac=1.0))
    mass[0, 0, -1] = 3.0
    plan = ttraverse._pairs_plan(64)._replace(splits=splits)
    got = ttraverse._pairs_launch(tgt, src, mass, SOFT2, plan)
    want = ttraverse._point_accel(tgt, src[:, None], mass, SOFT2)
    torch.cuda.synchronize()
    assert not got[0, 1].any() and got[0, 0].abs().max() > 0
    _assert_close_to(got, want)


@pytest.mark.cuda
def test_point_accel_splits_on_four_streams_on_card(cuda_device):
    """Split calls on four streams at once (each stream its own tickets)
    give the bits of one call alone."""
    tgt, src, mass = (torch.from_numpy(x).to(cuda_device) for x in
                      _prefix_inputs(64, 1, 512, 4096, 700))
    want = ttraverse.point_accel(tgt, src, mass, SOFT2)
    streams = [torch.cuda.Stream() for _ in range(4)]
    torch.cuda.synchronize()
    outs = []
    for _ in range(3):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(ttraverse.point_accel(tgt, src, mass, SOFT2))
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)


@pytest.mark.cuda
def test_pairs_split_scratch_refused_on_card(cuda_device):
    """A split plan past the partial sums' cap raises; it never falls
    back."""
    tgt, src, mass = (torch.from_numpy(x).to(cuda_device) for x in
                      _inputs(64, 1, 2048, 300))
    plan = ttraverse._pairs_plan(2048)._replace(splits=64)   # 64 MiB
    with pytest.raises(ValueError, match="partial sums"):
        ttraverse._pairs_launch(tgt, src, mass, SOFT2, plan)


@pytest.mark.cuda
def test_point_accel_kernel_all_zero_masses_on_card(cuda_device):
    """Every tile skipped: exact zeros."""
    tgt, src, mass = (torch.from_numpy(x).to(cuda_device) for x in
                      _inputs(4, 8, 512, 3000, zero_frac=1.0))
    got = ttraverse.point_accel(tgt, src, mass, SOFT2)
    torch.cuda.synchronize()
    assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("T,lanes", [(1, 1), (2, 4), (8, 1), (4, 16)])
def test_point_accel_kernel_plans_on_card(cuda_device, T, lanes):
    """Every launch shape computes the same sums."""
    tgt, src, mass = (torch.from_numpy(x).to(cuda_device) for x in
                      _inputs(3, 4, 64, 1500, zero_frac=0.4, tail=200))
    plan = ttraverse._pairs_plan(64, T=T)._replace(lanes=lanes)
    plan = plan._replace(threads=plan.tpg * lanes)
    got = ttraverse._pairs_launch(tgt, src, mass, SOFT2, plan)
    want = ttraverse._point_accel(tgt, src[:, None], mass, SOFT2)
    torch.cuda.synchronize()
    _assert_close_to(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("trav", ["dense", "bfs", "hier"])
def test_bh_pass_on_card_matches_cpu(cuda_device, trav):
    """A whole pass on the card (the kernels) against the same pass on
    the CPU (the plain versions): the lists are the same, the sums within
    1e-5 of max |a|; dense and bfs launch the pair kernel twice a chunk of
    groups, hier launches csrc/bh_hier.cu once and the pair kernel never."""
    want, st = ttraverse.bh_accel_from_tree(_galaxy_tree(), 0.5, SOFT2,
                                            80.0, traversal=trav, **CAPS)
    n0, h0 = ttraverse.LAUNCHES, ttraverse.HIER_LAUNCHES
    got, st_c = ttraverse.bh_accel_from_tree(
        _galaxy_tree(device=cuda_device), 0.5, SOFT2, 80.0, traversal=trav,
        **CAPS)
    torch.cuda.synchronize()
    launches = ttraverse.LAUNCHES - n0
    if trav == "hier":
        assert launches == 0 and ttraverse.HIER_LAUNCHES == h0 + 1
    else:
        assert launches >= 2 and launches % 2 == 0
    assert [int(x) for x in st_c.flat()] == [int(x) for x in st.flat()]
    _assert_close_to(got.cpu(), want)
