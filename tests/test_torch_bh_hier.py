"""The hier Barnes–Hut evaluation (``traverse.hier_accel``, kernel
``csrc/bh_hier.cu``) and its plain version ``traverse.hier_accel_ref``,
the masked-dense evaluation.

On the CPU, on a 1,500-body galaxy tree (``hier_sizes=(64, 8)``, groups of
at most 64 bodies): the port's ``_hier_accel`` (which takes the plain
version on CPU tensors) against the JAX package's ``_hier_accel`` on the
same groups, θ in {0.3, 0.5, 0.7}, within 2e-5 of max |a| on the members'
rows (the hier parity tolerance of tests/test_torch_bh.py; the two sum in
different orders), the needs exactly, also with caps that overflow; the
interaction sets the kernel computes (per group ``occ & leaf & ~pass_g``
direct, ``occ & pass_g & ~pass_g(parent)`` accepted, over the chunk's
candidates) against those of the masked-dense form, the same whenever no
cap overflows and a superset when one does; the wrapper's refusals and its
plain path. The JAX package is imported inside the tests that use it, so
the ``cuda`` tests also collect where jax is missing.

On the card (marker ``cuda``, skipped without one): the kernel against the
plain version within 1e-5 of max |plain| and with exactly the same
per-group counts, at group sizes 64, 512 and 2048 (every target layout),
with leaf bodies staged in pieces whose boundaries fall inside leaves,
groups of fewer than 32 bodies, a chunk with no direct leaf, caps that
overflow, and the walked-pairs counter.
"""

import functools

import numpy as np
import pytest
import torch

from tpu_nbody_torch.kernels import _build
from tpu_nbody_torch.ops import traverse as ttraverse
from tpu_nbody_torch.ops import tree as ttree

torch.set_num_threads(2)

SOFT2 = 1.0
SIZES = (64, 8)           # hier_sizes: chunks of 64 groups, then of 8
CAND_CAPS = (4096, 4096)
GROUP_CAP = 512
LC, DB = 512, 4096        # leaf_list_cap, direct_body_cap: no overflow
TOL = 2e-5                # port vs JAX: max |diff| <= TOL * max |a|
KERNEL_TOL = 1e-5         # kernel vs plain: max |diff| <= this * max |plain|
ORIGIN, SIDE = (-2.0, -1202.0), 2404.0


def _bodies(n=1500, cap=1536, seed=7):
    """A galaxy disk of ``n`` bodies in a capacity of ``cap``, numpy."""
    rng = np.random.default_rng(seed)
    r = 300.0 * np.sqrt(rng.random(n))
    th = 2 * np.pi * rng.random(n)
    pos = np.zeros((cap, 2), np.float32)
    pos[:n, 0] = 1200.0 + r * np.cos(th)
    pos[:n, 1] = r * np.sin(th)
    mass = np.zeros(cap, np.float32)
    mass[:n] = rng.uniform(0.5, 2.0, n)
    return pos, mass, np.arange(cap) < n


def _tree_kw(cap):
    return dict(num_nodes=8 * (cap // 8) + 64, leaf_size=8, max_depth=8)


def _torch_tree(pos, mass, alive, device="cpu"):
    t = lambda x: torch.from_numpy(x).to(device)   # noqa: E731
    return ttree.build_tree(t(pos), t(mass), t(alive), ORIGIN, SIDE,
                            **_tree_kw(pos.shape[0]))


def _groups(tt, group_size):
    """make_groups and the group boxes, as bh_accel_from_tree forms them."""
    NC = tt.code.shape[0]
    gvalid, gstart, gcount, _ = ttraverse.make_groups(
        tt, group_size, min(GROUP_CAP, NC))
    gmin, gmax = ttraverse._group_aabb(tt.spos, gstart, gcount, gvalid,
                                       group_size)
    return gstart, gcount, gvalid, gmin, gmax


def _theta2(theta):
    return float(np.float32(theta) * np.float32(theta))


def _torch_hier(tt, theta, group_size=64, **caps):
    """The port's _hier_accel; returns (acc_rows, needs, groups)."""
    gstart, gcount, gvalid, gmin, gmax = _groups(tt, group_size)
    kw = dict(leaf_list_cap=LC, direct_body_cap=DB)
    kw.update(caps)
    acc, needs = ttraverse._hier_accel(
        tt, gstart, gvalid, gmin, gmax, _theta2(theta), SOFT2,
        group_size=group_size, hier_sizes=SIZES, cand_caps=CAND_CAPS,
        hier_batch=3, gcount=gcount, **kw)
    return acc, needs, (gstart, gcount, gvalid, gmin, gmax)


def _captured(tt, theta, group_size=64, **caps):
    """The arguments _hier_accel hands hier_accel on ``tt``: (positional,
    keyword)."""
    got = {}
    real = ttraverse.hier_accel

    def spy(*args, **kw):
        got.update(args=args, kw=kw)
        return real(*args, **kw)

    ttraverse.hier_accel = spy
    try:
        _torch_hier(tt, theta, group_size, **caps)
    finally:
        ttraverse.hier_accel = real
    return got["args"], got["kw"]


def _members(gstart, gcount, gvalid, GS, cap):
    """(groups, GS) bool: the window rows that hold a group's members."""
    sl0 = torch.clamp(gstart, 0, cap - GS)
    slot = sl0[:, None] + torch.arange(GS)[None, :]
    return gvalid[:, None] & (slot >= gstart[:, None]) \
        & (slot < (gstart + gcount)[:, None])


@functools.lru_cache(maxsize=None)
def _jax_hier_fn(**caps):
    import jax
    from tpu_nbody.ops import traverse as jtraverse
    return jax.jit(functools.partial(
        jtraverse._hier_accel, group_size=64, hier_sizes=SIZES,
        cand_caps=CAND_CAPS, hier_batch=32, **caps))


def _jax_hier(pos, mass, alive, groups, theta, **caps):
    """The JAX package's _hier_accel on the same bodies and groups."""
    jnp = pytest.importorskip("jax.numpy")
    from tpu_nbody.ops import tree as jtree
    jt = jtree.build_tree(jnp.asarray(pos), jnp.asarray(mass),
                          jnp.asarray(alive), ORIGIN, SIDE,
                          **_tree_kw(pos.shape[0]))
    kw = dict(leaf_list_cap=LC, direct_body_cap=DB)
    kw.update(caps)
    acc, needs = _jax_hier_fn(**kw)(
        jt, *(jnp.asarray(x.numpy()) for x in groups),
        jnp.float32(_theta2(theta)), jnp.float32(SOFT2))
    return np.asarray(acc), {k: np.asarray(v) for k, v in needs.items()}


@pytest.mark.parametrize("theta", [0.3, 0.5, 0.7])
def test_plain_hier_matches_jax(theta):
    """Members' rows within TOL of max |a|, every other row 0; the needs
    exactly."""
    pos, mass, alive = _bodies()
    acc, needs, groups = _torch_hier(_torch_tree(pos, mass, alive), theta)
    want, jneeds = _jax_hier(pos, mass, alive, groups, theta)
    member = _members(*groups[:3], 64, pos.shape[0]).numpy()
    got = acc.numpy()
    assert got.shape == want.shape and member.sum() == alive.sum()
    np.testing.assert_allclose(got[member], want[member], rtol=0,
                               atol=TOL * np.abs(want[member]).max())
    assert not got[~member].any()
    for k in ("leaf_need", "direct_need", "cand_need"):
        np.testing.assert_array_equal(needs[k].numpy(), jneeds[k])


def test_hier_needs_match_jax_when_caps_overflow():
    """leaf_list_cap and direct_body_cap far below the needs: the needs
    and the overflow flag are the JAX package's, whichever evaluation
    runs (the needs are measured outside it)."""
    pos, mass, alive = _bodies()
    small = dict(leaf_list_cap=8, direct_body_cap=16)
    _, needs, groups = _torch_hier(_torch_tree(pos, mass, alive), 0.5,
                                   **small)
    _, jneeds = _jax_hier(pos, mass, alive, groups, 0.5, **small)
    for k in ("leaf_need", "direct_need", "cand_need"):
        np.testing.assert_array_equal(needs[k].numpy(), jneeds[k])
    assert int(needs["leaf_need"]) > 8 and int(needs["direct_need"]) > 16


def _kernel_sets(args):
    """The kernel's interaction sets, from its definition: per (chunk,
    group, candidate), accepted and direct masks (C, CH, K), and the
    candidates' rows."""
    node_rows, _, _, ids, cvalid, _, _, gvalid, gmin, gmax, theta2, \
        soft2 = args
    C, K = ids.shape
    CH = gvalid.shape[0] // C
    crows = node_rows[torch.where(cvalid, ids, 0).long()]     # (C, K, 14)
    occ = (cvalid & (crows[..., 0] > 0))[:, None, :]
    bmn, bmx = gmin.reshape(C, CH, 2), gmax.reshape(C, CH, 2)
    pn = ttraverse._box_pass_cols(bmn, bmx, crows[..., 3][:, None],
                                  crows[..., 4][:, None],
                                  crows[..., 5][:, None], theta2, soft2)
    pp = ttraverse._box_pass_cols(bmn, bmx, crows[..., 10][:, None],
                                  crows[..., 11][:, None],
                                  crows[..., 12][:, None], theta2, soft2) \
        & (crows[..., 13] != 0)[:, None]
    gv = gvalid.reshape(C, CH)[..., None]
    accept = occ & gv & pn & ~pp
    direct = occ & gv & (crows[..., 6] < 0)[:, None] & ~pn
    return accept, direct, crows, pn


def _masked_dense_direct(args, leaf_list_cap):
    """The masked-dense form's direct sets on the same candidates: the
    chunk's direct leaves (chunk-box MAC), the first ``leaf_list_cap`` in
    candidate order, less those each group's MAC passes."""
    node_rows, _, _, ids, cvalid, _, _, gvalid, gmin, gmax, theta2, \
        soft2 = args
    _, direct, crows, pn = _kernel_sets(args)
    C = ids.shape[0]
    CH = gvalid.shape[0] // C
    occ = cvalid & (crows[..., 0] > 0)
    pcn = ttraverse._box_pass_cols(
        gmin.reshape(C, CH, 2).amin(dim=1), gmax.reshape(C, CH, 2).amax(
            dim=1), crows[..., 3], crows[..., 4], crows[..., 5], theta2,
        soft2)
    dleaf = occ & (crows[..., 6] < 0) & ~pcn
    listed = dleaf & (torch.cumsum(dleaf, dim=1) <= leaf_list_cap)
    return listed[:, None, :] & gvalid.reshape(C, CH)[..., None] & ~pn, \
        direct, crows


@pytest.mark.parametrize("theta", [0.3, 0.7])
def test_direct_sets_are_the_chunk_leaves_each_group_opens(theta):
    """Per group, occ & leaf & ~pass_g is the chunk's direct leaves less
    those pass_g accepts (pass_chunk => pass_g); the plain version's
    per-group counts are the kernel sets' sizes."""
    pos, mass, alive = _bodies()
    args, kw = _captured(_torch_tree(pos, mass, alive), theta)
    md, direct, crows = _masked_dense_direct(args, LC)
    assert torch.equal(md, direct) and direct.any()
    accept, _, _, _ = _kernel_sets(args)
    _, counts, _ = ttraverse.hier_accel_ref(*args, **dict(kw, counts=True))
    bodies = crows[..., 9].to(torch.int64)[:, None, :]
    C, CH, _ = direct.shape
    assert torch.equal(counts.reshape(C, CH, 2)[..., 0].long(),
                       accept.sum(-1))
    assert torch.equal(counts.reshape(C, CH, 2)[..., 1].long(),
                       torch.where(direct, bodies, 0).sum(-1))


def test_kernel_sets_are_a_superset_when_the_leaf_cap_overflows():
    """With leaf_list_cap below a chunk's direct leaves the masked-dense
    form drops the leaves past it; the kernel's sets keep them (ROADMAP
    section 3). The plain version's counts fall short of the kernel
    sets' exactly there."""
    pos, mass, alive = _bodies()
    args, kw = _captured(_torch_tree(pos, mass, alive), 0.5)
    cap = 6
    md, direct, crows = _masked_dense_direct(args, cap)
    assert torch.equal(md & direct, md) and not torch.equal(md, direct)
    _, counts, _ = ttraverse.hier_accel_ref(
        *args, **dict(kw, leaf_list_cap=cap, counts=True))
    bodies = crows[..., 9].to(torch.int64)[:, None, :]
    C, CH, _ = direct.shape
    short = counts.reshape(C, CH, 2)[..., 1].long()
    assert torch.equal(short, torch.where(md, bodies, 0).sum(-1))
    assert (short <= torch.where(direct, bodies, 0).sum(-1)).all()


def test_cpu_tensors_take_the_plain_version():
    """The wrapper's CPU path is hier_accel_ref, bit for bit; no launch."""
    pos, mass, alive = _bodies()
    args, kw = _captured(_torch_tree(pos, mass, alive), 0.5)
    n0 = _build.LAUNCHES["bh_hier"]
    got = ttraverse.hier_accel(*args, **dict(kw, counts=True))
    want = ttraverse.hier_accel_ref(*args, **dict(kw, counts=True))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2] == want[2] > 0
    assert _build.LAUNCHES["bh_hier"] == n0


def _bad(args, i, x):
    return args[:i] + (x,) + args[i + 1:]


@pytest.mark.parametrize("i,bad,err", [
    (3, lambda t: t.float(), TypeError),            # ids not int32
    (4, lambda t: t.to(torch.uint8), TypeError),    # cvalid not bool
    (1, lambda t: t[:, :3], ValueError),            # body rows of 3 lanes
    (8, lambda t: t[:, :1], ValueError),            # gmin not (groups, 2)
    (5, lambda t: t[1:], ValueError),               # groups not C x CH
    (6, lambda t: t.long(), TypeError)])            # gcount not int32
def test_hier_accel_refuses_bad_arguments(i, bad, err):
    pos, mass, alive = _bodies(300, 512)
    args, kw = _captured(_torch_tree(pos, mass, alive), 0.5)
    with pytest.raises(err):
        ttraverse.hier_accel(*_bad(args, i, bad(args[i])), **kw)


def test_hier_accel_refuses_tensors_off_the_cpu_and_the_card():
    """Mixed devices, or no CUDA tensor to launch on, raise; no launch."""
    pos, mass, alive = _bodies(300, 512)
    args, kw = _captured(_torch_tree(pos, mass, alive), 0.5)
    n0 = _build.LAUNCHES["bh_hier"]
    with pytest.raises(ValueError, match="CUDA tensor"):
        ttraverse.hier_accel(*_bad(args, 0, args[0].to("meta")), **kw)
    meta = tuple(a.to("meta") if torch.is_tensor(a) else a for a in args)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ttraverse.hier_accel(*meta, **kw)
    with pytest.raises(ValueError, match="group_size"):
        ttraverse.hier_accel(*meta, **dict(kw, group_size=4096))
    assert _build.LAUNCHES["bh_hier"] == n0


def test_hier_pair_work_counts_members_times_sources():
    counts = torch.tensor([[3, 10], [0, 0], [1, 4]], dtype=torch.int32)
    gcount = torch.tensor([5, 0, 2], dtype=torch.int32)
    rows, body = torch.zeros(7, 14), torch.zeros(9, 4)
    ids = torch.zeros(1, 6, dtype=torch.int32)
    w = ttraverse.hier_pair_work(counts, gcount, rows, body, ids)
    assert w["pairs"] == 5 * 13 + 2 * 5 and w["flops"] == 13 * w["pairs"]
    assert w["bytes"] == 4 * (98 + 36) + 6 * 5 + 3 * 25 + 7 * 16


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _card_case(dev, theta, group_size, n=1500, cap=1536):
    """The captured hier_accel arguments of a pass on the card, with caps
    that no list overflows (every leaf and every body fits)."""
    pos, mass, alive = _bodies(n, cap)
    return _captured(_torch_tree(pos, mass, alive, dev), theta, group_size,
                     leaf_list_cap=cap, direct_body_cap=cap)


def _plain(args, kw):
    """The plain version with the plain pair sum (no kernel at all)."""
    return ttraverse.hier_accel_ref(
        *args, **dict(kw, counts=True,
                      pair_sum=ttraverse.point_accel_ref))


def _assert_close_to(got, want):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=KERNEL_TOL * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("theta", [1e-3, 0.3, 0.7])
@pytest.mark.parametrize("group_size,n,cap,stage", [
    (64, 1500, 1536, 2048), (64, 1500, 1536, 37), (512, 6000, 6144, 2048),
    (512, 6000, 6144, 101), (2048, 12000, 12288, 2048)])
def test_kernel_matches_plain_on_card(cuda_device, theta, group_size, n,
                                     cap, stage):
    """Sums within KERNEL_TOL of max |plain|, per-group counts exactly,
    rows outside the members 0, one launch. A stage below 2048 stages
    the bodies in pieces whose boundaries fall inside leaves."""
    args, kw = _card_case(cuda_device, theta, group_size, n, cap)
    want, wcnt, _ = _plain(args, kw)
    n0 = _build.LAUNCHES["bh_hier"]
    got, cnt, walked = ttraverse._hier_launch(*args, group_size, True,
                                              stage=stage)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bh_hier"] == n0 + 1
    assert torch.equal(cnt, wcnt)
    _assert_close_to(got, want)
    gstart, gcount, gvalid = args[5:8]
    member = _members(gstart.cpu(), gcount.cpu(), gvalid.cpu(), group_size,
                      cap).to(cuda_device)
    assert not got[~member].any()
    assert int(walked) >= int((gcount.long() * cnt.sum(1)).sum()) > 0


@pytest.mark.cuda
def test_small_groups_on_card(cuda_device):
    """Groups of fewer than 32 bodies (T = 1, a warp a lane) take their
    members' rows only."""
    args, kw = _card_case(cuda_device, 0.5, 64)
    gcount, gvalid = args[6], args[7]
    small = gvalid & (gcount < 32)
    assert small.any()
    want, _, _ = _plain(args, kw)
    got = ttraverse.hier_accel(*args, **kw)
    torch.cuda.synchronize()
    _assert_close_to(got[small], want[small])


@pytest.mark.cuda
def test_chunk_without_direct_leaf_on_card(cuda_device):
    """Chunk 0's leaves marked invalid: its groups sum accepted nodes
    only, and still agree."""
    args, kw = _card_case(cuda_device, 0.5, 64)
    node_rows, ids, cvalid = args[0], args[3], args[4].clone()
    leaf = node_rows[ids[0].long(), 6] < 0
    cvalid[0] &= ~leaf
    args = _bad(args, 4, cvalid)
    want, wcnt, _ = _plain(args, kw)
    got, cnt, _ = ttraverse.hier_accel(*args, **dict(kw, counts=True))
    torch.cuda.synchronize()
    CH = args[5].shape[0] // ids.shape[0]
    assert not cnt[:CH, 1].any() and cnt[:CH, 0].any()
    assert torch.equal(cnt, wcnt)
    _assert_close_to(got, want)


@pytest.mark.cuda
def test_kernel_keeps_what_overflowing_caps_drop_on_card(cuda_device):
    """With caps far below the needs the kernel's result is the plain
    version's at caps that fit, not the truncated one."""
    args, kw = _card_case(cuda_device, 0.5, 64)
    small = dict(kw, leaf_list_cap=6, direct_body_cap=40)
    got, cnt, _ = ttraverse.hier_accel(*args, **dict(small, counts=True))
    want, wcnt, _ = _plain(args, kw)
    short, scnt, _ = _plain(args, small)
    torch.cuda.synchronize()
    assert torch.equal(cnt, wcnt) and not torch.equal(cnt, scnt)
    _assert_close_to(got, want)
    assert float((got - short).abs().max()) > KERNEL_TOL * float(
        want.abs().max())


@pytest.mark.cuda
def test_walked_pairs_are_sources_times_slots_on_card(cuda_device):
    """Each group walks its sources against the slots its lanes hold:
    the smallest of 32, 64, ..., 2048 at or above its bodies."""
    args, kw = _card_case(cuda_device, 0.5, 64)
    _, cnt, walked = ttraverse.hier_accel(*args, **dict(kw, counts=True))
    gcount = args[6].long()
    slots = torch.clamp(2 ** torch.ceil(torch.log2(
        gcount.clamp(min=1).double())).long(), min=32)
    torch.cuda.synchronize()
    assert int(walked) == int((cnt.sum(1).long() * slots).sum())
