"""The rescue pair sum of the P3M short-range force
(``band.rescue_pair_sum``, kernel ``csrc/rescue.cu``) and its plain version.

On the CPU: the wrapper's plain path with the index interface equals
``_pair_sum`` on the gathered block rows bit for bit, in the three forms
the port calls it (the base tier, the hot tier with its clamped repeats,
the cross-shard import), on a capacity that is not a multiple of the
block; the two-tier ``_block_rescue`` through the wrapper matches the JAX
package's within 1e-5 of the largest magnitude, with equal needs; the
plan and the work count. The JAX package is imported inside the test that
uses it, so the ``cuda`` tests below also collect where jax is missing.

On the card (marker ``cuda``, skipped without one): the kernel against its
plain version within 1e-5 of the largest magnitude, at small, ragged,
repeated and all-invalid shapes, and the launch count.
"""

import numpy as np
import pytest
import torch

from tpu_nbody_torch.ops import band as tband
from tpu_nbody_torch.ops import mesh as tmesh

torch.set_num_threads(2)

SOFT2 = 1.0
ORIGIN, SIDE = (0.0, 0.0), 400.0


def _scene(n, cap, seed=0, device="cpu"):
    """``n`` alive bodies in ``cap`` slots, three clusters in a 400 px
    square (the Hilbert curve splits clusters, so blocks far apart in order
    are close in space), Hilbert-sorted."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((cap, 2), np.float32)
    centres = np.array([[100.0, 120.0], [260.0, 300.0], [300.0, 90.0]])
    pos[:n] = (centres[rng.integers(0, 3, n)]
               + rng.normal(0.0, 25.0, (n, 2))).astype(np.float32)
    mass = np.zeros(cap, np.float32)
    mass[:n] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    alive = np.arange(cap) < n
    spos, smass, salive, _ = tmesh._hilbert_sort(
        torch.from_numpy(pos).to(device), torch.from_numpy(mass).to(device),
        torch.from_numpy(alive).to(device), ORIGIN, SIDE)
    return spos.contiguous(), smass.contiguous(), salive


def _gathered(trows, tid, prows, pidx, pvalid, a, switch):
    """``_pair_sum`` on the rows gathered the way the rescue gathered them
    before it had an index interface."""
    m, k = pidx.shape
    S = trows.shape[1] // 3
    part = prows[pidx].reshape(m, k * S, 3)
    pm = (part[..., 2].reshape(m, k, S)
          * pvalid.to(trows.dtype)[:, :, None]).reshape(m, k * S)
    return tband._pair_sum(trows[tid].reshape(m, S, 3), part, pm, SOFT2, a,
                           switch)


def _forms(spos, smass, salive, S, k, a):
    """The three call forms of the port on one sorted scene: name -> the
    wrapper's arguments (trows, tid, prows, pidx, pvalid)."""
    sel = tmesh._rescue_select(spos, smass, salive, a, band=S, k=k,
                               chunk=4 * S)
    Xb = sel.rows
    B = sel.cnt.shape[0]
    dev = spos.device
    base = (Xb, torch.arange(Xb.shape[0], device=dev), Xb, sel.midx,
            sel.mval > 0)
    # hot tier: the blocks that want more than k partners, H slots, the
    # invalid ones clamped to block B - 1 (mesh.py) with no valid partner
    H, kh = 8, min(3 * k, B)
    hot = torch.nonzero(sel.cnt > k).reshape(-1)[:3]
    hid = torch.full((H,), B - 1, dtype=torch.int64, device=dev)
    hid[:hot.numel()] = hot
    hvalid = torch.arange(H, device=dev) < hot.numel()
    g2 = tmesh._box_gaps(sel.bbox[hid], *sel.bbox.unbind(1))
    rcut2 = (2.0 * a) ** 2
    mask = (g2 < rcut2) & ((hid[:, None] - torch.arange(B, device=dev)
                            [None, :]).abs() > 1)
    mval, midx = tmesh._topk_lowest_index(
        torch.where(mask, rcut2 - g2, 0.0), kh)
    hot_args = (Xb, hid, Xb, midx[:, k:],
                (mval[:, k:] > 0) & hvalid[:, None])
    # cross-shard: other rows as partners (the imports), every fourth
    # partner slot invalid
    imp = torch.flip(Xb[:B], dims=[0]).contiguous()
    pidx = torch.remainder(sel.midx * 7 + 3, B)
    pvalid = (sel.mval > 0) | (torch.arange(sel.k, device=dev) % 4 == 1)
    cross = (Xb, torch.arange(Xb.shape[0], device=dev), imp, pidx,
             pvalid & (torch.arange(sel.k, device=dev) % 4 != 0))
    return {"base": base, "hot": hot_args, "cross": cross}, sel


@pytest.mark.parametrize("switch", ["poly4", "exp4"])
@pytest.mark.parametrize("form", ["base", "hot", "cross"])
def test_plain_path_equals_gathered_pair_sum(form, switch):
    """Bit for bit, ragged capacity (1000 bodies, 1001 slots, S = 32: the
    last block holds 9 slots and 23 of padding), with and without chunks."""
    S, k = 32, 4
    a = 12.0
    spos, smass, salive = _scene(1000, 1001)
    forms, sel = _forms(spos, smass, salive, S, k, a)
    args = forms[form]
    if form == "hot":
        assert int(args[4].sum()) > 0 and (args[1] == sel.cnt.shape[0] - 1
                                           ).sum() >= 2
    want = _gathered(*args, a, switch)
    got = tband.rescue_pair_sum(*args, SOFT2, a, switch)
    got_chunked = tband.rescue_pair_sum(*args, SOFT2, a, switch, chunk=3)
    assert got.shape == (args[3].shape[0], S, 2)
    assert torch.equal(got, want) and torch.equal(got_chunked, want)
    assert float(want.abs().max()) > 0


def test_block_rescue_uses_the_wrapper(monkeypatch):
    """Both tiers of ``_block_rescue`` go through the wrapper (and the
    plain pair sum only under it), with the hot tier's repeated rows."""
    calls = []
    real = tband.rescue_pair_sum

    def spy(trows, tid, *rest, **kw):
        calls.append(tid.clone())
        return real(trows, tid, *rest, **kw)

    monkeypatch.setattr(tband, "rescue_pair_sum", spy)
    spos, smass, salive = _scene(1000, 1024)
    tmesh._block_rescue(spos, smass, salive, SOFT2, 12.0, band=32, k=7,
                        chunk=128, k_hot=12, hot_cap=64)
    assert len(calls) == 2
    assert (calls[1] == calls[1].max()).sum() >= 2


@pytest.mark.parametrize("cap,k,k_hot,hot_cap", [
    (1024, 2, 0, 128), (1001, 2, 6, 64), (1001, 3, 8, 4)])
def test_block_rescue_matches_jax(cap, k, k_hot, hot_cap):
    """One and two tiers, ragged capacities, a hot cap below and above the
    hot blocks: within 1e-5 of max |a| of the JAX package, needs equal."""
    jnp = pytest.importorskip("jax.numpy")
    from tpu_nbody.ops import mesh as jmesh
    spos, smass, salive = _scene(1000, cap)
    a = 12.0
    kw = dict(band=32, k=k, chunk=128, k_hot=k_hot, hot_cap=hot_cap,
              switch="poly4")
    acc_j, need_j, hot_j = jmesh._block_rescue(
        *(jnp.asarray(x.numpy()) for x in (spos, smass, salive)), SOFT2,
        jnp.float32(a), **kw)
    acc_t, need_t, hot_t = tmesh._block_rescue(spos, smass, salive, SOFT2,
                                               a, **kw)
    assert int(need_t) == int(need_j) > k and int(hot_t) == int(hot_j) > 0
    want = np.asarray(acc_j)
    np.testing.assert_allclose(acc_t.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("S,k,want", [
    (128, 8, (4, 8, 32, 256, 16384)), (128, 20, (4, 8, 32, 256, 16384)),
    (128, 2, (4, 2, 32, 64, 4096)), (1024, 8, (4, 1, 256, 256, 16384)),
    (256, 4, (4, 4, 64, 256, 16384)), (3, 5, (2, 5, 2, 10, 240)),
    (1, 1, (1, 1, 1, 1, 16)), (100, 8, (4, 8, 25, 200, 12800))])
def test_rescue_plan(S, k, want):
    """T, PL, tps, threads, shared bytes: whole warps a lane at S = 128,
    staging within the default 48 KB, PL never above k."""
    plan = tband._rescue_plan(S, k)
    assert tuple(plan) == want
    assert plan.smem <= 48 * 1024 and plan.threads <= 1024
    assert plan.PL <= k and plan.tps * plan.T >= S


@pytest.mark.parametrize("bad", [dict(S=0, k=1), dict(S=1025, k=1),
                                 dict(S=128, k=0), dict(S=128, k=1, T=3)])
def test_rescue_plan_refuses(bad):
    with pytest.raises(ValueError):
        tband._rescue_plan(**bad)


def test_rescue_pair_work():
    """The bench's shape: 2^20 bodies, S = 128, k = 8, every slot valid,
    is 1.07e9 pairs at 21 flops (poly4)."""
    m, k, S = 8192, 8, 128
    w = tband.rescue_pair_work(m, k, S, m * k, m, "poly4")
    assert w["pairs"] == (1 << 20) * k * S == 1073741824
    assert w["flops"] == 21 * w["pairs"]
    assert w["bytes"] == m * S * 12 + m * (8 + 9 * k) + m * S * 8
    assert tband.rescue_pair_work(m, k, S, 0, m)["pairs"] == 0


def test_rescue_wrapper_refusals():
    """A tensor that is neither on the CPU nor on a card raises, as do
    shapes that disagree; a CPU call counts no launch."""
    rows = torch.zeros((4, 96))
    tid = torch.arange(4)
    pidx = torch.zeros((4, 2), dtype=torch.int64)
    pvalid = torch.ones((4, 2), dtype=torch.bool)
    meta = [t.to("meta") for t in (rows, tid, rows, pidx, pvalid)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        tband.rescue_pair_sum(*meta, SOFT2, 2.0, "poly4")
    with pytest.raises(ValueError, match="disagree"):
        tband.rescue_pair_sum(rows, tid, torch.zeros((4, 48)), pidx, pvalid,
                              SOFT2, 2.0)
    n0 = tband.RESCUE_LAUNCHES
    out = tband.rescue_pair_sum(rows, tid, rows, pidx[:, :0],
                                pvalid[:, :0], SOFT2, 2.0)
    assert out.shape == (4, 32, 2) and not out.any()
    assert tband.RESCUE_LAUNCHES == n0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _assert_close_to(got, want):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("switch", ["poly4", "exp4"])
@pytest.mark.parametrize("form", ["base", "hot", "cross"])
@pytest.mark.parametrize("S,k,n,cap", [
    (32, 4, 1000, 1001), (128, 8, 20_000, 20_480 + 77), (1, 3, 300, 300),
    (3, 5, 500, 512), (1024, 4, 30_000, 30_001), (100, 12, 9000, 12_345)])
def test_rescue_kernel_matches_plain_on_card(cuda_device, form, switch, S,
                                             k, n, cap):
    """Every call form at widths 1 to 1024, ragged capacities, k above and
    below the plan's lanes; one launch a call."""
    spos, smass, salive = _scene(n, cap, device=cuda_device)
    a = 12.0
    forms, _ = _forms(spos, smass, salive, S, k, a)
    args = forms[form]
    n0 = tband.RESCUE_LAUNCHES
    got = tband.rescue_pair_sum(*args, SOFT2, a, switch)
    want = tband.rescue_pair_sum_ref(*args, SOFT2, a, switch, chunk=64)
    torch.cuda.synchronize()
    assert tband.RESCUE_LAUNCHES == n0 + 1
    _assert_close_to(got, want)


@pytest.mark.cuda
def test_rescue_kernel_all_invalid_and_empty_on_card(cuda_device):
    """No valid partner gives exact zeros (one launch); k = 0 and m = 0
    give zeros without a launch."""
    spos, smass, salive = _scene(3000, 4096, device=cuda_device)
    forms, _ = _forms(spos, smass, salive, 128, 8, 12.0)
    trows, tid, prows, pidx, pvalid = forms["base"]
    n0 = tband.RESCUE_LAUNCHES
    got = tband.rescue_pair_sum(trows, tid, prows, pidx,
                                torch.zeros_like(pvalid), SOFT2, 12.0,
                                "poly4")
    torch.cuda.synchronize()
    assert tband.RESCUE_LAUNCHES == n0 + 1
    assert got.shape == (tid.shape[0], 128, 2) and not got.any()
    for sl in (pidx[:, :0], pidx[:0]):
        out = tband.rescue_pair_sum(trows, tid[:sl.shape[0]], prows, sl,
                                    pvalid[:sl.shape[0], :sl.shape[1]],
                                    SOFT2, 12.0, "poly4")
        assert not out.any()
    assert tband.RESCUE_LAUNCHES == n0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("T,PL", [(1, 1), (2, 3), (4, 8), (8, 2), (8, 8)])
def test_rescue_kernel_plans_on_card(cuda_device, T, PL):
    """Every launch shape computes the same sum."""
    spos, smass, salive = _scene(10_000, 10_077, device=cuda_device)
    forms, _ = _forms(spos, smass, salive, 128, 8, 12.0)
    args = forms["base"]
    plan = tband._rescue_plan(128, 8, T=T)._replace(PL=PL)
    got = tband._rescue_launch(*args, SOFT2, 12.0, "poly4", plan)
    want = tband.rescue_pair_sum_ref(*args, SOFT2, 12.0, "poly4", chunk=64)
    torch.cuda.synchronize()
    _assert_close_to(got, want)


@pytest.mark.cuda
def test_block_rescue_on_card_matches_cpu(cuda_device):
    """Both tiers end to end on the card against the same call on the CPU
    (plain version), needs equal."""
    spos, smass, salive = _scene(20_000, 20_480)
    kw = dict(band=128, k=4, chunk=4096, k_hot=12, hot_cap=16,
              switch="poly4")
    want, need, hot = tmesh._block_rescue(spos, smass, salive, SOFT2, 12.0,
                                          **kw)
    n0 = tband.RESCUE_LAUNCHES
    got, need_c, hot_c = tmesh._block_rescue(
        spos.to(cuda_device), smass.to(cuda_device), salive.to(cuda_device),
        SOFT2, 12.0, **kw)
    torch.cuda.synchronize()
    assert tband.RESCUE_LAUNCHES == n0 + 2
    assert (int(need_c), int(hot_c)) == (int(need), int(hot))
    _assert_close_to(got.cpu(), want)
