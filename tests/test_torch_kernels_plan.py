"""The port's launch plans and work counts, which run here on the CPU:
`band._band_plan` and `forces._split_plan` cover every body and source
exactly once within the card's limits, `pair_work` gives the hand counts,
and the entry points default to the card and raise without one."""

import numpy as np
import pytest
import torch

from tpu_nbody_torch import checkpoint as tcheckpoint
from tpu_nbody_torch import config as tconfig
from tpu_nbody_torch import convert
from tpu_nbody_torch import engine as tengine
from tpu_nbody_torch import state as tstate
from tpu_nbody_torch.ops import band as tband
from tpu_nbody_torch.ops import forces as tforces

CFG = dict(capacity=1024, mesh_level=9, mesh_band=32, mesh_chunk=1024)


def _state_arrays(n=16):
    rng = np.random.default_rng(0)
    pos = rng.random((n, 2)).astype(np.float32)
    return pos, np.zeros_like(pos), np.ones(n, np.float32), \
        np.ones(n, bool), 0


@pytest.mark.parametrize("entry", ["engine", "convert", "checkpoint",
                                   "from_arrays"])
def test_entry_points_default_to_the_card(monkeypatch, tmp_path, entry):
    """Called without ``device``, each entry point asks for CUDA and raises
    on a machine without it, instead of running on the CPU."""
    path = tmp_path / "ck.npz"
    st = convert.state_from_numpy(*_state_arrays(), device="cpu")
    tcheckpoint.save(path, st, tconfig.Params.default())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "engine":
            tengine.Engine(tconfig.SimConfig(**CFG))
        elif entry == "convert":
            convert.state_from_numpy(*_state_arrays())
        elif entry == "checkpoint":
            tcheckpoint.load(path)
        else:
            tstate.from_arrays(*_state_arrays()[:3])


def test_from_arrays_on_the_cpu_when_asked():
    pos, vel, mass, _, _ = _state_arrays()
    st = tstate.from_arrays(pos, vel, mass, capacity=32, device="cpu")
    assert st.pos.device.type == "cpu" and st.capacity == 32
    assert int(st.n_alive()) == 16
    np.testing.assert_array_equal(st.pos[:16].numpy(), pos)


def test_empty_state_needs_a_device():
    with pytest.raises(TypeError):
        tstate.empty_state(8)
    assert tstate.empty_state(8, device="cpu").pos.device.type == "cpu"


def _band_cover(plan, S, cap):
    """How often the kernel's mapping (CTA c, S-block s, lane l, target k
    -> body (c B + s) S + l + k tps, kept when l + k tps < S and the body
    is below cap) writes each body of [0, cap)."""
    c, s, l, k = np.meshgrid(np.arange(plan.grid), np.arange(plan.B),
                             np.arange(plan.tps), np.arange(plan.T),
                             indexing="ij")
    li = l + k * plan.tps
    body = (c * plan.B + s) * S + li
    kept = body[(li < S) & (body < cap)]
    return np.bincount(kept, minlength=cap)


@pytest.mark.parametrize("S", [1, 32, 64, 100, 128, 256, 1024])
@pytest.mark.parametrize("cap_of", ["small", "ragged", "pow2"])
def test_band_plan_covers_every_body_once(S, cap_of):
    cap = {"small": max(1, S // 2 + 1), "ragged": 7 * S + 13,
           "pow2": 1 << 15}[cap_of]
    for T, B in ((4, None), (1, None), (2, 2), (8, 8)):
        plan = tband._band_plan(cap, S, T=T, B=B)
        assert plan.T <= S and plan.T in (1, 2, 4, 8)
        assert plan.tps == -(-S // plan.T)
        assert plan.threads == plan.B * plan.tps <= 1024
        assert plan.smem == (plan.B + 2) * S * 16 <= 48 * 1024
        assert plan.grid == -(-(-(-cap // S)) // plan.B)
        np.testing.assert_array_equal(_band_cover(plan, S, cap), 1)


def test_band_plan_main_path_shape():
    """S = 128 at capacity 2^20: eight S-blocks of 16 threads, eight
    targets a thread, 20 KB of partners."""
    plan = tband._band_plan(1 << 20, 128)
    assert (plan.T, plan.B, plan.threads, plan.smem, plan.grid) == \
        (8, 8, 128, 20480, 1024)


def _split_range(p, splits, ns):
    """Sources [lo, hi) of split ``p``, cut as the kernel cuts them."""
    tiles = -(-ns // tforces.TILE)
    return (p * tiles // splits * tforces.TILE,
            min(ns, (p + 1) * tiles // splits * tforces.TILE))


@pytest.mark.parametrize("nt,ns", [(4096, 1 << 20), (8192, 8192), (1, 1),
                                   (777, 100), (5000, 5000), (3, 0),
                                   (1 << 20, 1 << 20)])
@pytest.mark.parametrize("per_sm", [1, 5, 16])
def test_split_plan_covers_sources_once(nt, ns, per_sm):
    plan = tforces._split_plan(nt, ns, 132, per_sm)
    assert 1 <= plan.splits <= 65535
    assert plan.blocks * tforces.THREADS * tforces.T >= nt
    cover = np.zeros(ns, int)
    sizes = []
    for p in range(plan.splits):
        lo, hi = _split_range(p, plan.splits, ns)
        assert lo % tforces.TILE == 0
        assert lo < hi or ns == 0       # no empty split
        cover[lo:hi] += 1
        sizes.append(-(-(hi - lo) // tforces.TILE))
    np.testing.assert_array_equal(cover, 1)
    assert max(sizes) - min(sizes) <= 1          # tiles of each split


def test_split_plan_fills_the_card():
    """4096 targets over 2^20 sources on 132 SMs holding 5 blocks each (the
    occupancy of the 2D kernel on an H100): one full wave, at least 4
    blocks an SM (one block row would give 4 blocks for 132 SMs)."""
    plan = tforces._split_plan(4096, 1 << 20, 132, 5)
    assert plan.blocks == 4
    assert plan.blocks * plan.splits == 5 * 132


def _band_pairs_brute(cap, S):
    blk = np.arange(cap) // S
    return int(sum(np.sum(np.abs(blk - blk[i]) <= 1) for i in range(cap)))


def test_pair_work_counts():
    w = tband.pair_work(1 << 20, 128, "poly4")
    # 2^20 x 3S = 4.03e8, less the missing neighbour of both end blocks
    assert w["pairs"] == (1 << 20) * 3 * 128 - 2 * 128 * 128
    assert w["flops"] == 21 * w["pairs"]
    assert w["bytes"] == 20 * (1 << 20)
    assert tband.pair_work(1 << 20, 128, "exp4")["flops"] == 18 * w["pairs"]
    for cap, S in ((1000, 128), (100, 128), (257, 1), (1024, 256)):
        assert tband.pair_work(cap, S)["pairs"] == _band_pairs_brute(cap, S)
    w = tforces.pair_work(4096, 1 << 20, 2)
    assert w["pairs"] == 4096 * (1 << 20)                  # 4.29e9
    assert w["flops"] == 13 * w["pairs"]
    assert w["bytes"] == pytest.approx(12.6e6, rel=1e-2)
    assert tforces.pair_work(8192, 8192, 3)["flops"] == 18 * 8192 * 8192
