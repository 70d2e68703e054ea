"""The port's entry(), dryrun_multichip and merger10m: entry()'s step
against the JAX package's entry() on the same bodies, dryrun_multichip on
8 ranks, and the merger example on 4 ranks with its GIF."""

import jax
import numpy as np
import torch

import __graft_entry__ as jentry
from tpu_nbody_torch import config as tconfig
from tpu_nbody_torch import convert, graft_entry
from tpu_nbody_torch.examples import merger10m

torch.set_num_threads(2)


def test_entry_step_matches_jax():
    """One Barnes–Hut kdk step + merge of the 12,500-body scene at capacity
    16,384, from the JAX entry's state: alive flags equal, masses within
    1e-6, positions within 1e-3 px."""
    jfn, (jst, jparams) = jentry.entry()
    want = jax.jit(jfn)(jst, jparams)
    fn, (st, params) = graft_entry.entry(device="cpu")
    assert st.capacity == jst.capacity == 16384
    assert int(st.n_alive()) == int(jst.n_alive()) == 12_500
    assert params == tconfig.Params.default()
    got = fn(convert.state_from_numpy(*[np.asarray(x) for x in jst],
                                      device="cpu"), params)
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    np.testing.assert_allclose(got.mass.numpy(), np.asarray(want.mass),
                               rtol=1e-6)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               rtol=0, atol=1e-3)
    assert int(got.step) == 1


def test_dryrun_multichip_on_8_ranks():
    graft_entry.dryrun_multichip(8, device="cpu")


def test_merger10m_on_4_ranks(tmp_path):
    out = tmp_path / "merger.gif"
    r = merger10m.main(["--devices", "4", "--n", "20000", "--steps", "4",
                        "--device", "cpu", "--frames", "2", "--out",
                        str(out)])
    alive = [n for _, n, _ in r["lines"]]
    assert [s for s, _, _ in r["lines"]] == [2, 4]
    assert alive == sorted(alive, reverse=True) and alive[0] <= 20_000
    st = r["engine"].state
    assert int(st.step) == 4 and r["engine"].mesh.size == 4
    assert torch.isfinite(st.pos).all() and torch.isfinite(st.vel).all()
    raw = out.read_bytes()
    assert raw[:6] == b"GIF89a" and raw.count(b"\x2c\x00\x00\x00\x00") >= 2
