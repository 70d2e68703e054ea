"""The port's collective layer against jax.lax's collectives under
jax.shard_map on the 8-device CPU mesh, the same arrays on both sides; a
DistGroup on gloo in two processes; faults that must raise, not hang; the
sharded state helpers."""

import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from tpu_nbody.parallel import mesh as jmesh
from tpu_nbody_torch import convert
from tpu_nbody_torch.parallel import mesh as tmesh
from tpu_nbody_torch.parallel.collectives import (RankAborted, ThreadGroup,
                                                  run_spmd)
from tpu_nbody_torch.state import SimState

torch.set_num_threads(1)

SIZES = [1, 2, 4, 8]


def _ring(P):
    return [(i, (i + 1) % P) for i in range(P)]


def _odd_even(P):
    """Round 1 of the device reshard: pairs (1,2), (3,4)..., ends to
    themselves."""
    out = []
    for i in range(P):
        p = i + 1 if (i + 1) % 2 == 0 else i - 1
        out.append((i, p if 0 <= p < P else i))
    return out


# name -> (jax body, port body (group, x) -> tensor, per-rank block shape,
# dtype); P is bound by the caller
OPS = {
    "ppermute_ring": (
        lambda P: lambda x: jax.lax.ppermute(x, "b", _ring(P)),
        lambda P: lambda g, x: g.ppermute(x, _ring(P)), (3, 2), np.float32),
    "ppermute_odd_even": (
        lambda P: lambda x: jax.lax.ppermute(x, "b", _odd_even(P)),
        lambda P: lambda g, x: g.ppermute(x, _odd_even(P)), (5, 6),
        np.float32),
    "ppermute_partial": (   # a rank nobody sends to receives zeros
        lambda P: lambda x: jax.lax.ppermute(x, "b", [(0, P - 1)]),
        lambda P: lambda g, x: g.ppermute(x, [(0, P - 1)]), (4,), np.int32),
    "all_gather": (
        lambda P: lambda x: jax.lax.all_gather(x, "b"),
        lambda P: lambda g, x: g.all_gather(x), (3, 2), np.float32),
    "all_gather_tiled": (
        lambda P: lambda x: jax.lax.all_gather(x, "b", tiled=True),
        lambda P: lambda g, x: g.all_gather(x, tiled=True), (3, 2),
        np.float32),
    "all_gather_bool": (
        lambda P: lambda x: jax.lax.all_gather(x, "b"),
        lambda P: lambda g, x: g.all_gather(x), (7,), np.bool_),
    "psum": (
        lambda P: lambda x: jax.lax.psum(x, "b"),
        lambda P: lambda g, x: g.psum(x), (4, 3), np.float32),
    "pmax": (
        lambda P: lambda x: jax.lax.pmax(x, "b"),
        lambda P: lambda g, x: g.pmax(x), (6,), np.int32),
    "psum_scatter_dim0": (
        lambda P: lambda x: jax.lax.psum_scatter(x, "b", scatter_dimension=0,
                                                 tiled=True),
        lambda P: lambda g, x: g.psum_scatter(x, scatter_dimension=0),
        (16, 5), np.float32),
    "psum_scatter_dim1": (
        lambda P: lambda x: jax.lax.psum_scatter(x, "b", scatter_dimension=1,
                                                 tiled=True),
        lambda P: lambda g, x: g.psum_scatter(x, scatter_dimension=1),
        (3, 16), np.float32),
    "all_to_all_1_0": (
        lambda P: lambda x: jax.lax.all_to_all(x, "b", 1, 0, tiled=True),
        lambda P: lambda g, x: g.all_to_all(x, split_axis=1, concat_axis=0),
        (3, 8), np.complex64),
    "all_to_all_0_1": (
        lambda P: lambda x: jax.lax.all_to_all(x, "b", 0, 1, tiled=True),
        lambda P: lambda g, x: g.all_to_all(x, split_axis=0, concat_axis=1),
        (8, 3), np.float32),
    "all_to_all_0_0": (     # the BH export exchange: (P, E, 3)
        lambda P: lambda x: jax.lax.all_to_all(x, "b", 0, 0, tiled=True),
        lambda P: lambda g, x: g.all_to_all(x, split_axis=0, concat_axis=0),
        (8, 5, 3), np.float32),
}


def _blocks(P, shape, dtype, seed):
    rng = np.random.default_rng(seed)
    full = rng.standard_normal((P * shape[0], *shape[1:]))
    if dtype == np.complex64:
        full = full + 1j * rng.standard_normal(full.shape)
    elif dtype == np.int32:
        full = np.round(full * 100)
    elif dtype == np.bool_:
        full = full > 0
    return full.astype(dtype)


@pytest.mark.parametrize("P", SIZES)
@pytest.mark.parametrize("name", list(OPS))
def test_collective_matches_jax(name, P):
    """Moves bitwise; sums within rtol 1e-6."""
    jax_body, port_body, shape, dtype = OPS[name]
    full = _blocks(P, shape, dtype, seed=len(name) * 10 + P)
    f = jax.shard_map(jax_body(P), mesh=jmesh.make_mesh(P),
                      in_specs=PS("b"), out_specs=PS("b"), check_vma=False)
    want = np.asarray(jax.jit(f)(full))
    g = ThreadGroup(P, "cpu", timeout=60)
    body = port_body(P)
    blocks = list(torch.from_numpy(full).chunk(P))
    got = torch.cat(run_spmd(g, lambda x: body(g, x), blocks)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if name == "psum":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_collectives_refuse_bad_arguments():
    g = ThreadGroup(4, "cpu", timeout=30)
    x = [torch.zeros(6, 2) for _ in range(4)]
    for bad in (lambda x: g.ppermute(x, [(0, 1), (2, 1)]),
                lambda x: g.psum_scatter(x),               # 6 rows over 4
                lambda x: g.all_to_all(x, 0, 0, tiled=False)):
        with pytest.raises(ValueError):
            run_spmd(g, bad, x)
    with pytest.raises(RuntimeError, match="outside run_spmd"):
        g.psum(x[0])


def test_raising_rank_fails_the_run_within_its_timeout():
    """Rank 2 raises before the exchange the others wait in: run_spmd
    raises rank 2's error at once, not after the timeout; the group works
    again afterwards."""
    g = ThreadGroup(4, "cpu", timeout=30)

    def body(x):
        if g.rank == 2:
            raise ValueError("rank 2 fails")
        return g.psum(x)

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="rank 2 fails"):
        run_spmd(g, body, [torch.ones(3)] * 4)
    assert time.perf_counter() - t0 < 10
    out = run_spmd(g, g.psum, [torch.ones(3)] * 4)
    assert all(torch.equal(o, torch.full((3,), 4.0)) for o in out)


def test_missing_rank_times_out():
    """Rank 0 returns without the exchange: the others see its slot
    unfilled when the baton comes round, and run_spmd raises."""
    g = ThreadGroup(3, "cpu", timeout=1.0)

    def body(x):
        return x if g.rank == 0 else g.psum(x)

    t0 = time.perf_counter()
    with pytest.raises(RankAborted):
        run_spmd(g, body, [torch.ones(2)] * 3)
    assert time.perf_counter() - t0 < 15


def test_ranks_calling_different_collectives_raise():
    g = ThreadGroup(2, "cpu", timeout=30)
    with pytest.raises(RuntimeError, match="different collectives"):
        run_spmd(g, lambda x: g.psum(x) if g.rank == 0 else g.pmax(x),
                 [torch.ones(2)] * 2)


def test_thread_group_stress():
    """More ranks than cores and a short switch interval: 200 exchanges in
    a row, each rank's result checked (a lost or torn slot would show)."""
    P = 16
    g = ThreadGroup(P, "cpu", timeout=60)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def body(x):
            for i in range(200):
                s = g.psum(x + i)
                assert float(s[0]) == P * i + P * (P - 1) / 2
                r = g.ppermute(x + i, _ring(P))
                assert float(r[0]) == (g.rank - 1) % P + i
            return s
        out = run_spmd(g, body, [torch.full((4,), float(r))
                                 for r in range(P)])
    finally:
        sys.setswitchinterval(old)
    assert len(out) == P


_DIST_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np, torch
    import torch.distributed as dist
    from tpu_nbody_torch.parallel.mesh import make_mesh
    g = make_mesh(device="cpu", backend="dist", timeout=60,
                  init_method=sys.argv[1])
    P, r = g.size, g.rank
    rng = np.random.default_rng(0)
    full = torch.from_numpy(rng.standard_normal((P * 8, 6)).astype("f4"))
    x = full.chunk(P)[r]
    blocks = full.chunk(P)
    def check(name, got, want):
        if got.shape != want.shape or not torch.allclose(got, want,
                                                          rtol=1e-6):
            raise SystemExit(f"{name}: {got} != {want}")
    check("ppermute", g.ppermute(x, [(i, (i + 1) % P) for i in range(P)]),
          blocks[(r - 1) % P])
    check("ppermute_self", g.ppermute(x, [(0, 0), (1, 1)]), x)
    check("all_gather", g.all_gather(x), torch.stack(blocks))
    check("all_gather_tiled", g.all_gather(x, tiled=True), full)
    check("psum", g.psum(x), sum(blocks))
    check("pmax", g.pmax(x), torch.stack(blocks).amax(0))
    check("psum_scatter", g.psum_scatter(x, scatter_dimension=1),
          sum(blocks).chunk(P, dim=1)[r])
    check("all_to_all", g.all_to_all(x, split_axis=1, concat_axis=0),
          torch.cat([b.chunk(P, dim=1)[r] for b in blocks]))
    cx = torch.complex(x, -x)
    want = torch.cat([torch.complex(b, -b).chunk(P, dim=0)[r]
                      for b in blocks], dim=1)
    got = g.all_to_all(cx, split_axis=0, concat_axis=1)
    if not torch.equal(got, want):
        raise SystemExit("complex all_to_all")
    flags = g.all_gather(torch.tensor([r == 0, True]))
    if flags.dtype != torch.bool or flags.tolist() != [[True, True],
                                                       [False, True]]:
        raise SystemExit(f"bool all_gather {flags}")
    g.close()                       # a barrier, then destroy
    if dist.is_initialized():
        raise SystemExit("close left the process group alive")
    g.close()                       # a second call does nothing
    print("rank", r, "ok", flush=True)
""")


def test_dist_group_on_gloo_two_processes(tmp_path):
    """The same ops on torch.distributed (gloo), world size 2, each process
    checking its own results and then leaving the group in order with
    ``DistGroup.close`` (a barrier, then destroy: a process that exited
    with the group alive while the other rank still used it could abort
    in the backend's teardown), twice, the second call doing nothing. The ranks meet through a file in ``tmp_path``: no TCP port
    to pick and lose to another process between picking and binding it."""
    script = tmp_path / "rank.py"
    script.write_text(_DIST_SCRIPT)
    init_method = f"file://{tmp_path / 'rendezvous'}"
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(Path(__file__).resolve().parents[1]))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), init_method], env=env,
            cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    report = "\n".join(f"--- rank {r} (exit code {p.returncode}):\n{out}"
                       for r, (p, out) in enumerate(zip(procs, outs)))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, report
        assert f"rank {rank} ok" in out, report


def test_make_mesh_and_sharded_states(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_mesh(4)
    with pytest.raises(ValueError, match="backend"):
        tmesh.make_mesh(2, device="cpu", backend="mpi")
    g = tmesh.make_mesh(4, device="cpu")
    assert g.size == 4 and g.local_ranks == [0, 1, 2, 3]
    assert tmesh.make_mesh(device="cpu").size == 1

    rng = np.random.default_rng(3)
    arrays = [rng.random((64, 2)).astype(np.float32),
              rng.random((64, 2)).astype(np.float32),
              rng.random(64).astype(np.float32), rng.random(64) > 0.3,
              np.int32(5)]
    local = convert.sharded_state_from_numpy(arrays, g)
    assert len(local) == 4 and all(s.capacity == 16 for s in local)
    np.testing.assert_array_equal(local[2].pos.numpy(), arrays[0][32:48])
    back = tmesh.gather_state(local, g)
    assert isinstance(back, SimState) and int(back.step) == 5
    for a, b in zip(back[:4], arrays[:4]):
        np.testing.assert_array_equal(a.numpy(), b)
    with pytest.raises(ValueError, match="split"):
        tmesh.shard_state(back, tmesh.make_mesh(3, device="cpu"))
