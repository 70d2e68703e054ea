"""The merge rule of the port (``merge.merge_bodies``, kernel
``csrc/merge.cu``) against the JAX package's ``tpu_nbody/ops/merge.py::
merge_bodies`` on the same numpy scenes.

On the CPU the wrapper runs its plain version, ``merge._merge_bodies_ref``;
a model of the one-launch kernel's steps written here in numpy (the heavies
collected by a grid of CTAs, each in an arbitrary order, the radix select
of the H heaviest at the cap in CTA 0, the round-2 mask from the table
alone, one pass a body over the still-absorbing heavies, the first of them
staged and the rest read apart, the gains summed in an arbitrary order by
the last CTA) is held to JAX on the same scenes. Absorbers (alive flags)
and ``heavy_need`` must match exactly, masses within rtol 1e-6 (the kernel
sums the gains with atomics). The scenes: a chain of three overlapping
heavies, ties in mass at the cap, more heavies than the cap, dead bodies
inside the radius, ``merge_min_dist = 0``, a single alive body, and 3D.

On the card (marker ``cuda``, skipped without one): the kernel against the
plain version on the same scenes, on an overflowing scene with many
heavies, on a 1-body state and with no heavy at all, one device operation
a call (a profiler trace), four calls at once on four streams, and the
sharded halves (``heavy_table``, ``absorb``) against theirs. The JAX
package is imported inside the tests that use it, so the ``cuda`` tests
also collect where jax is missing.
"""

import numpy as np
import pytest
import torch

from tpu_nbody_torch import config as tconfig
from tpu_nbody_torch.kernels import _build
from tpu_nbody_torch.ops import merge as tmerge
from tpu_nbody_torch.state import SimState

torch.set_num_threads(2)

SCENES = ["chain3", "ties_at_cap", "overflow", "dead_in_radius",
          "min_dist_0", "single_alive", "3d"]
MAX_MASS = 4000.0


def _satellites(rng, pos, mass, at, idx, spread=3.0):
    """Light bodies ``idx`` within ``spread`` of ``at`` (inside the radius
    8), in place."""
    dim = pos.shape[1]
    pos[idx] = at + rng.uniform(-spread, spread, (len(idx), dim)) / np.sqrt(
        dim)
    mass[idx] = rng.uniform(0.5, 2.0, len(idx))


def _scene(name):
    """(pos, mass, alive, min_dist, heavy_cap) of a named scene, float32
    numpy from a seed: light bodies in a 1000 px box, heavies with
    satellites placed by hand."""
    rng = np.random.default_rng(SCENES.index(name) + 100)
    dim = 3 if name == "3d" else 2
    cap = {"overflow": 1024, "single_alive": 64}.get(name, 512)
    pos = rng.uniform(0.0, 1000.0, (cap, dim))
    mass = rng.uniform(0.5, 2.0, cap)
    alive = np.ones(cap, bool)
    min_dist, hcap = 8.0, 16

    def heavy(i, m, at, sats):
        pos[i] = at
        mass[i] = m
        _satellites(rng, pos, mass, np.asarray(at, float), sats)

    if name in ("chain3", "min_dist_0", "3d"):
        z = [0.0] if dim == 3 else []
        # 20 - 5 - 300 in a line, 6 px apart: 5 absorbs both ends
        heavy(20, 5000.0, [100.0, 100.0, *z], [21, 22, 23])
        heavy(5, 6000.0, [106.0, 100.0, *z], [24, 25])
        heavy(300, 7000.0, [112.0, 100.0, *z], [26, 27, 28])
        # 50 - 60 - 70: 60 falls to 50, 70 (near 60 only) stops absorbing
        heavy(50, 5000.0, [300.0, 300.0, *z], [51, 52])
        heavy(60, 5000.0, [306.0, 300.0, *z], [61, 62])
        heavy(70, 5000.0, [312.0, 300.0, *z], [71, 72, 73])
        heavy(400, 9000.0, [600.0, 600.0, *z], list(range(401, 409)))
        if name == "min_dist_0":
            min_dist = 0.0
    elif name == "ties_at_cap":
        # 4 of 6000 and 8 of 5000, 6 slots: the two lowest-index 5000s
        hs = [7, 40, 90, 150, 200, 260, 310, 350, 390, 430, 470, 500]
        for j, i in enumerate(hs):
            heavy(i, 6000.0 if j % 3 == 0 else 5000.0,
                  [50.0 + 70.0 * j, 500.0], [i + 1, i + 2, i + 3])
        hcap = 6
    elif name == "overflow":
        hs = rng.choice(np.arange(0, cap, 8), 40, replace=False)
        ms = rng.permutation(np.linspace(4001.0, 9000.0, 40))
        for j, (i, m) in enumerate(zip(hs, ms)):
            heavy(i, m, [20.0 + 24.0 * j, 300.0 + (j % 2) * 5.0],
                  [i + 1, i + 2])
    elif name == "dead_in_radius":
        heavy(10, 5000.0, [200.0, 200.0], list(range(11, 19)))
        alive[[12, 15, 17]] = False
        heavy(30, 8000.0, [204.0, 200.0], [31])   # a dead heavy nearby
        alive[30] = False
        heavy(40, 6000.0, [500.0, 500.0], list(range(41, 45)))
    elif name == "single_alive":
        heavy(3, 5000.0, [100.0, 100.0], list(range(4, 12)))
        alive[:] = False
        alive[3] = True
    return (pos.astype(np.float32), mass.astype(np.float32), alive,
            min_dist, hcap)


def _jax_merge(pos, mass, alive, min_dist, hcap):
    import jax.numpy as jnp

    from tpu_nbody import config as jconfig
    from tpu_nbody import state as jstate
    from tpu_nbody.ops import merge as jmerge
    st = jstate.SimState(jnp.asarray(pos), jnp.zeros_like(jnp.asarray(pos)),
                         jnp.asarray(mass), jnp.asarray(alive), jnp.int32(0))
    p = jconfig.Params.default(merge_max_mass=MAX_MASS,
                               merge_min_dist=min_dist)
    out, need = jmerge.merge_bodies(st, p, heavy_cap=hcap)
    return np.asarray(out.mass), np.asarray(out.alive), int(need)


def _state(pos, mass, alive, device="cpu"):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return SimState(pos=t(pos), vel=torch.zeros_like(t(pos)), mass=t(mass),
                    alive=t(alive), step=torch.zeros((), dtype=torch.int32,
                                                     device=device))


def _params(min_dist):
    return tconfig.Params.default(merge_max_mass=MAX_MASS,
                                  merge_min_dist=min_dist)


def _check(got, want, alive0):
    mass, alive, need = got
    wmass, walive, wneed = want
    assert need == wneed
    np.testing.assert_array_equal(alive, walive)
    np.testing.assert_allclose(mass, wmass, rtol=1e-6)
    return int(alive0.sum()) - int(walive.sum())      # bodies absorbed


# -- the kernel's algorithm, modelled in numpy --------------------------------

def _key(m, i):
    """csrc/merge.cu's mass_key: the float's bits ordered like its value,
    then the complement of the index."""
    b = int(np.float32(m).view(np.uint32))
    b = (~b & 0xFFFFFFFF) if b & 0x80000000 else b | 0x80000000
    return (b << 32) | (0xFFFFFFFF - int(i))


def _r2(a, b):
    """Each difference, square and sum rounded to float32 alone, in index
    order."""
    d = np.float32(a[0]) - np.float32(b[0])
    r2 = np.float32(d * d)
    for k in range(1, len(a)):
        d = np.float32(a[k]) - np.float32(b[k])
        r2 = np.float32(r2 + np.float32(d * d))
    return r2


def _kernel_model(pos, mass, alive, max_mass, md2, H, rng, ctas=3,
                  stage=256):
    """The one-launch kernel's steps on a grid of ``ctas`` CTAs, CTA c
    owning the bodies [c chunk, (c + 1) chunk); the orders the atomics
    leave free (each CTA's order of its heavies, the table after the
    select, the compacted absorbers, the gain sums) come from ``rng``. The
    pass tests the first ``stage`` absorbers from shared memory and the
    rest apart."""
    n = pos.shape[0]
    md2 = np.float32(md2)
    # 1. collect: each CTA its chunk's heavies, in any order
    chunk = -(-n // ctas)
    per_cta = [[] for _ in range(ctas)]
    for i in range(n):
        if alive[i] and mass[i] > np.float32(max_mass):
            per_cta[i // chunk].append(i)
    # 2. CTA 0 compacts them in CTA order ...
    heavies = [int(i) for c in range(ctas)
               for i in rng.permutation(per_cta[c])]
    need, n_alive = len(heavies), int(alive.sum())
    # ... and picks: the list, or the H largest keys by a radix select
    if need <= H:
        table = heavies
    else:
        keys = [_key(mass[i], i) for i in heavies]
        kth = 0
        for b in range(63, -1, -1):
            if sum(k >= (kth | 1 << b) for k in keys) >= H:
                kth |= 1 << b
        table = [int(i) for i in
                 rng.permutation([i for i, k in zip(heavies, keys)
                                  if k >= kth])]
        assert len(table) == H
    # ... then round 2 from the table alone, compacted in any order
    still = []
    if n_alive >= 2:
        for s in table:
            if not any(t < s and _r2(pos[s], pos[t]) < md2 for t in table):
                still.append(s)
    still = [int(g) for g in rng.permutation(still)]
    # 3. pass: the lowest-id still absorber that hits, other than the body,
    # over the staged absorbers and then the rest
    mass_out, alive_out = mass.copy(), alive.copy()
    victims = {}
    for i in range(n):
        if not alive[i]:
            continue
        best = None
        for part in (still[:stage], still[stage:]):
            for g in part:
                if (best is None or g < best) and g != i \
                        and _r2(pos[i], pos[g]) < md2:
                    best = g
        if best is not None:
            victims.setdefault(best, []).append(i)
            mass_out[i], alive_out[i] = 0.0, False
    # the last CTA: gains summed in any order
    for g, vs in victims.items():
        gained = np.float32(0.0)
        for v in rng.permutation(vs):
            gained = np.float32(gained + mass[v])
        mass_out[g] = np.float32(mass[g] + gained)
    return mass_out, alive_out, need if n_alive >= 2 else 0


@pytest.mark.parametrize("name", SCENES)
def test_merge_matches_jax(name):
    """The port's wrapper (plain on the CPU) against JAX."""
    pos, mass, alive, md, hcap = _scene(name)
    want = _jax_merge(pos, mass, alive, md, hcap)
    out, need = tmerge.merge_bodies(_state(pos, mass, alive), _params(md),
                                    heavy_cap=hcap)
    absorbed = _check((out.mass.numpy(), out.alive.numpy(), int(need)),
                      want, alive)
    if name in ("min_dist_0", "single_alive"):
        assert absorbed == 0
    else:
        assert absorbed > 0


@pytest.mark.parametrize("name", SCENES)
def test_kernel_model_matches_jax(name):
    """The kernel's steps, in numpy, on a grid of three CTAs, against JAX
    (two arbitrary orders of the atomics)."""
    pos, mass, alive, md, hcap = _scene(name)
    want = _jax_merge(pos, mass, alive, md, hcap)
    for seed in (0, 1):
        if md <= 0:      # the wrapper launches nothing
            break
        got = _kernel_model(pos, mass, alive, MAX_MASS, np.float32(md * md),
                            min(hcap, len(mass)),
                            np.random.default_rng(seed))
        _check(got, want, alive)


@pytest.mark.parametrize("name", ["chain3", "ties_at_cap", "overflow",
                                  "dead_in_radius", "3d"])
@pytest.mark.parametrize("ctas,stage", [(1, 256), (7, 256), (2, 1)])
def test_kernel_model_grid_matches_jax(name, ctas, stage):
    """The same on one CTA, on seven (each CTA's order of its heavies
    shuffled), and with one absorber staged, the rest read apart."""
    pos, mass, alive, md, hcap = _scene(name)
    want = _jax_merge(pos, mass, alive, md, hcap)
    got = _kernel_model(pos, mass, alive, MAX_MASS, np.float32(md * md),
                        min(hcap, len(mass)), np.random.default_rng(ctas),
                        ctas=ctas, stage=stage)
    _check(got, want, alive)


def test_chain_resolution():
    """The chains resolve as the JAX rule resolves them: 5 absorbs 20 and
    300; 50 absorbs 60, and 70 (near 60 only) neither absorbs nor dies."""
    pos, mass, alive, md, hcap = _scene("chain3")
    out, need = tmerge.merge_bodies(_state(pos, mass, alive), _params(md),
                                    heavy_cap=hcap)
    a = out.alive.numpy()
    assert int(need) == 7
    assert a[5] and not a[20] and not a[300]
    assert a[50] and not a[60] and a[70]
    assert a[[71, 72, 73]].all()          # 70's satellites survive
    assert not a[[51, 52]].any()          # 50's own fall to it


def test_scratch_bytes_match_the_carve():
    """The wrapper's scratch size: each part of csrc/merge.cu's carve
    rounded up to 16 bytes, with and without the one-launch merge's
    counts a CTA and compacted list."""
    assert tmerge._scratch_bytes(0, 0, 2) == 16
    assert tmerge._scratch_bytes(1, 1, 2) == 16 * 9
    n, H = 1 << 20, 64
    assert tmerge._scratch_bytes(n, H, 2) == (16 + 256 + 4 * n + 512 + 256
                                              + 64 + 512 + 256 + 256)
    # the one-launch merge: two counts a CTA and the compacted list
    assert tmerge._scratch_bytes(n, H, 2, 264) == (
        tmerge._scratch_bytes(n, H, 2) + 8 * 264 + 4 * n)
    assert tmerge._scratch_bytes(1, 1, 3, 1) == 16 * 11
    w = tmerge.merge_work(1000, 5, 64)
    assert w["tests"] == 5000 and w["flops"] == 30000
    assert tmerge.merge_work(1000, 100, 64, dim=3)["flops"] == 9 * 64000


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kernel_vs_plain(pos, mass, alive, md, hcap, dev):
    st = _state(pos, mass, alive, dev)
    before = _build.LAUNCHES["merge"]
    got, need = tmerge.merge_bodies(st, _params(md), heavy_cap=hcap)
    want, wneed = tmerge._merge_bodies_ref(st, _params(md), heavy_cap=hcap)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["merge"] == before + (1 if md > 0 else 0)
    assert int(need) == int(wneed)
    assert torch.equal(got.alive, want.alive)
    torch.testing.assert_close(got.mass, want.mass, rtol=1e-6, atol=0)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCENES)
def test_merge_kernel_matches_plain_on_card(cuda_device, name):
    pos, mass, alive, md, hcap = _scene(name)
    _kernel_vs_plain(pos, mass, alive, md, hcap, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("hcap", [1, 64, 1000])
def test_merge_kernel_overflow_on_card(cuda_device, hcap):
    """3000 heavies, some of equal mass, among 2^16 bodies: the kernel's
    radix select picks the plain version's H at the cap."""
    rng = np.random.default_rng(7)
    n = 1 << 16
    pos = rng.uniform(0.0, 2000.0, (n, 2)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    hs = rng.choice(n, 3000, replace=False)
    mass[hs] = rng.choice([4500.0, 5000.0, 7000.0], 3000).astype(np.float32)
    mass[hs[:100]] = np.linspace(8000.0, 9000.0, 100, dtype=np.float32)
    alive = rng.random(n) > 0.1
    _kernel_vs_plain(pos, mass, alive, 8.0, hcap, cuda_device)


@pytest.mark.cuda
def test_merge_kernel_one_body_and_no_heavy_on_card(cuda_device):
    pos = np.array([[10.0, 10.0]], np.float32)
    got = _kernel_vs_plain(pos, np.array([5000.0], np.float32),
                           np.array([True]), 8.0, 64, cuda_device)
    assert bool(got.alive[0])
    pos, mass, alive, md, _ = _scene("chain3")
    mass = np.minimum(mass, 100.0).astype(np.float32)   # empty table
    got = _kernel_vs_plain(pos, mass, alive, md, 16, cuda_device)
    assert torch.equal(got.alive.cpu(), torch.from_numpy(alive))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["chain3", "overflow", "single_alive",
                                  "3d"])
def test_merge_is_one_device_op_on_card(cuda_device, name):
    """One ``merge_bodies`` call is one wrapper launch and one device
    operation, the cooperative merge kernel: no memset, no second kernel
    (counted from a profiler trace of the call)."""
    from tpu_nbody_torch import profiling
    pos, mass, alive, md, hcap = _scene(name)
    st = _state(pos, mass, alive, cuda_device)
    before = _build.LAUNCHES["merge"]
    ops = profiling.device_ops(
        lambda: tmerge.merge_bodies(st, _params(md), heavy_cap=hcap))
    # an untraced call, a traced
    assert _build.LAUNCHES["merge"] == before + 2
    assert len(ops) == 1 and "merge_kernel" in ops[0], ops


@pytest.mark.cuda
def test_merge_kernel_on_four_streams_on_card(cuda_device):
    """Four threads each merge their own scene on their own stream, at
    once and 20 times over: the cooperative launches finish (no thread
    waits past its timeout) and each result equals the plain version's."""
    import threading
    names = ["chain3", "overflow", "dead_in_radius", "3d"]
    out, errors = {}, []

    def run(name):
        try:
            pos, mass, alive, md, hcap = _scene(name)
            st = _state(pos, mass, alive, cuda_device)
            side = torch.cuda.Stream(cuda_device)
            side.wait_stream(torch.cuda.current_stream(cuda_device))
            with torch.cuda.stream(side):
                for _ in range(20):
                    got, need = tmerge.merge_bodies(st, _params(md),
                                                    heavy_cap=hcap)
                torch.cuda.current_stream().synchronize()
            out[name] = (got, need, st, md, hcap)
        except Exception as e:    # reported below, with the scene
            errors.append((name, e))

    threads = [threading.Thread(target=run, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a merge never finished"
    assert not errors, errors
    for name, (got, need, st, md, hcap) in out.items():
        want, wneed = tmerge._merge_bodies_ref(st, _params(md),
                                               heavy_cap=hcap)
        assert int(need) == int(wneed), name
        assert torch.equal(got.alive, want.alive), name
        torch.testing.assert_close(got.mass, want.mass, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["chain3", "overflow", "3d"])
def test_sharded_halves_match_plain_on_card(cuda_device, name):
    """heavy_table and absorb on the card against their plain versions:
    the same heavies (in any slot order) and need; the same victims and
    gains (rtol 1e-6) against a table of two ranks' heavies."""
    pos, mass, alive, md, hcap = _scene(name)
    n = pos.shape[0]
    half = n // 2
    dev = cuda_device
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    tables = []
    for r in range(2):
        args = (t(pos[r * half:(r + 1) * half]),
                t(mass[r * half:(r + 1) * half]),
                t(alive[r * half:(r + 1) * half]), MAX_MASS, hcap)
        got = tmerge.heavy_table(*args, gid0=r * half)
        want = tmerge._heavy_table_ref(*args, gid0=r * half)
        assert int(got[0]) == int(want[0])

        def rows(tab):
            _, hpos, hgid, hvalid = (x.cpu() for x in tab)
            keep = hvalid.nonzero()[:, 0]
            order = torch.argsort(hgid[keep])
            return hgid[keep][order], hpos[keep][order]
        g_ids, g_pos = rows(got)
        w_ids, w_pos = rows(want)
        assert torch.equal(g_ids, w_ids) and torch.equal(g_pos, w_pos)
        tables.append(want[1:])
    hpos, hgid, hvalid = (torch.cat(x).contiguous() for x in zip(*tables))
    md2 = md * md
    for r in range(2):
        sl = slice(r * half, (r + 1) * half)
        args = (t(pos[sl]), t(mass[sl]), t(alive[sl]), hpos, hgid, hvalid,
                md2)
        gm, ga, gg = tmerge.absorb(*args, gid0=r * half)
        wm, wa, wg = tmerge._absorb_ref(*args, gid0=r * half)
        torch.cuda.synchronize()
        assert torch.equal(ga, wa) and torch.equal(gm, wm)
        torch.testing.assert_close(gg, wg, rtol=1e-6, atol=0)
