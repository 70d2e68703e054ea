"""The frozen work arithmetic: against PERF.md's bounds at N = 2^20 and
the data-dependent counts against brute force."""

import itertools

import pytest
import torch

from nbody_bench import scene, work


def test_mesh_pass_bounds_at_one_million():
    lr = work.long_range_pass(1 << 20, 597_676, 4096, 2048)["parts"]
    ms = {k: 1e3 * work.bound_s(v["flops"], v["bytes"])
          for k, v in lr.items()}
    assert ms["deposit"] == pytest.approx(0.03007, abs=5e-6)
    assert ms["fd"] == pytest.approx(0.03011, abs=5e-6)
    assert ms["fft"] == pytest.approx(0.08023, abs=5e-6)
    assert ms["interp"] == pytest.approx(0.01019, abs=5e-6)


def test_geometry_of_the_main_path():
    origin, side = work.root(2400.0, 800.0)
    assert origin == (-2.0, -802.0) and side == 2404.0
    nw, ny, grid, grid_y, h, a, morigin = work.pm_geometry(
        origin, side, 12, 2048, 2.5)
    assert (nw, ny, grid, grid_y) == (4096, 2048, 8192, 4096)
    assert h == pytest.approx(2404.0 / 4096) and a == pytest.approx(2.5 * h)
    assert morigin[1] == pytest.approx(400.0 - 1024 * h, abs=1e-3)


def _scene(n, seed):
    pos, _, mass = scene.two_disk(seed, n, "cpu")
    alive = torch.ones(n, dtype=torch.bool)
    alive[::7] = False
    mass = torch.where(torch.arange(n) % 11 == 0, 0.0, mass)
    return pos, mass, alive


@pytest.mark.parametrize("seed,rc", [(1, 3.0), (2, 7.5), (3, 20.0)])
def test_pairs_within_against_brute_force(seed, rc):
    pos, mass, alive = _scene(1500, seed)
    live = alive & (mass > 0)
    p = pos[live].double()
    d = torch.cdist(p, p)
    want = int((d < rc).sum()) - p.shape[0]
    assert work.pairs_within(pos, mass, alive, rc, chunk=997) == want


@pytest.mark.parametrize("seed", [4, 5])
def test_cells_touched_against_brute_force(seed):
    pos, _, alive = _scene(800, seed)
    morigin, h, nw, ny = (-2.0, -201.0), 4.7, 512, 256
    cells = set()
    for (x, y), ok in zip(pos.tolist(), alive.tolist()):
        if not ok:
            continue
        bx = min(max(int(torch.floor(torch.tensor((x - morigin[0]) / h
                                                  - 0.5))), 0), nw - 1)
        by = min(max(int(torch.floor(torch.tensor((y - morigin[1]) / h
                                                  - 0.5))), 0), ny - 1)
        for ox, oy in itertools.product((0, 1), (0, 1)):
            cells.add((by + oy) * (nw + 1) + bx + ox)
    got = work.cells_touched(pos, alive, morigin, h, nw, ny)
    assert abs(got - len(cells)) <= 2      # float32 vs float64 rounding
