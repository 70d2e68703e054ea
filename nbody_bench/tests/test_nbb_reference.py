"""The plain reference against first principles on small scenes."""

import pytest
import torch

from nbody_bench import scene
from nbody_bench.reference import gravity, merge, render
from nbody_bench.reference.p3m import P3M


def test_direct_sum_of_two_bodies():
    pos = torch.tensor([[0.0, 0.0], [3.0, 4.0]])
    mass = torch.tensor([2.0, 5.0])
    a = gravity.direct_accel(pos, pos, mass, 80.0, 1.0, block_elems=1)
    k = 80.0 / 26.0 ** 1.5
    assert a[0].tolist() == pytest.approx([k * 5 * 3, k * 5 * 4])
    assert a[1].tolist() == pytest.approx([-k * 2 * 3, -k * 2 * 4])


@pytest.mark.parametrize("seed", [1, 2])
def test_p3m_against_the_direct_sum(seed):
    pos, _, mass = scene.two_disk(seed, 6000, "cpu")
    h = 2404.0 / 2048
    solver = P3M(h, 3.0 * h, 1.0, 80.0)
    a = solver.accel(pos, mass)
    ex = gravity.direct_accel(pos, pos, mass, 80.0, 1.0)
    err = (a - ex).norm(dim=1) / ex.norm(dim=1)
    assert float(err.median()) < 3e-3
    assert float(err.quantile(0.9)) < 1e-2


def test_p3m_short_range_chunks_agree():
    pos, _, mass = scene.two_disk(3, 2000, "cpu")
    solver = P3M(1.0, 3.0, 1.0, 80.0)
    whole = solver.short_range(pos, mass)
    from nbody_bench.reference import p3m
    old = p3m.PAIR_CHUNK
    p3m.PAIR_CHUNK = 997
    try:
        chunked = solver.short_range(pos, mass)
    finally:
        p3m.PAIR_CHUNK = old
    assert torch.allclose(whole, chunked, rtol=1e-12, atol=1e-12)


def test_absorb_rule():
    pos = torch.tensor([[0.0, 0.0], [5.0, 0.0], [100.0, 0.0], [104.0, 0.0],
                        [7.9, 0.0], [50.0, 50.0]], dtype=torch.float64)
    mass = torch.tensor([5e4, 1.0, 5e3, 9e3, 2.0, 3.0], dtype=torch.float64)
    alive = torch.ones(6, dtype=torch.bool)
    m, a = merge.absorb(pos, mass, alive, 4000.0, 8.0)
    # body 3 (heavy) is the victim of heavy 2, so it absorbs nothing
    assert a.tolist() == [True, False, True, False, False, True]
    assert m.tolist() == [5e4 + 3.0, 0.0, 5e3 + 9e3, 0.0, 0.0, 3.0]
    off = merge.absorb(pos, mass, alive, 4000.0, 0.0)
    assert off[1].all()


def test_render_splats_and_sprites():
    pos = torch.tensor([[3.5, 2.2], [3.9, 2.7], [10.0, 5.0], [-1.0, 0.0]])
    vel = torch.tensor([[0.0, 0.0], [0.0, 0.0], [300.0, 0.0], [0.0, 0.0]])
    mass = torch.tensor([1.0, 1.0, 5e4, 1.0])
    alive = torch.tensor([True, True, True, True])
    img = render.frame(pos, vel, mass, alive, width=16, height=8,
                       speed_scale=1 / 300.0, size_mass_scale=1e-4)
    assert img[2, 3].tolist() == [255, 255, 255]      # two white bodies
    fast = [round(255 * (0.77 + 0.23 * c)) for c in (0.65, 0.0, 0.95)]
    assert img[5, 10].tolist() == fast
    assert img[4, 12].tolist() == fast and img[7, 10].tolist() == fast
    assert img[3, 12].tolist() == [0, 0, 0]           # a corner of 5 x 5
    assert int((img.sum(dim=2) > 0).sum()) == 1 + 21


def test_direct_sum_in_3d():
    pos = torch.tensor([[0.0, 0.0, 0.0], [2.0, 3.0, 6.0]])
    mass = torch.tensor([2.0, 5.0])
    a = gravity.direct_accel(pos, pos, mass, 80.0, 1.0, block_elems=1)
    assert a.shape == (2, 3)
    k = 80.0 / 50.0 ** 1.5
    assert a[0].tolist() == pytest.approx([k * 5 * 2, k * 5 * 3, k * 5 * 6])
    assert a[1].tolist() == pytest.approx([-k * 2 * 2, -k * 2 * 3,
                                           -k * 2 * 6])
    flat = gravity.direct_accel(pos[:, :2], pos[:, :2], mass, 80.0, 1.0)
    assert flat.shape == (2, 2)


@pytest.mark.parametrize("integrator", ["euler", "kdk_reuse"])
def test_follow_steps_by_the_integrator(integrator):
    """Two bodies, two steps, exact forces (no mesh: the 3D path): Euler
    kicks with the force at the step's start and then drifts; kdk kicks
    half, drifts, kicks half with the new force."""
    from nbody_bench.reference.follow import Physics, follow

    pos = torch.tensor([[0.0, 0.0, 0.0], [10.0, 0.0, 5.0]],
                       dtype=torch.float64)
    vel = torch.tensor([[0.0, 1.0, 0.0], [0.0, -1.0, 2.0]],
                       dtype=torch.float64)
    mass = torch.tensor([3.0, 7.0], dtype=torch.float64)
    alive = torch.ones(2, dtype=torch.bool)
    ph = Physics(G=2.0, dt=0.1, soft2=1.0, merge_max_mass=4000.0,
                 merge_min_dist=0.0)

    def acc(p):
        return gravity.direct_accel(p, p, mass, ph.G, ph.soft2,
                                    self_idx=torch.arange(2))

    P, V = pos.clone(), vel.clone()
    for _ in range(2):
        if integrator == "euler":
            V = V + acc(P) * ph.dt
            P = P + V * ph.dt
        else:
            V = V + acc(P) * (0.5 * ph.dt)
            P = P + V * ph.dt
            V = V + acc(P) * (0.5 * ph.dt)
    f = follow(pos, vel, mass, alive, torch.tensor([1]), 2, ph, None,
               integrator)
    assert torch.allclose(f.pos, P, rtol=1e-14, atol=0)
    assert torch.allclose(f.vel, V, rtol=1e-14, atol=0)
    assert torch.equal(f.tpos, f.pos[[1]]) and torch.equal(f.tvel,
                                                           f.vel[[1]])
    with pytest.raises(ValueError):
        follow(pos, vel, mass, alive, torch.tensor([1]), 1, ph, None, "rk4")


@pytest.mark.parametrize("yaw", [0.0, 0.004, 1.3])
def test_the_3d_frame_is_the_programs_camera(yaw):
    """The reference's camera and splat against the program's
    ``render_frame_3d`` on one state: the same pixels, but for the few
    bodies the float32 camera puts across a pixel edge."""
    from tpu_nbody_torch.ops import render as program_render

    pos, vel, mass = scene.sphere3d(4, 3001, "cpu")
    alive = torch.ones(3001, dtype=torch.bool)
    alive[7] = False
    cam = dict(width=430, height=180, cam_pitch=0.2617994,
               speed_scale=1e-4, gain=0.6)
    got = program_render.to_uint8(program_render.render_frame_3d(
        pos * 0.125, vel, mass, alive, cam_angle=yaw, **cam))
    ref = render.frame3d(pos, vel, mass, alive, cam_angle=yaw,
                         world_scale=0.125, **cam)
    diff = (got.to(torch.int16) - ref.to(torch.int16)).abs().amax(dim=2)
    lit = int(((got.amax(dim=2) > 0) | (ref.amax(dim=2) > 0)).sum())
    assert lit > 2000
    assert int((diff > 1).sum()) <= 0.002 * lit
