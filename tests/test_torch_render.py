"""Port parity: tpu_nbody_torch.ops.render against tpu_nbody.ops.render on
the same numpy bodies, and the cases of tests/test_render.py on the port.

Tolerances: colors within 1e-6 (float32 on both sides, the norm and the
smoothstep rounded by two libraries); framebuffers within 1e-5 a pixel,
compared as the additive sums before the final clip where a test says so
(scatter-adds take another order), and uint8 frames within 1 level."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nbody import config as jconfig
from tpu_nbody.ops import forces as jforces
from tpu_nbody.ops import integrate as jintegrate
from tpu_nbody.ops import render as jrender
from tpu_nbody.state import from_arrays as jfrom_arrays
from tpu_nbody_torch import config as tconfig
from tpu_nbody_torch import engine as tengine
from tpu_nbody_torch import state as tstate
from tpu_nbody_torch.ops import integrate as tintegrate
from tpu_nbody_torch.ops import render as trender

torch.set_num_threads(2)


def _bodies(seed, n, dim=2, span=(-40.0, 140.0)):
    """Bodies spread past every edge of a 100 x 60 screen, a third of them
    dead, speeds over the whole ramp, masses over every sprite tier."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(*span, (n, dim)).astype(np.float32)
    vel = (rng.standard_normal((n, dim))
           * rng.choice([10.0, 800.0, 4000.0], (n, 1))).astype(np.float32)
    mass = rng.choice([0.5, 10.0, 999.0, 1000.0, 2000.0, 10_000.0],
                      n).astype(np.float32)
    alive = rng.random(n) > 0.33
    return pos, vel, mass, alive


def _both(fn_name, arrays, **kw):
    want = getattr(jrender, fn_name)(*map(jnp.asarray, arrays), **kw)
    got = getattr(trender, fn_name)(*map(torch.from_numpy, arrays), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("dim,scale", [(2, 1e-4), (3, 1e-4), (2, 1 / 300.0)])
def test_speed_colors_match_jax(dim, scale):
    vel = _bodies(0, 4000, dim)[1]
    got, want = _both("speed_colors", (vel,), speed_scale=scale)
    assert got.shape == (4000, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got.min() >= 0.76 and got.max() <= 1.0


def test_speed_ramp_endpoints():
    v = torch.tensor([[0.0, 0.0], [10_000.0, 0.0]])
    cols = trender.speed_colors(v).numpy()
    np.testing.assert_allclose(cols[0], [1, 1, 1], atol=1e-6)  # slow = white
    # fast = 0.77*white + 0.23*(0.65, 0, 0.95)
    np.testing.assert_allclose(cols[1], [0.9195, 0.77, 0.9885], atol=1e-4)


def test_classic_colors_match_jax():
    mass = _bodies(1, 500)[2]
    got, want = _both("classic_colors", (mass,))
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {0.0, 1.0}


@pytest.mark.parametrize("mode", ["speed", "classic"])
@pytest.mark.parametrize("view", [
    {}, dict(view_x=-12.5, view_y=7.25, zoom=0.6),
    dict(view_x=30.0, view_y=10.0, zoom=2.5, gain=0.35),
], ids=["identity", "zoom-out", "zoom-in"])
def test_render_frame_matches_jax(mode, view):
    """Off-screen, negative and dead bodies included: a body at x in
    (-1, 0) floors to pixel -1 and is dropped, where truncation would draw
    it in column 0."""
    arrays = _bodies(2, 3000)
    kw = dict(width=100, height=60, mode=mode, speed_scale=1 / 3000.0, **view)
    got, want = _both("render_frame", arrays, **kw)
    assert got.shape == (60, 100, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert 0.0 < got.max() <= 1.0 and got.min() == 0.0
    u8, wu8 = (trender.to_uint8(torch.from_numpy(got)).numpy(),
               np.asarray(jrender.to_uint8(jnp.asarray(want))))
    assert u8.dtype == np.uint8
    assert np.abs(u8.astype(int) - wu8.astype(int)).max() <= 1


def test_render_frame_sum_before_clip_matches_jax():
    """The additive sum itself, on a crowded screen where most pixels
    saturate: the JAX frame with a gain small enough that nothing clips
    is that sum, scaled."""
    arrays = _bodies(3, 20_000, span=(0.0, 30.0))
    kw = dict(width=32, height=32, mode="speed", speed_scale=1 / 3000.0)
    want = np.asarray(jrender.render_frame(*map(jnp.asarray, arrays),
                                           gain=1e-3, **kw))
    assert want.max() < 1.0
    got = trender._splat_sum(*map(torch.from_numpy, arrays), view_x=0.0,
                             view_y=0.0, zoom=1.0, gain=1.0, size_base=1.0,
                             size_mass_scale=0.0, **kw).numpy()
    assert got.max() > 5.0
    np.testing.assert_allclose(got * 1e-3, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("scale,base", [(1e-3, 1.0), (2e-4, 2.0)])
def test_render_frame_sprites_match_jax(scale, base):
    arrays = _bodies(4, 600)
    kw = dict(width=100, height=60, mode="speed", speed_scale=1 / 3000.0,
              size_mass_scale=scale, size_base=base, gain=0.05)
    got, want = _both("render_frame", arrays, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    plain, _ = _both("render_frame", arrays, **dict(kw, size_mass_scale=0.0))
    assert (got > 0).sum() > (plain > 0).sum()


def test_splat_positions():
    pos = torch.tensor([[1.5, 2.5], [10.0, 0.0], [-5.0, 3.0]])
    fb = trender.render_frame(pos, torch.zeros(3, 2), torch.ones(3),
                              torch.ones(3, dtype=torch.bool), width=16,
                              height=8, mode="classic").numpy()
    assert fb[2, 1].sum() > 0     # (x=1, y=2)
    assert fb[0, 10].sum() > 0
    assert fb.sum() == pytest.approx(6.0)  # offscreen body dropped, 2 white px


def test_classic_heavy_bodies_black():
    pos = torch.tensor([[1.0, 1.0], [2.0, 1.0]])
    fb = trender.render_frame(pos, torch.zeros(2, 2),
                              torch.tensor([10.0, 5000.0]),
                              torch.ones(2, dtype=torch.bool), width=4,
                              height=4, mode="classic").numpy()
    assert fb[1, 1].sum() == pytest.approx(3.0)   # light -> white
    assert fb[1, 2].sum() == pytest.approx(0.0)   # heavy -> black (parity)


def test_mass_scaled_splat_tiers():
    """gpu/GPU.kt:226 point size: light 1px, mid 3x3 disc, heavy 5x5 disc."""
    pos = torch.tensor([[4.0, 4.0], [16.0, 4.0], [26.0, 4.0]])
    vel = torch.zeros(3, 2)
    # size = 1 + 1e-3*m -> sizes 1.0 / 3.0 / 5.0 (clamped)
    mass = torch.tensor([10.0, 2000.0, 10_000.0])
    alive = torch.ones(3, dtype=torch.bool)
    fb = trender.render_frame(pos, vel, mass, alive, width=32, height=9,
                              mode="speed", size_mass_scale=1e-3).numpy()
    lit = (fb.sum(axis=2) > 0)
    assert lit[4, 4] and not lit[3, 4] and not lit[5, 4]     # 1 px
    assert lit[3:6, 15:18].all()                             # 3x3 disc
    assert not lit[2, 14] and not lit[6, 18]
    assert lit[2:7, 24:29].sum() == 21                       # 5x5 minus corners
    assert not lit[2, 24] and not lit[2, 28]                 # corners dark
    # default path unchanged: single pixels
    fb1 = trender.render_frame(pos, vel, mass, alive, width=32, height=9,
                               mode="speed").numpy()
    assert (fb1.sum(axis=2) > 0).sum() == 3


def test_zoom_view_transform():
    fb = trender.render_frame(
        torch.tensor([[100.0, 50.0]]), torch.zeros(1, 2), torch.ones(1),
        torch.ones(1, dtype=torch.bool), width=32, height=32, view_x=90.0,
        view_y=40.0, zoom=2.0, mode="classic").numpy()
    assert fb[20, 20].sum() > 0  # (100-90)*2 = 20


def test_far_and_non_finite_coordinates_are_off_screen():
    """No index from a NaN, an infinity or a coordinate past the int32
    range reaches the scatter; sprites near an edge keep their on-screen
    part."""
    big = 3.0e38
    pos = torch.tensor([[float("nan"), 3.0], [3.0, float("inf")],
                        [-float("inf"), 3.0], [big, 3.0], [3.0, -big],
                        [5e9, 5e9], [-1.0, 3.0], [16.0, 3.0], [6.0, 2.0]])
    n = pos.shape[0]
    mass = torch.full((n,), 10_000.0)
    fb = trender.render_frame(pos, torch.zeros(n, 2), mass,
                              torch.ones(n, dtype=torch.bool), width=16,
                              height=8, mode="speed", size_mass_scale=1e-3)
    assert torch.isfinite(fb).all()
    lit = fb.sum(dim=2) > 0
    # the 5x5 discs centred at x = -1 and x = 16 reach columns 0-1 and 14-15
    assert lit[3, 0] and lit[3, 1] and lit[3, 14] and lit[3, 15]
    assert int(lit.sum()) == 21 + 2 * (5 + 3)
    one = trender.render_frame(pos[:6], torch.zeros(6, 2), mass[:6],
                               torch.ones(6, dtype=torch.bool), width=16,
                               height=8, mode="classic")
    assert float(one.sum()) == 0.0


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="color mode"):
        trender.render_frame(torch.zeros(1, 2), torch.zeros(1, 2),
                             torch.ones(1), torch.ones(1, dtype=torch.bool),
                             width=4, height=4, mode="heat")


@pytest.mark.parametrize("kw", [
    dict(cam_angle=0.0), dict(cam_angle=0.3, gain=0.6),
    dict(cam_angle=2.1, cam_pitch=0.5, center=[50.0, 30.0, 10.0]),
], ids=["front", "demo", "given-centre"])
def test_render_frame_3d_matches_jax(kw):
    """The camera's sines are taken in float32 by both packages; a body
    within an ulp of a pixel edge may still land one pixel over, so up to
    2 of the 3000 bodies, 4 pixels, may differ."""
    arrays = _bodies(5, 3000, dim=3, span=(0.0, 100.0))
    jkw = dict(kw)
    if "center" in jkw:
        jkw["center"] = jnp.asarray(jkw["center"])
    want = np.asarray(jrender.render_frame_3d(
        *map(jnp.asarray, arrays), width=120, height=80,
        speed_scale=1 / 3000.0, **jkw))
    got = trender.render_frame_3d(
        *map(torch.from_numpy, arrays), width=120, height=80,
        speed_scale=1 / 3000.0, **kw).numpy()
    assert got.shape == (80, 120, 3) and got.sum() > 100.0
    differ = (np.abs(got - want).max(axis=2) > 1e-5).sum()
    assert differ <= 4, differ


def test_render3d_runs():
    pos = torch.tensor([[0.0, 0.0, 0.0], [5.0, 5.0, 5.0]])
    fb = trender.render_frame_3d(pos, torch.ones(2, 3), torch.ones(2),
                                 torch.ones(2, dtype=torch.bool), width=32,
                                 height=16, cam_angle=torch.tensor(0.3))
    assert fb.shape == (16, 32, 3)


def test_to_uint8_matches_jax():
    fb = np.linspace(-0.2, 1.2, 4001, dtype=np.float32).reshape(-1, 1)
    got, want = _both("to_uint8", (fb,))
    assert got.dtype == np.uint8 and got.min() == 0 and got.max() == 255
    np.testing.assert_array_equal(got, want)


def test_render_movie_matches_jax_frame_by_frame():
    """The case of tests/test_render.py's fused scan: two bodies, kdk under
    exact forces, 4 frames of 2 steps; every frame equal to the JAX
    package's, the final state within 1e-4 px."""
    pos = np.array([[10.0, 10.0], [20.0, 10.0]], np.float32)
    vel = np.array([[0.0, 20.0], [0.0, -20.0]], np.float32)
    mass = np.ones(2, np.float32)
    kw = dict(n_frames=4, steps_per_frame=2, width=32, height=32,
              mode="classic")

    def jaccel(p, m, alive, prm):
        return jforces.accel_allpairs(p, jnp.where(alive, m, 0.0), prm.G,
                                      prm.soft2, implementation="xla")

    jfinal, jframes = jrender.render_movie(
        jfrom_arrays(*map(jnp.asarray, (pos, vel, mass))),
        jconfig.Params.default(dt=0.05, merge_min_dist=0.0),
        lambda s, prm: jintegrate.kdk_step(s, prm, jaccel), **kw)

    accel = tengine.make_allpairs_accel()
    calls = []

    def step(s, prm):
        calls.append(int(s.step))
        return tintegrate.kdk_step(
            s, prm, lambda *a: accel(*a)[0])

    final, frames = trender.render_movie(
        tstate.from_arrays(pos, vel, mass, device="cpu"),
        tconfig.Params.default(dt=0.05, merge_min_dist=0.0), step, **kw)
    assert calls == list(range(8))
    assert frames.shape == (4, 32, 32, 3) and frames.dtype == torch.uint8
    assert frames.device == final.pos.device
    assert int(final.step) == 8
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jframes))
    assert not torch.equal(frames[0], frames[-1])
    assert int(frames.sum()) > 0
    np.testing.assert_allclose(final.pos.numpy(), np.asarray(jfinal.pos),
                               atol=1e-4)
