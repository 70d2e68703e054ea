"""The render's splat kernel (``csrc/render.cu``, through
``render._splat_launch`` and ``render_frame``) against the plain version,
``render._splat_sum``.

On the CPU: the kernel's sprite offsets are the plain version's rings in
their order, the palette it is handed is the speed ramp's own mid and fast
colours bit for bit, and a tensor off the CPU never takes the plain path:
``render_frame`` on it reaches the kernel's checks and raises (no launch
is counted).

On the card (marker ``cuda``, skipped without one) the kernel against the
plain version on the same card tensors: both colour modes, sprites off and
on with bodies at every tier, the identity and a shifted, zoomed view,
bodies at NaN, infinite and far-off coordinates, dead bodies; the sums
before the clip within RTOL of the brightest pixel (the same colours in
the same pixels, added in another order). Also: one launch counted a
frame, an all-dead state gives a black frame, ``render_frame_3d`` (a
velocity of three components), 2^20 bodies piled on one pixel (their sum
within 1e-4 of the float64 total), 2^20 clustered and sorted bodies at
the frames cell's 2400 x 800 frame with its sprites, and the three device
operations of a frame (the memset, the kernel and the clip). The JAX
package is not imported here, so the ``cuda`` tests collect where jax is
missing.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_nbody_torch.kernels import _build
from tpu_nbody_torch.ops import render as trender

torch.set_num_threads(2)

RTOL = 1e-4     # the sums: max |diff| <= RTOL x the brightest pixel
KERNEL_SRC = (Path(__file__).resolve().parents[1] / "tpu_nbody_torch"
              / "csrc" / "render.cu")


def _scene(seed, n, dim=2, span=(-40.0, 140.0)):
    """Bodies spread past every edge of a 100 x 60 screen, a third of them
    dead, speeds over the whole ramp, masses over every sprite tier (at
    size_mass_scale 1e-3: 1000 is size 2, 2000 size 3, 10,000 size 5); in
    2D the first six alive at NaN, infinite and far-off coordinates (a 3D
    frame's camera centres on the bodies' centre of mass, which they would
    make NaN)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(*span, (n, dim)).astype(np.float32)
    vel = (rng.standard_normal((n, dim))
           * rng.choice([10.0, 800.0, 4000.0], (n, 1))).astype(np.float32)
    mass = rng.choice([0.5, 10.0, 999.0, 1000.0, 2000.0, 10_000.0],
                      n).astype(np.float32)
    alive = rng.random(n) > 0.33
    if dim == 2:
        alive[:6] = True
        pos[:6] = [[np.nan, 3.0], [3.0, np.inf], [-np.inf, 3.0], [3e38, 3.0],
                   [3.0, -3e38], [5e9, 5e9]]
    return [torch.from_numpy(x) for x in (pos, vel, mass, alive)]


def _meta(n=8, pd=2, vd=2):
    return (torch.zeros((n, pd), device="meta"),
            torch.zeros((n, vd), device="meta"),
            torch.zeros((n,), device="meta"),
            torch.zeros((n,), dtype=torch.bool, device="meta"))


def test_kernel_offsets_are_the_sprite_rings():
    src = KERNEL_SRC.read_text()

    def table(name):
        body = re.search(name + r"\[21\] = \{([^}]*)\}", src).group(1)
        return [int(v) for v in body.split(",")]

    offsets = list(zip(table("DX"), table("DY")))
    assert offsets == [(0, 0), *trender._RING1, *trender._RING2]


def test_kernel_palette_is_the_ramp_bit_for_bit():
    """The six floats handed to the kernel are speed_colors' colour at
    t = 0.5 (mid: |v| speed_scale is 0.1 in float32) and t = 5 (fast)."""
    mid, fast = trender.speed_colors(torch.tensor([[1.0, 0.0], [1e6, 0.0]]),
                                     0.1)
    assert trender._kernel_palette() == tuple(mid.tolist() + fast.tolist())
    assert all(isinstance(c, float) for c in trender._kernel_palette())


@pytest.mark.parametrize("case,kw,match", [
    ("off the cpu", {}, "CUDA tensor"),
    ("unknown mode", dict(mode="heat"), "color mode"),
    ("vel of 4", dict(vd=4), "vel of shape"),
    ("pos of 1", dict(pd=1), "pos of shape"),
    ("frame too large", dict(width=40_000, height=20_000), "int32"),
])
def test_render_frame_off_the_cpu_takes_no_plain_path(case, kw, match):
    """A tensor on no CPU goes to the kernel's wrapper, which raises on
    what the kernel does not take, before any build or launch."""
    kw = dict(kw)
    shape = dict(n=8, pd=kw.pop("pd", 2), vd=kw.pop("vd", 2))
    args = dict(dict(width=16, height=8), **kw)
    before = _build.LAUNCHES["render"]
    with pytest.raises(ValueError, match=match):
        trender.render_frame(*_meta(**shape), **args)
    assert _build.LAUNCHES["render"] == before


# -- on the card -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want):
    """The kernel's sums against the plain version's, on the card."""
    torch.cuda.synchronize()
    assert got.is_cuda and got.shape == want.shape
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert bool(torch.isfinite(got).all())
    peak = float(want.max())
    assert peak > 0.0
    diff = float((got - want).abs().max())
    assert diff <= RTOL * peak, (diff, peak)
    assert torch.equal(got > 0, want > 0)


VIEWS = {"identity": {},
         "shifted-zoomed": dict(view_x=-12.5, view_y=7.25, zoom=1.7)}


@pytest.mark.cuda
@pytest.mark.parametrize("view", VIEWS)
@pytest.mark.parametrize("sprites", [0.0, 1e-3])
@pytest.mark.parametrize("mode", ["speed", "classic"])
def test_splat_kernel_matches_plain_on_card(cuda_device, mode, sprites,
                                            view):
    bodies = [t.to(cuda_device) for t in _scene(1, 50_000)]
    kw = dict(width=100, height=60, view_x=0.0, view_y=0.0, zoom=1.0,
              mode=mode, speed_scale=1 / 3000.0, gain=0.7, size_base=1.0,
              size_mass_scale=sprites)
    kw.update(VIEWS[view])
    before = _build.LAUNCHES["render"]
    got = trender._splat_launch(*bodies, **kw)
    assert _build.LAUNCHES["render"] == before + 1
    _close(got, trender._splat_sum(*bodies, **kw))


@pytest.mark.cuda
def test_render_frame_launches_once_a_frame_on_card(cuda_device):
    bodies = [t.to(cuda_device) for t in _scene(2, 20_000)]
    kw = dict(width=100, height=60, mode="speed", speed_scale=1 / 3000.0,
              size_mass_scale=1e-3)
    before = _build.LAUNCHES["render"]
    frames = [trender.render_frame(*bodies, **kw) for _ in range(3)]
    assert _build.LAUNCHES["render"] == before + 3
    want = torch.clamp(trender._splat_sum(
        *bodies, view_x=0.0, view_y=0.0, zoom=1.0, gain=1.0, size_base=1.0,
        **kw), 0.0, 1.0)
    for fb in frames:
        assert float(fb.max()) == 1.0 and float(fb.min()) == 0.0
        _close(fb, want)


@pytest.mark.cuda
def test_all_dead_state_gives_a_black_frame_on_card(cuda_device):
    pos, vel, mass, alive = (t.to(cuda_device) for t in _scene(3, 10_000))
    fb = trender.render_frame(pos, vel, mass, torch.zeros_like(alive),
                              width=100, height=60, size_mass_scale=1e-3)
    torch.cuda.synchronize()
    assert fb.shape == (60, 100, 3) and int(torch.count_nonzero(fb)) == 0


@pytest.mark.cuda
def test_far_and_non_finite_coordinates_on_card(cuda_device):
    """The CPU test's case (tests/test_torch_render.py) through the
    kernel: nothing of the non-finite and far-off bodies is drawn, and
    the 5 x 5 discs centred just past the edges keep their on-screen
    part."""
    big = 3.0e38
    pos = torch.tensor([[float("nan"), 3.0], [3.0, float("inf")],
                        [-float("inf"), 3.0], [big, 3.0], [3.0, -big],
                        [5e9, 5e9], [-1.0, 3.0], [16.0, 3.0], [6.0, 2.0]],
                       device=cuda_device)
    n = pos.shape[0]
    mass = torch.full((n,), 10_000.0, device=cuda_device)
    alive = torch.ones(n, dtype=torch.bool, device=cuda_device)
    vel = torch.zeros((n, 2), device=cuda_device)
    fb = trender.render_frame(pos, vel, mass, alive, width=16, height=8,
                              mode="speed", size_mass_scale=1e-3)
    lit = fb.sum(dim=2) > 0
    assert bool(torch.isfinite(fb).all())
    assert bool(lit[3, 0] and lit[3, 1] and lit[3, 14] and lit[3, 15])
    assert int(lit.sum()) == 21 + 2 * (5 + 3)
    none = trender.render_frame(pos[:6], vel[:6], mass[:6], alive[:6],
                                width=16, height=8, size_mass_scale=1e-3)
    assert float(none.sum()) == 0.0


@pytest.mark.cuda
def test_render_frame_3d_on_card(cuda_device):
    """A velocity of three components: the 3D frame against the plain
    splat of the same screen coordinates, taken on the card."""
    pos, vel, mass, alive = (t.to(cuda_device) for t in _scene(
        4, 30_000, dim=3, span=(0.0, 100.0)))
    cam = dict(width=120, height=80, cam_angle=0.3)
    before = _build.LAUNCHES["render"]
    got = trender.render_frame_3d(pos, vel, mass, alive, gain=0.2,
                                  speed_scale=1 / 3000.0, **cam)
    assert _build.LAUNCHES["render"] == before + 1
    pos2 = trender._project_3d(pos, mass, alive, **cam)
    want = torch.clamp(trender._splat_sum(
        pos2, vel, mass, alive, width=120, height=80, view_x=0.0,
        view_y=0.0, zoom=1.0, mode="speed", speed_scale=1 / 3000.0,
        gain=0.2, size_base=1.0, size_mass_scale=0.0), 0.0, 1.0)
    _close(got, want)


@pytest.mark.cuda
def test_bodies_piled_on_one_pixel_on_card(cuda_device):
    """2^20 alive bodies in pixel (10, 5): every lane of every warp hits
    one pixel; the sum is the float64 total of their colours within
    1e-4, and nothing else is lit. It holds the warp pre-sum: with an
    atomic a lane, most bodies of one colour, the sum ended 7.4e-3 off."""
    n = 2**20
    g = torch.Generator(device=cuda_device).manual_seed(5)
    pos = torch.tensor([10.3, 5.7], device=cuda_device).expand(n, 2)
    pos = pos.contiguous()
    vel = torch.randn((n, 2), generator=g, device=cuda_device) * 3000.0
    mass = torch.ones((n,), device=cuda_device)
    alive = torch.ones((n,), dtype=torch.bool, device=cuda_device)
    sums = trender._splat_launch(
        pos, vel, mass, alive, width=32, height=16, view_x=0.0, view_y=0.0,
        zoom=1.0, mode="speed", speed_scale=1e-4, gain=1.0, size_base=1.0,
        size_mass_scale=0.0)
    total = trender.speed_colors(vel, 1e-4).double().sum(dim=0)
    got = sums[5, 10].double()
    assert float(((got - total).abs() / total).max()) <= 1e-4
    assert int(torch.count_nonzero(sums.sum(dim=2))) == 1


@pytest.mark.cuda
def test_clustered_sorted_bodies_at_the_frames_shape_on_card(cuda_device):
    """2^20 slots in two Gaussian disks in a 2400 x 800 frame, sorted by
    pixel (most warps' lanes hit one pixel in the disks' cores), masses
    over every tier at the frames cell's size_mass_scale 1e-4, 5% dead."""
    n = 2**20
    g = torch.Generator(device=cuda_device).manual_seed(6)
    centre = torch.where(torch.rand((n, 1), generator=g, device=cuda_device)
                         < 0.8,
                         torch.tensor([900.0, 400.0], device=cuda_device),
                         torch.tensor([1700.0, 420.0], device=cuda_device))
    pos = centre + torch.randn((n, 2), generator=g, device=cuda_device) * 60
    key = (torch.floor(pos[:, 1]) * 2400 + torch.floor(pos[:, 0]))
    pos = pos[torch.argsort(key)].contiguous()
    vel = torch.randn((n, 2), generator=g, device=cuda_device) * 200.0
    mass = torch.rand((n,), generator=g, device=cuda_device) * 10.0
    mass[::4096] = 20_000.0
    mass[::8192] = 50_000.0
    alive = torch.rand((n,), generator=g, device=cuda_device) > 0.05
    kw = dict(width=2400, height=800, view_x=0.0, view_y=0.0, zoom=1.0,
              mode="speed", speed_scale=1 / 300.0, gain=1.0, size_base=1.0,
              size_mass_scale=1e-4)
    _close(trender._splat_launch(pos, vel, mass, alive, **kw),
           trender._splat_sum(pos, vel, mass, alive, **kw))


@pytest.mark.cuda
def test_render_frame_device_operations_on_card(cuda_device):
    """A frame enqueues the memset of the frame, the kernel and the clip:
    no index_add_."""
    from tpu_nbody_torch import profiling
    bodies = [t.to(cuda_device) for t in _scene(7, 20_000)]
    ops = profiling.device_ops(lambda: trender.render_frame(
        *bodies, width=100, height=60, size_mass_scale=1e-3))
    assert len(ops) == 3 and "emset" in ops[0] \
        and "splat_kernel" in ops[1], ops
    assert not any("index" in op.lower() for op in ops), ops
