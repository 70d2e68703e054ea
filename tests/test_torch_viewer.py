"""Port parity: tpu_nbody_torch.viewer against tpu_nbody.viewer. PNG and
GIF files are equal byte for byte for the same frames; Viewport and Hud run
the cases of tests/test_render.py on both packages and agree exactly
(Python floats on both sides; Params fields to float32 rounding)."""

import dataclasses
import struct
import zlib

import numpy as np
import pytest
import torch

from tpu_nbody import config as jconfig
from tpu_nbody import viewer as jviewer
from tpu_nbody_torch import config as tconfig
from tpu_nbody_torch import viewer as tviewer
from tpu_nbody_torch.ops import render as trender

torch.set_num_threads(2)


def _frames(seed, n, h, w, smooth=False):
    rng = np.random.default_rng(seed)
    if smooth:   # long runs of equal indices: the LZW table fills and resets
        base = np.linspace(0, 255, h * w * 3).reshape(h, w, 3)
        return [((base + 40 * i) % 256).astype(np.uint8) for i in range(n)]
    return [(rng.random((h, w, 3)) * 255).astype(np.uint8) for _ in range(n)]


@pytest.mark.parametrize("shape", [(8, 12), (1, 1), (60, 100)])
def test_write_png_bytes_equal(tmp_path, shape):
    img = _frames(0, 1, *shape)[0]
    tviewer.write_png(tmp_path / "t.png", img)
    jviewer.write_png(tmp_path / "j.png", img)
    raw = (tmp_path / "t.png").read_bytes()
    assert raw == (tmp_path / "j.png").read_bytes()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n" and raw[12:16] == b"IHDR"
    assert struct.unpack(">II", raw[16:24]) == shape[::-1]
    # decode IDAT and compare pixels
    off = 8 + 4 + 4 + 13 + 4
    ln = struct.unpack(">I", raw[off:off + 4])[0]
    rows = np.frombuffer(zlib.decompress(raw[off + 8:off + 8 + ln]),
                         np.uint8).reshape(shape[0], 1 + shape[1] * 3)
    np.testing.assert_array_equal(
        rows[:, 1:].reshape(*shape, 3), img)


@pytest.mark.parametrize("n,h,w,fps,smooth", [
    (3, 16, 16, 20, False), (1, 5, 7, 25, False), (2, 96, 128, 100, False),
    (4, 64, 80, 10, True)])
def test_write_gif_bytes_equal(tmp_path, n, h, w, fps, smooth):
    frames = _frames(1, n, h, w, smooth)
    tviewer.write_gif(tmp_path / "t.gif", frames, fps=fps)
    jviewer.write_gif(tmp_path / "j.gif", frames, fps=fps)
    raw = (tmp_path / "t.gif").read_bytes()
    assert raw == (tmp_path / "j.gif").read_bytes()
    assert raw[:6] == b"GIF89a" and raw[-1:] == b"\x3b"
    assert struct.unpack("<HH", raw[6:10]) == (w, h)
    assert raw.count(b"\x21\xf9\x04\x04") >= n     # one GCE per frame


def test_gif_of_a_rendered_movie_tensor(tmp_path):
    """Frames as they leave render_movie: one uint8 tensor, to numpy."""
    rng = np.random.default_rng(2)
    pos = torch.from_numpy((rng.random((500, 2)) * 40).astype(np.float32))
    vel = torch.from_numpy((rng.standard_normal((500, 2)) * 200)
                           .astype(np.float32))
    frames = torch.stack([trender.to_uint8(trender.render_frame(
        pos + 3 * i, vel, torch.ones(500), torch.ones(500, dtype=torch.bool),
        width=48, height=40, speed_scale=1 / 300.0)) for i in range(3)])
    tviewer.write_gif(tmp_path / "t.gif", list(frames.numpy()))
    jviewer.write_gif(tmp_path / "j.gif", list(frames.numpy()))
    raw = (tmp_path / "t.gif").read_bytes()
    assert raw == (tmp_path / "j.gif").read_bytes() and len(raw) > 1000


def test_quantize_and_lzw_equal():
    frame = _frames(3, 1, 32, 32)[0]
    tidx, tpal = tviewer._quantize_frame(frame)
    jidx, jpal = jviewer._quantize_frame(frame)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(tpal, jpal)
    for data in (b"", b"\x00", bytes(range(256)) * 40, b"\x07" * 9000):
        assert tviewer._lzw_encode(data, 8) == jviewer._lzw_encode(data, 8)


def _viewport_walk(viewer):
    vp = viewer.Viewport(width=800, height=600, world_w=2400, world_h=800)
    seen = [vp.world_to_screen(100, 50)]
    vp.wheel_zoom(400, 300, +1)
    seen += [vp.zoom, vp.screen_to_world(400, 300)]
    vp.pan(10, 0)
    seen.append((vp.view_x, vp.view_y))
    vp.pan(-1e9, -1e9)
    seen.append((vp.view_x, vp.view_y))
    for direction in (+1, -1):
        for _ in range(100):
            vp.wheel_zoom(0, 0, direction)
        seen.append((vp.zoom, vp.view_x, vp.view_y))
    vp.pan(1e9, 1e9)
    seen.append((vp.view_x, vp.view_y))
    return vp, seen


def test_viewport_math():
    tvp, tseen = _viewport_walk(tviewer)
    jvp, jseen = _viewport_walk(jviewer)
    assert tseen == jseen
    assert dataclasses.asdict(tvp) == dataclasses.asdict(jvp)
    assert tseen[0] == (100, 50)
    assert tseen[1] == pytest.approx(1.1)
    assert tseen[2][0] == pytest.approx(400, abs=1e-6)  # anchor invariant
    assert tseen[3][0] > 0
    assert tseen[4] == (0.0, 0.0)
    assert tseen[5][0] <= 10.0 and tseen[6][0] >= 1.0   # zoom clamp x1..x10
    assert tseen[7] == (1600.0, 200.0)                  # clamped to the world


KEYS = (["Z"] * 100 + ["X"] * 100 + ["O"] * 100 + ["P"] * 200 + ["K"] * 200
        + ["L"] * 200 + ["Q"] * 100 + ["W"] * 100 + ["A"] * 200 + ["S"] * 200
        + ["d", " ", "space", "?"])
CHECKS = {100: ("theta", 0.2), 200: ("theta", 1.6), 300: ("dt", -0.05),
          500: ("dt", 0.05), 700: ("G", 0.0), 900: ("G", 100.0)}


def test_hud_key_bindings_clamps():
    thud, jhud = tviewer.Hud(), jviewer.Hud()
    tp, jp = tconfig.Params.default(), jconfig.Params.default()
    for i, key in enumerate(KEYS, 1):
        tp, jp = thud.adjust(tp, key), jhud.adjust(jp, key)
        assert isinstance(tp, tconfig.Params)
        for f in ("theta", "dt", "G"):
            assert getattr(tp, f) == pytest.approx(float(getattr(jp, f)),
                                                   abs=1e-6)
        if i in CHECKS:
            name, want = CHECKS[i]
            assert getattr(tp, name) == pytest.approx(want)
    assert dataclasses.asdict(thud) == dataclasses.asdict(jhud)
    assert thud.disk_r == 500.0 and thud.disk_n == 10000
    assert thud.show_tree and not thud.paused     # " " and "space" toggle
    tlines = thud.lines(tp, 123, 1.0, 60.0)
    assert len(tlines) == 13
    assert tlines == jhud.lines(jp, 123, 1.0, 60.0)
