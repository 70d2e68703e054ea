"""Host-side viewer: image/GIF capture, viewport, HUD.

Port of tpu_nbody.viewer, numpy and the standard library only. The
reference renders with a Swing panel (``NBodyPanel.kt:296-371``) and a GL
window (``gpu/GPU.kt:183-290``). A headless GPU server has neither; the
viewer consumes *rendered framebuffers* from
:mod:`tpu_nbody_torch.ops.render` as host uint8 arrays (per-body data never
leaves the device) and writes PNG/GIF files, byte for byte those of the JAX
package for the same frames. The matplotlib window of
``tpu_nbody_torch.examples.interactive`` provides live interaction with the
panel's key bindings.

Viewport math mirrors ``NBodyPanel.kt``:

* world->screen: screen = (world - view) * zoom  (lines 68-73)
* wheel zoom x1..x10 in steps of x1.1 anchored at the cursor (lines 180-196)
* arrow pan of 10 screen px (lines 270-280), camera clamped to world
  (lines 121-128)

Key-binding semantics (``setupKeys``, lines 237-287) are exposed as
:class:`Hud` methods with the exact clamp ranges, including the negative-dt
time reversal down to -0.05 (lines 256-257).
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

from tpu_nbody_torch.config import Params


# --------------------------------------------------------------- image IO
def write_png(path, rgb: np.ndarray):
    """Write an (H, W, 3) uint8 array as PNG (stdlib zlib only)."""
    rgb = np.asarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(tag, data):
        out = struct.pack(">I", len(data)) + tag + data
        return out + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def _quantize_frame(rgb: np.ndarray):
    """RGB -> (palette-index image, 256-color palette) via 3-3-2 bits."""
    r = (rgb[..., 0] >> 5).astype(np.uint16)
    g = (rgb[..., 1] >> 5).astype(np.uint16)
    b = (rgb[..., 2] >> 6).astype(np.uint16)
    idx = ((r << 5) | (g << 2) | b).astype(np.uint8)
    pal = np.zeros((256, 3), np.uint8)
    codes = np.arange(256, dtype=np.uint16)
    pal[:, 0] = ((codes >> 5) & 7) * 255 // 7
    pal[:, 1] = ((codes >> 2) & 7) * 255 // 7
    pal[:, 2] = (codes & 3) * 255 // 3
    return idx, pal


def _lzw_encode(data: bytes, min_code_size: int) -> bytes:
    """GIF-flavoured LZW (with CLEAR/EOI codes and 12-bit cap)."""
    clear = 1 << min_code_size
    eoi = clear + 1
    out = bytearray()
    cur = 0
    nbits = 0
    code_size = min_code_size + 1

    def emit(code, size):
        nonlocal cur, nbits
        cur |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(cur & 0xFF)
            cur >>= 8
            nbits -= 8

    table = {bytes([i]): i for i in range(clear)}
    next_code = eoi + 1
    emit(clear, code_size)
    s = b""
    for ch in data:
        sc = s + bytes([ch])
        if sc in table:
            s = sc
        else:
            emit(table[s], code_size)
            table[sc] = next_code
            next_code += 1
            if next_code > (1 << code_size) and code_size < 12:
                code_size += 1
            elif next_code >= 4096:
                emit(clear, code_size)
                table = {bytes([i]): i for i in range(clear)}
                next_code = eoi + 1
                code_size = min_code_size + 1
            s = bytes([ch])
    if s:
        emit(table[s], code_size)
    emit(eoi, code_size)
    if nbits:
        out.append(cur & 0xFF)
    return bytes(out)


def write_gif(path, frames, fps: int = 25):
    """Write a list of (H, W, 3) uint8 frames as an animated GIF (stdlib).

    Replaces the reference's ``collide.gif`` demo capture (README.md:3).
    """
    frames = [np.asarray(f, np.uint8) for f in frames]
    h, w, _ = frames[0].shape
    delay = max(2, round(100 / fps))
    with open(path, "wb") as f:
        f.write(b"GIF89a")
        f.write(struct.pack("<HHBBB", w, h, 0xF7, 0, 0))  # GCT 256 entries
        idx0, pal = _quantize_frame(frames[0])
        f.write(pal.tobytes())
        # loop forever
        f.write(b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")
        for fr in frames:
            idx, _ = _quantize_frame(fr)
            f.write(b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00")
            f.write(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
            f.write(b"\x08")  # LZW min code size
            payload = _lzw_encode(idx.tobytes(), 8)
            for i in range(0, len(payload), 255):
                blk = payload[i:i + 255]
                f.write(bytes([len(blk)]) + blk)
            f.write(b"\x00")
        f.write(b"\x3b")


# ---------------------------------------------------------------- viewport
@dataclasses.dataclass
class Viewport:
    """Pan/zoom camera with the Swing panel's exact semantics."""
    width: int
    height: int
    world_w: float
    world_h: float
    zoom: float = 1.0
    view_x: float = 0.0
    view_y: float = 0.0
    zoom_min: float = 1.0
    zoom_max: float = 10.0
    zoom_step: float = 1.1
    pan_step_screen: float = 10.0

    def world_to_screen(self, wx, wy):
        return (wx - self.view_x) * self.zoom, (wy - self.view_y) * self.zoom

    def screen_to_world(self, sx, sy):
        return self.view_x + sx / self.zoom, self.view_y + sy / self.zoom

    def clamp(self):
        vis_w = self.width / self.zoom
        vis_h = self.height / self.zoom
        self.view_x = min(max(self.view_x, 0.0), max(self.world_w - vis_w, 0.0))
        self.view_y = min(max(self.view_y, 0.0), max(self.world_h - vis_h, 0.0))

    def wheel_zoom(self, sx, sy, direction: int):
        """direction > 0 zooms in, anchored at screen point (sx, sy)."""
        wx, wy = self.screen_to_world(sx, sy)
        factor = self.zoom_step if direction > 0 else 1.0 / self.zoom_step
        new_zoom = min(max(self.zoom * factor, self.zoom_min), self.zoom_max)
        if new_zoom != self.zoom:
            self.view_x = wx - sx / new_zoom
            self.view_y = wy - sy / new_zoom
            self.zoom = new_zoom
            self.clamp()

    def pan(self, dx_screen, dy_screen):
        self.view_x += dx_screen / self.zoom
        self.view_y += dy_screen / self.zoom
        self.clamp()


# --------------------------------------------------------------------- HUD
@dataclasses.dataclass
class Hud:
    """Live-tunable UI parameters with the panel's exact clamp ranges."""
    disk_r: float = 100.0       # Q/W: 100..500 step 10
    disk_n: int = 5000          # A/S: 1000..10000 step 100
    show_tree: bool = False     # D
    paused: bool = False        # SPACE

    def adjust(self, params: Params, key: str) -> Params:
        """Apply one key binding; returns the new Params."""
        key = key.upper()
        if key == "Z":
            return params.replace(theta=max(float(params.theta) - 0.05, 0.2))
        if key == "X":
            return params.replace(theta=min(float(params.theta) + 0.05, 1.6))
        if key == "O":
            return params.replace(dt=max(float(params.dt) - 0.001, -0.05))
        if key == "P":
            return params.replace(dt=min(float(params.dt) + 0.001, 0.05))
        if key == "K":
            return params.replace(G=max(float(params.G) - 1.0, 0.0))
        if key == "L":
            return params.replace(G=min(float(params.G) + 1.0, 100.0))
        if key == "Q":
            self.disk_r = max(self.disk_r - 10.0, 100.0)
        elif key == "W":
            self.disk_r = min(self.disk_r + 10.0, 500.0)
        elif key == "A":
            self.disk_n = max(self.disk_n - 100, 1000)
        elif key == "S":
            self.disk_n = min(self.disk_n + 100, 10000)
        elif key == "D":
            self.show_tree = not self.show_tree
        elif key == " " or key == "SPACE":
            self.paused = not self.paused
        return params

    def lines(self, params: Params, n_bodies: int, zoom: float, fps: float):
        """The 13 HUD strings (``NBodyPanel.kt:347-368``)."""
        import math
        return [
            "SPACE - pause | R - reset scene | LMB DRAG - add galaxy disk | "
            "ARROWS - cam movement | ESC - exit",
            f"Disk radius [Q/W] = {self.disk_r}",
            f"Bodies count [A/S] = {self.disk_n}",
            f"Theta [Z/X] = {float(params.theta):.2f}",
            f"Delta time [O/P] = {float(params.dt):.3f}",
            f"Gravity [K/L] = {float(params.G):.1f}",
            f"Debug mode [D] = {self.show_tree}",
            f"Zoom [WHEEL] = {zoom:.2f}",
            f"Bodies count = {n_bodies}",
            f"Softening = {math.sqrt(float(params.soft2)):.2f}",
            "Create bodies cloud [C]",
            "Create black hole [RMB DRAG]",
            f"FPS: {fps:.1f}",
        ]
