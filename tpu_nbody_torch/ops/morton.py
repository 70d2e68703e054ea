"""Hilbert and Morton sort keys over the root quad (port of
tpu_nbody.ops.morton).

Each body gets a 30-bit Hilbert index of its cell on the 2^15 x 2^15 grid
over the root quad. The P3M path sorts bodies by it so that fixed-size
blocks of consecutive bodies are spatially compact, and the Barnes–Hut tree
is a pure function of the sorted codes (every aligned quadtree cell at
level l is a contiguous range of 4^(15-l) codes). All integer work is
int32, as in the JAX package, and the codes are bit-equal to its codes for
the same float32 positions.
"""

from __future__ import annotations

import torch

COORD_BITS = 15
CODE_BITS = 2 * COORD_BITS  # 30
MAX_COORD = (1 << COORD_BITS) - 1
# Sentinel code for dead bodies: sorts after every valid 30-bit code.
DEAD_CODE = 1 << CODE_BITS


def part1by1(x):
    """Spread the low 15 bits of ``x`` so bit i lands at position 2i."""
    x = torch.as_tensor(x).to(torch.int32) & 0x7FFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def compact1by1(x):
    """Inverse of :func:`part1by1`: gather the even bits of ``x``."""
    x = torch.as_tensor(x).to(torch.int32) & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    x = (x | (x >> 8)) & 0x0000FFFF
    return x


def encode2d(ix, iy):
    """Interleave two 15-bit ints into a 30-bit Morton code (x = even bits)."""
    return part1by1(ix) | (part1by1(iy) << 1)


def decode2d(code):
    code = torch.as_tensor(code).to(torch.int32)
    return compact1by1(code), compact1by1(code >> 1)


def hilbert2d(ix, iy):
    """Hilbert-curve index of 15-bit cell coordinates (30-bit result).

    The standard xy->d loop (Wikipedia "Hilbert curve", public domain
    algorithm), vectorized over bodies.
    """
    x = ix.to(torch.int32)
    y = iy.to(torch.int32)
    d = torch.zeros_like(x)
    for i in range(COORD_BITS):
        s = 1 << (COORD_BITS - 1 - i)
        rx = ((x & s) > 0).to(torch.int32)
        ry = ((y & s) > 0).to(torch.int32)
        d = d + s * s * ((3 * rx) ^ ry)
        # rotate quadrant
        swap = ry == 0
        flip = swap & (rx == 1)
        xf = torch.where(flip, s - 1 - x, x)
        yf = torch.where(flip, s - 1 - y, y)
        x, y = torch.where(swap, yf, xf), torch.where(swap, xf, yf)
    return d


def hilbert2d_inverse(d):
    """Cell coordinates of a 30-bit Hilbert index (inverse of hilbert2d)."""
    t = torch.as_tensor(d).to(torch.int32)
    x = torch.zeros_like(t)
    y = torch.zeros_like(t)
    for i in range(COORD_BITS):
        s = 1 << i
        rx = 1 & (t >> 1)
        ry = 1 & (t ^ rx)
        # rotate quadrant
        swap = ry == 0
        flip = swap & (rx == 1)
        xf = torch.where(flip, s - 1 - x, x)
        yf = torch.where(flip, s - 1 - y, y)
        x, y = torch.where(swap, yf, xf), torch.where(swap, xf, yf)
        x, y, t = x + s * rx, y + s * ry, t >> 2
    return x, y


def cell_coords(pos, origin, side):
    """Integer cell coordinates of positions on the 2^15 grid over the root.

    Out-of-root bodies clamp to edge cells. ``origin`` is a pair of floats
    (or a tensor) and ``side`` a float; the scale is applied as a float32
    multiply, exactly as the JAX package does it.
    """
    scale = (1 << COORD_BITS) / float(side)
    org = torch.as_tensor(origin, dtype=pos.dtype, device=pos.device)
    ij = torch.floor((pos - org) * scale).to(torch.int32)
    return torch.clamp(ij, 0, MAX_COORD)


def morton_codes(pos, origin, side, alive=None):
    """Z-order body key; dead bodies get :data:`DEAD_CODE`."""
    ij = cell_coords(pos, origin, side)
    codes = encode2d(ij[..., 0], ij[..., 1])
    if alive is not None:
        codes = torch.where(alive, codes, DEAD_CODE)
    return codes


def hilbert_codes(pos, origin, side, alive=None):
    """Default body sort key; dead bodies get :data:`DEAD_CODE`."""
    ij = cell_coords(pos, origin, side)
    codes = hilbert2d(ij[..., 0], ij[..., 1])
    if alive is not None:
        codes = torch.where(alive, codes, DEAD_CODE)
    return codes
