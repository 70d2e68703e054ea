"""A plain P3M solver of softened gravity, float64 by default.

The pair force G m (x_j − x_i) / (r² + ε²)^{3/2} is split by the weight
w(r) = (1 − r²/rc²)⁴ (0 past rc): the short range w·F is summed over the
pairs within rc with a cell list, the long range (1 − w)·F on a mesh:
cloud-in-cell (CIC) deposit onto cells of side ``h``, a zero-padded FFT
convolution with the sampled long-range force kernel, sharpened by the
inverse square of the CIC window, and CIC interpolation back to the
bodies. Deposit and interpolation share one assignment and the kernel is
odd, so a body exerts no force on itself. Only bodies with mass exert or
receive a force (the rest get 0). The grid covers their bounding box at
each pass and is padded to twice its extent (rounded up to a size of
factors 2, 3 and 5), so no body leaves it and no image interacts.

Used for the trajectories of every body over a call; sampled bodies get
exact forces from :mod:`.gravity`. Its accuracy against the direct sum
is a test (``nbody_bench/tests/test_nbb_reference.py``).
"""

from __future__ import annotations

import torch

MARGIN = 3                  # cells between the bodies and the grid's edge
PAIR_CHUNK = 1 << 25        # candidate pairs a short-range chunk holds
HATS_KEPT = 2               # grid shapes whose kernels stay cached


def _smooth(n: int) -> int:
    """The least m >= n whose only prime factors are 2, 3 and 5."""
    m = max(int(n), 1)
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


def _wrapped(n: int, dtype, device):
    i = torch.arange(n, device=device)
    return torch.where(i <= n // 2, i, i - n).to(dtype)


def cell_pairs(pos, rc: float, chunk: int | None = None):
    """Candidate pairs of a cell list of cells of side ``rc``: yields
    ``(order, i, j, first, bodies)`` chunks, ``i`` and ``j`` positions in
    ``order`` (the bodies sorted by cell), every (i, j) with j in the 3 x 3
    cells around i's cell, i == j included; ``bodies`` are the chunk's
    ``i`` values, each once, whose pairs start at ``first`` in the chunk
    (consecutive, possibly none). Cells are found by binary search on the
    sorted keys, so far-off bodies cost nothing."""
    chunk = chunk or PAIR_CHUNK
    dev, n = pos.device, pos.shape[0]
    if n == 0:
        return
    c = torch.floor((pos - pos.min(dim=0).values) / rc).to(torch.int64)
    width = int(c[:, 0].max()) + 3
    key, order = torch.sort((c[:, 1] + 1) * width + c[:, 0] + 1)
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            nk = key + oy * width + ox
            st = torch.searchsorted(key, nk)
            cnt = torch.searchsorted(key, nk, right=True) - st
            b0 = 0
            while b0 < n:
                csum = torch.cumsum(cnt[b0:], 0)
                b1 = b0 + max(1, int(torch.searchsorted(
                    csum, torch.tensor(chunk, device=dev), right=True)))
                cc = cnt[b0:b1]
                tot = int(csum[b1 - b0 - 1])
                if tot:
                    i = torch.repeat_interleave(
                        torch.arange(b0, b1, device=dev), cc,
                        output_size=tot)
                    first = torch.cumsum(cc, 0) - cc
                    j = st[i] + torch.arange(tot, device=dev) - first[i - b0]
                    yield order, i, j, first, torch.arange(b0, b1,
                                                           device=dev)
                b0 = b1


class P3M:
    """Long-range kernels for cells of side ``h`` and a short-range
    cutoff ``rc``; ``dtype`` is the working precision (the FFT runs in
    float32 for a precision below it, which torch cannot transform)."""

    def __init__(self, h: float, rc: float, soft2: float, G: float,
                 dtype=torch.float64, device="cpu"):
        self.h, self.rc, self.soft2, self.G = h, rc, soft2, G
        self.dtype = dtype
        self.fft_dtype = (dtype if dtype in (torch.float32, torch.float64)
                          else torch.float32)
        self.device = torch.device(device)
        self._hats = {}

    def hats(self, py: int, px: int):
        """rfft2 of the sampled long-range force kernel (x and y) on the
        (py, px) padded grid, divided by the CIC window squared."""
        key = (py, px)
        if key in self._hats:
            return self._hats[key]
        while len(self._hats) >= HATS_KEPT:
            self._hats.pop(next(iter(self._hats)))
        ft, dev, h = self.fft_dtype, self.device, self.h
        dx = (_wrapped(px, ft, dev) * h)[None, :]
        dy = (_wrapped(py, ft, dev) * h)[:, None]
        r2 = dx * dx + dy * dy
        w = torch.clamp(1.0 - r2 / (self.rc * self.rc), min=0.0) ** 4
        f = (1.0 - w) * torch.rsqrt(r2 + self.soft2) / (r2 + self.soft2)
        kx = torch.fft.rfft2(-dx * f)
        ky = torch.fft.rfft2(-dy * f)
        qx = torch.arange(px // 2 + 1, device=dev).to(ft) / px
        qy = _wrapped(py, ft, dev) / py
        win = (torch.sinc(qx)[None, :] * torch.sinc(qy)[:, None]) ** 2
        sharpen = 1.0 / torch.clamp(win * win, min=1e-6)
        self._hats[key] = (kx * sharpen, ky * sharpen)
        return self._hats[key]

    def long_range(self, pos, mass):
        """(n, 2) mesh accelerations / G of the bodies."""
        ft, h = self.fft_dtype, self.h
        p = pos.to(ft)
        lo = torch.floor(p.min(dim=0).values / h) - MARGIN
        hi = torch.floor(p.max(dim=0).values / h) + MARGIN
        ex, ey = (int(v) + 1 for v in (hi - lo).tolist())
        px, py = _smooth(2 * ex), _smooth(2 * ey)
        u = p / h - lo - 0.5                    # cell-centre coordinates
        b = torch.floor(u)
        f = u - b
        b = b.to(torch.int64)
        taps = [(0, 0), (1, 0), (0, 1), (1, 1)]
        wts = [(1 - f[:, 0]) * (1 - f[:, 1]), f[:, 0] * (1 - f[:, 1]),
               (1 - f[:, 0]) * f[:, 1], f[:, 0] * f[:, 1]]
        idx = [(b[:, 1] + oy) * px + (b[:, 0] + ox) for ox, oy in taps]
        m = mass.to(ft)
        rho = torch.zeros(py * px, dtype=ft, device=p.device)
        for i, w in zip(idx, wts):
            rho.index_add_(0, i, m * w)
        rh = torch.fft.rfft2(rho.view(py, px))
        kx, ky = self.hats(py, px)
        gx = torch.fft.irfft2(rh * kx, s=(py, px)).reshape(-1)
        gy = torch.fft.irfft2(rh * ky, s=(py, px)).reshape(-1)
        ax = sum(gx[i] * w for i, w in zip(idx, wts))
        ay = sum(gy[i] * w for i, w in zip(idx, wts))
        return torch.stack([ax, ay], dim=1).to(self.dtype)

    def short_range(self, pos, mass):
        """(n, 2) accelerations / G of the pairs within ``rc``, weighted
        by w(r). A body's pairs are consecutive in a chunk, so their sum
        is a difference of the chunk's running sums (no atomics)."""
        p, m = pos.to(self.dtype), mass.to(self.dtype)
        acc = torch.zeros_like(p)
        rc2 = self.rc * self.rc
        for order, i, j, first, bodies in cell_pairs(p, self.rc):
            pi, pj = p[order[i]], p[order[j]]
            d = pj - pi
            r2 = (d * d).sum(dim=1)
            w = torch.clamp(1.0 - r2 / rc2, min=0.0) ** 4
            s = r2 + self.soft2
            f = m[order[j]] * w * torch.rsqrt(s) / s
            ends = torch.cat([first[1:], first.new_tensor([i.shape[0]])])
            for k in range(2):
                # a 1-D running sum: torch scans 1-D tensors in parallel,
                # but one long row of a 2-D tensor almost serially
                run = torch.cumsum(d[:, k] * f, dim=0)
                run = torch.cat([run.new_zeros(1), run])
                acc[:, k].index_add_(0, order[bodies],
                                     run[ends] - run[first])
        return acc

    def accel(self, pos, mass):
        """(n, 2) accelerations of every body: bodies without mass (the
        dead) neither exert nor receive a force."""
        live = torch.nonzero(mass > 0).flatten()
        out = torch.zeros(pos.shape, dtype=self.dtype, device=pos.device)
        if live.numel():
            p, m = pos[live], mass[live]
            out[live] = self.G * (self.long_range(p, m)
                                  + self.short_range(p, m))
        return out
