"""Exact softened gravity by direct summation, in 2D or 3D.

a_i = G Σ_j m_j (x_j − x_i) / (|x_j − x_i|² + ε²)^{3/2}

over every source j but the target itself, and dead sources carry mass
0.
"""

from __future__ import annotations

import torch

BLOCK_ELEMS = 1 << 25       # target x source pairs a block holds


def direct_accel(tpos, spos, smass, G: float, soft2: float, self_idx=None,
                 dtype=torch.float64, block_elems: int = BLOCK_ELEMS):
    """(len tpos, D) accelerations of the targets ``tpos`` from the
    sources ``spos`` of masses ``smass``, D = 2 or 3 the positions'
    width, computed in ``dtype`` in blocks of targets. ``self_idx`` gives
    each target's own index among the
    sources, left out of its sum (the source may hold the same body at a
    slightly other position).

    With w_ij = m_j / (|x_j − x_i|² + ε²)^{3/2}, a_i = G (Σ_j w_ij x_j −
    x_i Σ_j w_ij): two products of the (targets, sources) weights with the
    sources, the squared distances taken directly (not from a product, so
    close pairs lose no digits)."""
    tp = tpos.to(dtype)
    sp = spos.to(dtype)
    sm = smass.to(dtype)
    n_s = sp.shape[0]
    tb = max(1, block_elems // max(n_s, 1))
    out = torch.empty(tp.shape, dtype=dtype, device=tp.device)
    for i in range(0, tp.shape[0], tb):
        t = tp[i:i + tb]
        w = torch.square(sp[None, :, 0] - t[:, 0:1])
        for d in range(1, tp.shape[1]):
            w += torch.square(sp[None, :, d] - t[:, d:d + 1])
        w += soft2
        w.pow_(-1.5).mul_(sm[None, :])
        if self_idx is not None:
            rows = torch.arange(t.shape[0], device=tp.device)
            w[rows, self_idx[i:i + tb]] = 0.0
        out[i:i + tb] = w @ sp - w.sum(dim=1, keepdim=True) * t
    return out * G
