"""Mass-threshold merge ("absorb") rule on the device (port of
tpu_nbody.ops.merge).

Reference semantics (``BarnesHutAlg.kt:463-532``): after each step every
body with ``m > merge_max_mass`` absorbs all bodies within
``merge_min_dist`` (<= 0 disables); the absorber gains the victims' mass and
keeps its position and velocity. Heavy candidates are compressed to the
top ``heavy_cap`` by mass; a victim's absorber is the lowest-index heavy
near it, and a second round drops absorbers that are themselves victims of
a lower-index heavy. ``heavy_need`` counts the qualifying heavies so the
engine can grow ``heavy_cap`` when it overflows. Deviations from the
sequential reference are those documented in ``tpu_nbody/ops/merge.py``.
"""

from __future__ import annotations

import torch

from tpu_nbody_torch.state import SimState


def merge_bodies(state: SimState, params,
                 heavy_cap: int = 64) -> tuple[SimState, torch.Tensor]:
    """Apply the absorb rule. Returns (state, heavy_need).

    Runs without a host sync: whether merging applies this step (at least
    two bodies alive) is decided on the device with ``torch.where``.
    """
    cap = state.capacity
    heavy_cap = min(heavy_cap, cap)
    heavy = state.alive & (state.mass > params.merge_max_mass)
    heavy_need = heavy.sum(dtype=torch.int32)
    if params.merge_min_dist <= 0:
        return state, torch.zeros_like(heavy_need)

    md2 = params.merge_min_dist * params.merge_min_dist
    # Compress heavies to heavy_cap slots, keeping the heaviest. Which slot
    # a heavy lands in does not matter: absorbers resolve by body index.
    key = torch.where(heavy, state.mass, float("-inf"))
    _, hidx = torch.topk(key, heavy_cap)
    hvalid = heavy[hidx]
    hidx = torch.where(hvalid, hidx, cap)    # park invalid at sentinel
    hpos = state.pos[torch.clamp(hidx, 0, cap - 1)]

    d = state.pos[:, None, :] - hpos[None, :, :]          # (cap, H, dim)
    close = torch.sum(d * d, dim=-1) < md2
    body_idx = torch.arange(cap, device=state.pos.device)
    eligible = (close & hvalid[None, :] & state.alive[:, None]
                & (body_idx[:, None] != hidx[None, :]))

    def lowest_absorber(elig):
        return torch.where(elig, hidx[None, :], cap).amin(dim=1)

    # Round 1: absorber(j) = lowest-index heavy near j.
    absorber = lowest_absorber(eligible)
    is_victim = absorber < cap
    # Round 2: a heavy that is itself a victim of a LOWER-index heavy never
    # scans; drop it from the absorber set and re-resolve.
    absorbed_by_lower = is_victim & (absorber < body_idx)
    still_absorber = hvalid & ~absorbed_by_lower[torch.clamp(hidx, 0, cap - 1)]
    absorber = lowest_absorber(eligible & still_absorber[None, :])
    is_victim = absorber < cap

    gained = torch.zeros((cap + 1,), dtype=state.mass.dtype,
                         device=state.mass.device).index_add_(
        0, absorber, torch.where(is_victim, state.mass, 0.0))[:cap]
    merged = state._replace(mass=torch.where(is_victim, 0.0,
                                             state.mass + gained),
                            alive=state.alive & ~is_victim)
    enabled = state.n_alive() > 1
    out = state._replace(mass=torch.where(enabled, merged.mass, state.mass),
                         alive=torch.where(enabled, merged.alive,
                                           state.alive))
    return out, torch.where(enabled, heavy_need, 0)
