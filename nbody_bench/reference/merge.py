"""The absorb rule.

After each step every alive body heavier than ``max_mass`` is a heavy. A
heavy absorbs every other alive body closer than ``min_dist``: the victim
dies and its mass goes to the heavy, which keeps its position and
velocity. A victim near several heavies goes to the lowest-index one, and
a heavy that is itself the victim of a lower-index heavy absorbs nothing.
``min_dist <= 0`` turns the rule off, and it never applies with fewer than
two bodies alive.
"""

from __future__ import annotations

import torch


def heavies(mass, alive, max_mass: float):
    """Indices of the heavies, ascending."""
    return torch.nonzero(alive & (mass > max_mass)).flatten()


def absorb(pos, mass, alive, max_mass: float, min_dist: float):
    """(mass, alive) after the rule."""
    if min_dist <= 0 or int(alive.sum()) < 2:
        return mass, alive
    h = heavies(mass, alive, max_mass)
    if h.numel() == 0:
        return mass, alive
    d = torch.linalg.norm(pos[:, None, :] - pos[h][None, :, :], dim=-1)
    body = torch.arange(pos.shape[0], device=pos.device)
    near = (d < min_dist) & alive[:, None] & (body[:, None] != h[None, :])
    big = pos.shape[0]

    def lowest(elig):
        return torch.where(elig, h[None, :], big).amin(dim=1)

    absorber = lowest(near)
    victim = absorber < big
    keeps = ~(victim[h] & (absorber[h] < h))
    absorber = lowest(near & keeps[None, :])
    victim = absorber < big
    gained = torch.zeros(big + 1, dtype=mass.dtype, device=mass.device)
    gained.index_add_(0, absorber, torch.where(victim, mass, 0.0))
    return torch.where(victim, 0.0, mass + gained[:big]), alive & ~victim
