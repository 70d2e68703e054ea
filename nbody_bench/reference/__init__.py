"""Plain reference of the benchmark's correctness check.

Plain PyTorch, float64 by default, written from the physics and the
documented rules alone: it imports nothing of the program under test and
takes nothing the program made but the states it judges.

* :mod:`.gravity` — exact softened gravity by direct summation.
* :mod:`.p3m` — a plain particle-particle/particle-mesh solver (CIC, a
  sampled long-range force kernel, a cell-list short range) for the
  trajectories of every body.
* :mod:`.merge` — the absorb rule.
* :mod:`.follow` — kick-drift-kick with a carried acceleration over a
  call's steps: sampled bodies under exact forces, every body under the
  plain P3M.
* :mod:`.render` — the point splat of a frame.
"""
