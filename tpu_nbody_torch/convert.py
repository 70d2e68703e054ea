"""Carry state and parameters across from the JAX package.

The JAX package's ``SimState`` and ``Params`` converted to numpy arrays
(``np.asarray`` on each field) become the port's here, so both packages can
be fed the same bodies. N-body has no weights; this is all the state there
is.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_nbody_torch.config import Params
from tpu_nbody_torch.state import SimState


def state_from_numpy(pos, vel, mass, alive, step, device="cpu",
                     dtype=torch.float32) -> SimState:
    """A :class:`SimState` on ``device`` from the five state arrays."""
    def t(x, dt):
        return torch.as_tensor(np.array(x), device=device).to(dt)

    return SimState(pos=t(pos, dtype), vel=t(vel, dtype),
                    mass=t(mass, dtype), alive=t(alive, torch.bool),
                    step=t(step, torch.int32).reshape(()))


def params_from_numpy(values) -> Params:
    """:class:`Params` from the six values in field order (G, dt, theta,
    soft2, merge_max_mass, merge_min_dist), as the JAX package's
    ``np.asarray(list(params))`` or its checkpoint's ``params`` array."""
    v = np.asarray(values, np.float64).reshape(-1)
    names = [f.name for f in dataclasses.fields(Params)]
    if v.shape[0] != len(names):
        raise ValueError(f"expected {len(names)} values, got {v.shape[0]}")
    return Params(**{n: float(x) for n, x in zip(names, v)})
