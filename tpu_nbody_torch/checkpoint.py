"""Checkpoint / resume in the JAX package's ``.npz`` format, unchanged:
``pos``, ``vel``, ``mass``, ``alive``, ``step`` and ``params`` (the six
:class:`Params` fields in order), plus any extra arrays. Files written by
``tpu_nbody.checkpoint.save`` load here and the other way round."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_nbody_torch import convert
from tpu_nbody_torch.config import Params
from tpu_nbody_torch.state import SimState

_PARAM_FIELDS = [f.name for f in dataclasses.fields(Params)]
_STATE_KEYS = {"pos", "vel", "mass", "alive", "step", "params"}


def save(path, state: SimState, params: Params, **extra):
    np.savez_compressed(
        path,
        pos=state.pos.cpu().numpy(),
        vel=state.vel.cpu().numpy(),
        mass=state.mass.cpu().numpy(),
        alive=state.alive.cpu().numpy(),
        step=state.step.cpu().numpy(),
        params=np.asarray([getattr(params, f) for f in _PARAM_FIELDS],
                          np.float32),
        **extra,
    )


def load(path, dtype=torch.float32, device="cuda"):
    """Returns ``(state, params, extra)`` with the state on ``device``;
    raises when ``device`` is CUDA and there is no card."""
    with np.load(path) as z:
        state = convert.state_from_numpy(z["pos"], z["vel"], z["mass"],
                                         z["alive"], z["step"], device,
                                         dtype=dtype)
        params = convert.params_from_numpy(z["params"])
        extra = {k: z[k] for k in z.files if k not in _STATE_KEYS}
    return state, params, extra
