"""tpu_nbody_torch: the PyTorch and CUDA port of tpu_nbody.

Same module layout and function names as :mod:`tpu_nbody`, so each ported
function sits at the same path as its JAX counterpart. The port runs the
2D engine's Barnes–Hut, P3M and exact all-pairs solvers with the kdk,
kdk_reuse and euler integrators and every P3M knob on one NVIDIA Hopper
card; the two Pallas kernels of the JAX package are hand-written CUDA C++
under ``csrc/``. 3D is not carried yet and raises ``NotImplementedError``
with a pointer to ``ROADMAP.md``. This package never imports jax.
"""

from tpu_nbody_torch.config import Params, SimConfig
from tpu_nbody_torch.state import (SimState, concat_bodies, empty_state,
                                   from_arrays)

__all__ = [
    "Params",
    "SimConfig",
    "SimState",
    "concat_bodies",
    "empty_state",
    "from_arrays",
]

__version__ = "0.1.0"
