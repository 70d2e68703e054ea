"""tpu_nbody_torch: the PyTorch and CUDA port of tpu_nbody.

Same module layout and function names as :mod:`tpu_nbody`, so each ported
function sits at the same path as its JAX counterpart. The port runs the
P3M main path (``solver="pm"``, ``integrator="kdk_reuse"``, persistent
Hilbert-sorted state) on one NVIDIA Hopper card; the two Pallas kernels of
the JAX package are hand-written CUDA C++ under ``csrc/``. Knobs the port
does not carry yet raise ``NotImplementedError`` with a pointer to
``ROADMAP.md``. This package never imports jax.
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
