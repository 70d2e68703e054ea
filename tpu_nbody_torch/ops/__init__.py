from tpu_nbody_torch.ops import (  # noqa: F401
    band,
    diagnostics,
    forces,
    integrate,
    merge,
    mesh,
    morton,
)
