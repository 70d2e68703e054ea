from tpu_nbody_torch.models import scenes  # noqa: F401
