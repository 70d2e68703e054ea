"""Device operations (kernels, memsets, copies) the traced slice ran, a
step."""

from nbody_bench import readers


def read(ctx):
    return readers.device_ops_per_step(ctx)
