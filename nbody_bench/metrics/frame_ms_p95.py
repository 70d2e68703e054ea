"""The 95th percentile of the host-clock time of every frame of the
window, in ms: the stutter a viewer sees."""

from nbody_bench import readers


def read(ctx):
    return readers.quantile([1e3 * d for d in ctx.window.durations], 95)
