"""The device's idle share of the traced slice: 1 - (the union of its
operations' spans) / (the slice's host time), in %."""

from nbody_bench import readers


def read(ctx):
    return readers.idle_pct(ctx)
