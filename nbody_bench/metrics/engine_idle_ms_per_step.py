"""Device idle ms a step in the traced slice that falls in the engine's
own phases (hats, sort, kicks, merge, re-sort, unsort, stats): each idle
gap goes to the program phase that holds its middle."""

from nbody_bench import spans


def read(ctx):
    return spans.idle_ms(ctx, ("engine",), spans.steps_in_slice(ctx))
