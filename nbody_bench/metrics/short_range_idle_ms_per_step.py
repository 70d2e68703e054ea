"""Device idle ms a step in the traced slice that falls in the short
range's phases (band, select, rescue): each idle gap goes to the program
phase that holds its middle."""

from nbody_bench import spans


def read(ctx):
    return spans.idle_ms(ctx, ("short range",), spans.steps_in_slice(ctx))
