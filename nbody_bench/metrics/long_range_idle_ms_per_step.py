"""Device idle ms a step in the traced slice that falls in the long
range's phases (deposit, fft, fd, interp): each idle gap goes to the
program phase that holds its middle."""

from nbody_bench import spans


def read(ctx):
    return spans.idle_ms(ctx, ("long range",), spans.steps_in_slice(ctx))
