"""Device idle ms a traced frame that falls in the phases of
``render_frame`` and ``to_uint8``: each idle gap goes to the program
phase that holds its middle."""

from nbody_bench import spans


def read(ctx):
    return spans.idle_ms(ctx, ("render",), ctx.window.slice_calls)
