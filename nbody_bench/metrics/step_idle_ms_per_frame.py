"""Device idle ms a traced frame that falls in the phases of
``Engine.step`` (every layer but the render's): each idle gap goes to the
program phase that holds its middle."""

from nbody_bench import spans


def read(ctx):
    return spans.idle_ms(ctx, spans.STEP_LAYERS, ctx.window.slice_calls)
