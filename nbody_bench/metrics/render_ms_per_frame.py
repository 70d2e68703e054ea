"""Mean device ms of the harness's own render_frame + to_uint8 call over
the traced frames, by CUDA events around it."""

from nbody_bench import readers


def read(ctx):
    return readers.mean_ms(ctx.render_ms)
