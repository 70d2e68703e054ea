"""Frames completed (step, render, copy to the host) over the window's
seconds: the viewer's FPS."""

from nbody_bench import stats


def read(ctx):
    w = ctx.window
    return stats.rate(w.calls, w.seconds)
