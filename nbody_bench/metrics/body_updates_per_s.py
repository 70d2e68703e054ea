"""Body-updates completed over the window: the alive bodies at each
call's start times its steps, summed over the window's calls, over the
window's seconds (the segment restores and every gap between calls
included)."""

from nbody_bench import stats


def read(ctx):
    w = ctx.window
    return stats.rate(w.body_updates, w.seconds)
