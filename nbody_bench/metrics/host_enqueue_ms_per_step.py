"""Host ms from each traced call's start to the end of the CUDA runtime
call that launched its last device operation, summed over the slice, a
step: the engine's enqueue."""

from nbody_bench import readers


def read(ctx):
    return readers.enqueue_ms_per_step(ctx)
