"""Host ms a step that the engine spends enqueueing, from its own call
records of the window's calls that the profiler did not see: Σ(start of
the stats read − entry) over Σ steps. Free of CUPTI's cost."""

from nbody_bench import spans


def read(ctx):
    return spans.host_ms_per_step(spans.window_calls(ctx), "t_enter",
                                  "t_sync_start")
