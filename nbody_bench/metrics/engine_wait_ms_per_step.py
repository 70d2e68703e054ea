"""Host ms a step that the engine waits on the card in its one host sync
(the stats read), from its call records of the window's calls that the
profiler did not see: Σ(end − start of the read) over Σ steps."""

from nbody_bench import spans


def read(ctx):
    return spans.host_ms_per_step(spans.window_calls(ctx), "t_sync_start",
                                  "t_sync_end")
