"""Device ms a Barnes-Hut pass of the operations launched in the
``evaluate`` and ``assemble`` phases, over the ``build`` marks in the
traced slice."""

from nbody_bench import spans


def read(ctx):
    return spans.device_ms_per_pass(ctx, "evaluate")
