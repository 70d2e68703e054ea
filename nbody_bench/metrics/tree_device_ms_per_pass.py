"""Device ms a Barnes-Hut pass of the operations launched in the tree's
``build`` phases, over the ``build`` marks in the traced slice; each
launch is matched with its device operation in stream order."""

from nbody_bench import spans


def read(ctx):
    return spans.device_ms_per_pass(ctx, "tree")
