"""Seconds from the process's start to the window's start: imports, the
CUDA context, the kernel library's load (or first build), the scene, the
configuration's set-up and the warm-up."""


def read(ctx):
    return ctx.setup_s
