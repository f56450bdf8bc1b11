"""Seconds from the process's start to the window's first step: imports,
the kernels' load (and build, on a checkout's first run), weights, traffic,
the program's set-up and the warm steps."""


def read(ctx):
    return ctx.setup_s
