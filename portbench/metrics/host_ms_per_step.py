"""Host milliseconds inside the program's step call (its enqueue, with no
synchronise of the benchmark's), the mean over every step of the timed
window."""


def read(ctx):
    w = ctx.window
    return 1e3 * w.host_s / w.steps
