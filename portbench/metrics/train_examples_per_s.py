"""Examples trained per second: every example of the window over the
window's whole wall time (it ends in a device synchronise)."""


def read(ctx):
    w = ctx.window
    return w.steps * w.batch / w.seconds
