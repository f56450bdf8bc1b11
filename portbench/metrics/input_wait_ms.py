"""Host milliseconds a step waits in the feed for its device batch, the
mean over every step of the timed window (the benchmark's span around the
program's ``next()``: the Cloze batcher, ``to_device``, the prefetch)."""


def read(ctx):
    w = ctx.window
    return 1e3 * w.wait_s / w.steps
