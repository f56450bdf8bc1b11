"""Percent of the timed window's wall time in which no device operation
ran: one less the device's busy time per step, from the trace of the
profiled steps, over the wall time per step of the untraced window (so the
profiler's own host cost stays out of it)."""


def read(ctx):
    t, w = ctx.trace, ctx.window
    if t is None or not t.ops:
        return None
    return 100.0 * (1.0 - (t.busy_s() / t.steps) / (w.seconds / w.steps))
