"""Device operations (kernels, memcpys, memsets) per step, counted in the
profiled steps."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.ops:
        return None
    return len(t.ops) / t.steps
