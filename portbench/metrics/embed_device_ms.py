"""Device milliseconds per profiled step of the embedding: the operations,
forward and backward, whose innermost program span is ``b4cp.embed`` (the
item lookup and its gradient, positions, the padding bias), in the trace
without frames."""

from portbench.harness import spans


def read(ctx):
    return spans.device_ms_per_step(ctx.trace, "b4cp.embed")
