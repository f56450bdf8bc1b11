"""Device milliseconds per profiled step of the MoE layers' routing: the
operations, forward and backward, whose innermost program span is
``b4cp.moe.route`` (the router, top-k, the balance loss, the sort by
expert, the gather of the rows and their weighted sum back per token), in
the trace without frames."""

from portbench.harness import spans


def read(ctx):
    return spans.device_ms_per_step(ctx.trace, "b4cp.moe.route")
