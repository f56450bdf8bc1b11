"""Device milliseconds per profiled step of multi-head latent attention
but its core: the operations, forward and backward, whose innermost
program span is ``b4cp.mla`` (the query, latent and key-value projections,
the latent's RMSNorm, RoPE and the output projection; the attention core
lies in ``b4cp.attention``), in the trace without frames."""

from portbench.harness import spans


def read(ctx):
    return spans.device_ms_per_step(ctx.trace, "b4cp.mla")
