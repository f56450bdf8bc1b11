"""Device milliseconds per profiled step of the encoder: the operations,
forward and backward, of its input dropout and its layers (a remat
recompute too), whose innermost program span is ``b4cp.encoder``. The attention kernels lie in their own
span, ``b4cp.attention``, and are not counted here."""

from portbench.harness import spans


def read(ctx):
    return spans.device_ms_per_step(ctx.trace, "b4cp.encoder")
