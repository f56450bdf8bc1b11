"""Percent of the optimizer's roofline: the bytes Adam needs (read p, g,
mu, nu; write p, mu, nu at each one's type; ``harness/work.py:adam_bytes``)
over the card's bandwidth, against the device time of what
``training/train_state.py:apply_gradients`` launched. Only frames attribute
these kernels (their names are PyTorch's generic ones): without frames the
metric is left out."""

import math

from portbench.harness import layers, work
from portbench.reference.model import param_specs

FRAMES = ("training/train_state.py", ("apply_gradients",))


def read(ctx):
    t = ctx.stack_trace
    if t is None:
        return None
    cfg = ctx.config
    numel = sum(math.prod(shape) for _, shape, _ in param_specs(cfg))
    mu = work.dtype_bytes(cfg["optimizer"]["mu_dtype"])
    bound = t.steps * work.adam_bytes(numel, mu) / work.PEAK_BYTES
    return layers.share(bound, layers.select(t, *FRAMES))
