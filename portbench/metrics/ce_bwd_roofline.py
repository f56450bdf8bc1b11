"""Percent of the CE backward's roofline: 6 N V D operations (the scores
again, then dx and dW) and its bytes (``harness/work.py:ce_backward``) over
the device time of what ``ops/kernels/fused_ce.py:ce_backward`` launched,
by either route (by the kernel names of the CE backward where the trace
has no frames)."""

from portbench.harness import layers, work

FRAMES = ("ops/kernels/fused_ce.py", ("ce_backward",))
KERNELS = r"\bce_(bwd|pack|unpack|dx|table|live)"


def read(ctx):
    t = ctx.stack_trace
    if t is None:
        return None
    cfg = ctx.config
    bound = sum(work.bound_s(*work.ce_backward(s["labelled"], cfg["n_items"], cfg["d_model"], work.F32))
                for s in t.batch_stats)
    return layers.share(bound, layers.select(t, *FRAMES, kernels=KERNELS))
