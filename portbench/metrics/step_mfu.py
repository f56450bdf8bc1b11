"""Percent of the card's bf16 peak that the window's model FLOPs make: the
encoder's and the tied head's forward and backward, counted from each
step's batch without recomputed work (``harness/work.py:model_flops``), over
the window's wall time."""

from portbench.harness import work


def read(ctx):
    w = ctx.window
    flops = sum(work.model_flops(ctx.config, s) for s in w.stats)
    return 100.0 * flops / (w.seconds * work.PEAK_FLOPS)
