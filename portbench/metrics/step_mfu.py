"""Percent of the card's bf16 peak that the window's model FLOPs make: the
forward and backward of the model, counted from each step's batch without
recomputed work by the configuration's reference (its ``model_flops``,
found by ``manifest.reference``; BERT4Rec's counts the encoder and the tied
head, over the catalog or over a sampled softmax's label and negatives),
over the window's wall time."""

from portbench.harness import manifest, work


def read(ctx):
    w = ctx.window
    model_flops = manifest.reference(ctx.config, ctx.cell.root).model_flops
    flops = sum(model_flops(ctx.config, s) for s in w.stats)
    return 100.0 * flops / (w.seconds * work.PEAK_FLOPS)
