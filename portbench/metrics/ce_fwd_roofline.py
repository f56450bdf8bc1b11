"""Percent of the CE forward's roofline: 2 N V D operations and its bytes
(``harness/work.py:ce_forward``; N labelled rows, V the catalog, x in
float32 as the program hands it over) over the device time of what
``ops/kernels/fused_ce.py:ce_stats`` launched (by kernel name ``ce_fwd``
where the trace has no frames)."""

from portbench.harness import layers, work

FRAMES = ("ops/kernels/fused_ce.py", ("ce_stats",))
KERNELS = r"\bce_fwd"


def read(ctx):
    t = ctx.stack_trace
    if t is None:
        return None
    cfg = ctx.config
    bound = sum(work.bound_s(*work.ce_forward(s["labelled"], cfg["n_items"], cfg["d_model"], work.F32))
                for s in t.batch_stats)
    return layers.share(bound, layers.select(t, *FRAMES, kernels=KERNELS))
