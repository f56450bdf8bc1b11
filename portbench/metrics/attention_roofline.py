"""Percent of the attention kernels' roofline: each layer's forward and
backward on the (B, L, d_model) activations in the compute type
(``harness/work.py:attention_forward`` and ``attention_backward``) over the
device time of what the port's attention launchers in
``ops/kernels/attention.py`` launched (by kernel name where the trace has no
frames)."""

from portbench.harness import layers, work

FRAMES = ("ops/kernels/attention.py",
          ("_launch_fwd", "_launch_bwd", "_launch_blockwise_fwd", "_launch_blockwise_bwd"))
KERNELS = r"\bb?mha_"


def read(ctx):
    t = ctx.stack_trace
    if t is None:
        return None
    cfg = ctx.config
    act = work.dtype_bytes(cfg["dtype"])
    bound = 0.0
    for s in t.batch_stats:
        fwd = work.attention_forward(s["batch"], s["length"], cfg["d_model"], act)
        bwd = work.attention_backward(s["batch"], s["length"], cfg["d_model"], act)
        bound += cfg["num_layers"] * (work.bound_s(*fwd) + work.bound_s(*bwd))
    return layers.share(bound, layers.select(t, *FRAMES, kernels=KERNELS))
