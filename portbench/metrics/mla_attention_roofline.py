"""Percent of the uneven attention kernels' roofline in a DeepSeek-V2
configuration: the least time of the attention core's work (:func:`work`)
over the device time of what ``ops/kernels/attention.py:_launch_uneven_fwd``
and ``_launch_uneven_bwd`` launched (by the kernels' names where the trace
has no frames).

Heads of q/k ``qk_nope_head_dim + qk_rope_head_dim`` and v ``v_head_dim``,
``num_attention_heads`` of them, in every layer. Operations count the pairs
of real tokens of each session (``batch_stats["tokens_sq"]``): forward the
score and PV products, 2 pairs H (Dqk + Dv); backward the recomputed score,
dp, dv, dq and dk products, 2 pairs H (3 Dqk + 2 Dv). Bytes: the bf16
tensors as the kernels take them, (B, L) rows each: forward q, k, v read and
the output written, with the f32 bias row and log-sum-exp; backward q, k, v
and the output gradient read, dq, dk and dv written, with the bias, the
log-sum-exp and delta."""

from portbench.harness import layers, work as work_lib

FRAMES = ("ops/kernels/attention.py", ("_launch_uneven_fwd", "_launch_uneven_bwd"))
KERNELS = r"\bumha_"
BF16 = 2


def work(cfg: dict, stats: dict) -> tuple[float, float]:
    """(FLOPs, bytes) of one step's attention cores over a batch with
    ``stats`` (``batch``, ``length``, ``tokens_sq``)."""
    h, dv = cfg["num_attention_heads"], cfg["v_head_dim"]
    dqk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    pairs = float(stats["tokens_sq"])
    rows = stats["batch"] * stats["length"]
    qk, v, f32_row = rows * h * dqk * BF16, rows * h * dv * BF16, rows * h * work_lib.F32
    bias = rows * work_lib.F32
    flops = 2.0 * pairs * h * (dqk + dv) + 2.0 * pairs * h * (3 * dqk + 2 * dv)
    nbytes = (2 * qk + 2 * v + bias + f32_row) + (4 * qk + 3 * v + bias + 2 * f32_row)
    return cfg["num_hidden_layers"] * flops, cfg["num_hidden_layers"] * float(nbytes)


def read(ctx):
    t = ctx.stack_trace
    if t is None:
        return None
    bound = sum(work_lib.bound_s(*work(ctx.config, s)) for s in t.batch_stats)
    return layers.share(bound, layers.select(t, *FRAMES, kernels=KERNELS))
