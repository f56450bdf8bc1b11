"""Percent of the grouped expert products' roofline: the least time of
their work (:func:`work`) over the device time of what
``ops/kernels/grouped_gemm.py:grouped_mm``, ``grouped_mm_w`` and
``grouped_mm_dw`` launched (by the kernel's name where the trace has no
frames).

Each MoE layer multiplies every routed row, each real token of the batch
``num_experts_per_tok`` times (all experts are held and none drops a
token): forward 2 rows D 2F (gate and up) + 2 rows F D (down), backward
twice that (the input and the weight gradients). Bytes: the bf16 weights
and the permuted rows read, the products' outputs written (the weight
gradients in f32)."""

from portbench.harness import layers, work as work_lib

FRAMES = ("ops/kernels/grouped_gemm.py", ("grouped_mm", "grouped_mm_w", "grouped_mm_dw"))
KERNELS = r"grouped_gemm_kernel"
BF16 = 2


def work(cfg: dict, tokens: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one step's grouped products over ``tokens`` real
    tokens."""
    d, f, e = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["n_routed_experts"]
    moe_layers = cfg["num_hidden_layers"] - min(cfg["first_k_dense_replace"], cfg["num_hidden_layers"])
    rows = tokens * cfg["num_experts_per_tok"]
    forward = 2.0 * rows * d * 2 * f + 2.0 * rows * f * d
    weights = e * 3 * f * d
    fwd_bytes = BF16 * (weights + rows * (d + 2 * f) + rows * (f + d))  # read W, X; write Y (both products)
    dx_bytes = BF16 * (weights + rows * (2 * f + d) + rows * (d + f))
    dw_bytes = BF16 * rows * (2 * f + d + d + f) + work_lib.F32 * weights
    return moe_layers * 3.0 * forward, moe_layers * float(fwd_bytes + dx_bytes + dw_bytes)


def read(ctx):
    t = ctx.stack_trace
    if t is None:
        return None
    bound = sum(work_lib.bound_s(*work(ctx.config, s["tokens"])) for s in t.batch_stats)
    return layers.share(bound, layers.select(t, *FRAMES, kernels=KERNELS))
