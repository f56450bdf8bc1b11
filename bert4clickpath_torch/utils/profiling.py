"""Performance accounting: FLOP/byte roofline estimates + profiler hooks
(counterpart of ``bert4clickpath_tpu/utils/profiling.py``).

* :func:`step_cost` — analytic FLOPs + device-memory bytes for a train step
  of a given ModelConfig/batch (encoder, head/CE, optimizer); its arithmetic
  is the JAX module's, which is hardware-independent;
* :func:`speed_of_light` — measured step time -> MFU / bandwidth
  utilization against the card's peaks;
* :func:`trace` — context manager around ``torch.profiler`` writing a
  Chrome trace (the counterpart of the XProf trace).

Peaks default to one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at
700 W), the ones ``chip_smoke.py`` rates its kernels against. The JAX
module's third port, the TPU's vector unit, becomes the CUDA cores' f32
rate: the exp-bearing softmax streams (``vpu_ops``, named as in the JAX
module) run there, outside the tensor cores.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

from bert4clickpath_torch.config import ModelConfig

H100_HBM_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12  # tensor cores, dense
H100_TF32_FLOPS = 495e12  # tensor cores, dense
H100_F32_FLOPS = 67e12  # CUDA cores, outside the tensor cores (also integer work)
# the same peaks by operand type, as chip_smoke.py's bounds take them
H100_PEAKS = {"bytes": H100_HBM_BYTES_PER_S, "bf16": H100_BF16_FLOPS, "tf32": H100_TF32_FLOPS,
              "f32": H100_F32_FLOPS}

# Weighted VPU ops per element of each exp-bearing stream (exp counts ~2):
_CE_FWD_OPS = 5  # max-reduce, sub, exp, sum-reduce
_CE_BWD_OPS = 8  # sub, exp, onehot cmp+select, sub, dnll mul, bf16 cvt
_ATTN_SOFTMAX_OPS = 11  # fwd max/sub/exp/sum/div + bwd mul/reduce/sub/mul


@dataclass
class StepCost:
    encoder_flops: float
    head_flops: float
    total_flops: float  # fwd + bwd
    hbm_bytes: float  # params + activations traffic estimate
    params: int
    # weighted elementwise ops on the exp-bearing VPU streams (fused-CE
    # online softmax fwd+bwd, attention softmax). Deliberately UNDER-counts
    # (no LN/dropout/residual streams), so vpu_bound_ms stays a valid lower
    # bound on the step.
    vpu_ops: float = 0.0

    def summary(self) -> dict:
        return {
            "encoder_gflops": round(self.encoder_flops / 1e9, 1),
            "head_gflops": round(self.head_flops / 1e9, 1),
            "total_gflops": round(self.total_flops / 1e9, 1),
            "hbm_mb": round(self.hbm_bytes / 1e6, 1),
            "params_m": round(self.params / 1e6, 2),
            "vpu_gops": round(self.vpu_ops / 1e9, 1),
        }


def encoder_param_count(cfg: ModelConfig) -> int:
    d, f = cfg.d_model, cfg.ffn_dim
    per_layer = 4 * d * d + 4 * d + 2 * d * f + d + f + 4 * d  # qkv/o + ffn + 2 LN
    emb = sum(fc.vocab_rows * fc.embedding_dim for fc in cfg.features.values())
    embed_sum = sum(fc.embedding_dim for fc in cfg.features.values())
    proj = embed_sum * d + d if cfg.encoder_dim and cfg.encoder_dim != embed_sum else 0
    pos = cfg.max_len * d if cfg.positional == "learned" else 0
    return cfg.num_layers * per_layer + emb + pos + proj


def step_cost(
    cfg: ModelConfig,
    batch: int,
    label_vocab: int,
    bytes_per_param: int = 4,
    fused_ce: bool = True,
) -> StepCost:
    """Analytic cost of one training step (fwd + bwd + Adam)."""
    b, l, d, f, p = batch, cfg.max_len, cfg.d_model, cfg.ffn_dim, cfg.head_width
    # encoder fwd matmul FLOPs per layer: qkv/o (4*B*L*D^2), scores+av
    # (2*B*H*L^2*Dh = 2*B*L^2*D), ffn (2*B*L*D*F); x2 MACs->FLOPs
    per_layer = 2 * (4 * b * l * d * d + 2 * b * l * l * d + 2 * b * l * d * f)
    enc_fwd = cfg.num_layers * per_layer
    if cfg.head.kind in ("tied_softmax",):
        head_fwd = 2 * b * p * d * label_vocab
    elif cfg.head.kind == "softmax":
        dims = [d, *cfg.head.dense_dims, label_vocab]
        head_fwd = sum(2 * b * p * i * o for i, o in zip(dims[:-1], dims[1:]))
    else:
        dims = [d, *cfg.head.dense_dims, max(1, cfg.head.output_size)]
        head_fwd = sum(2 * b * p * i * o for i, o in zip(dims[:-1], dims[1:]))
    # bwd = 2x fwd; fused CE recomputes logits in bwd (+2 head_fwd passes)
    enc_total = 3 * enc_fwd
    head_total = 5 * head_fwd if fused_ce else 3 * head_fwd
    n_params = encoder_param_count(cfg)
    # HBM: params read fwd+bwd, grads written, adam mu/nu read+write (x5),
    # plus logits traffic only in the non-fused path
    hbm = n_params * bytes_per_param * 7.0
    if not fused_ce and cfg.head.kind in ("softmax", "tied_softmax"):
        hbm += 3.0 * b * p * label_vocab * 4  # materialized f32 logits fwd+bwd
    vpu = 0.0
    if cfg.head.kind in ("softmax", "tied_softmax"):
        # every (masked-position, catalog-row) score element passes through
        # the online-softmax stream once fwd and once in the bwd recompute
        vpu += b * p * label_vocab * (_CE_FWD_OPS + _CE_BWD_OPS)
    vpu += cfg.num_layers * cfg.num_heads * b * l * l * _ATTN_SOFTMAX_OPS
    return StepCost(
        encoder_flops=enc_total,
        head_flops=head_total,
        total_flops=enc_total + head_total,
        hbm_bytes=hbm,
        params=n_params,
        vpu_ops=vpu,
    )


def speed_of_light(
    cost: StepCost,
    measured_step_seconds: float,
    peak_flops: float = H100_BF16_FLOPS,
    peak_hbm: float = H100_HBM_BYTES_PER_S,
    peak_vpu: float = H100_F32_FLOPS,
) -> dict:
    """Three-port roofline report for a measured step time (the JAX
    module's keys: ``vpu`` is the elementwise port, here the CUDA cores).

    MFU alone under-states the floor for softmax-heavy steps: the fused-CE
    kernels stream one exp-bearing elementwise pass per (position,
    catalog-row) element fwd AND bwd, a cost tensor-core FLOP counting
    never sees. That port's time is reported alongside; each port's time is
    a valid lower bound, so ``speed_of_light_ms`` (their max) is too.
    """
    flop_time = cost.total_flops / peak_flops
    hbm_time = cost.hbm_bytes / peak_hbm
    vpu_time = cost.vpu_ops / peak_vpu
    times = {"flops": flop_time, "hbm": hbm_time, "vpu": vpu_time}
    bound = max(times, key=times.get)
    return {
        "measured_ms": round(measured_step_seconds * 1e3, 3),
        "flop_bound_ms": round(flop_time * 1e3, 3),
        "hbm_bound_ms": round(hbm_time * 1e3, 3),
        "vpu_bound_ms": round(vpu_time * 1e3, 3),
        "speed_of_light_ms": round(times[bound] * 1e3, 3),
        "mfu": round(cost.total_flops / (measured_step_seconds * peak_flops), 4),
        "sol_fraction": round(times[bound] / measured_step_seconds, 4),
        "bound": bound,
    }


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` around a block (CPU and, where there is a card,
    CUDA activity); yields the profiler (``key_averages()``) and writes a
    Chrome trace, ``trace_<pid>_<time>.json``, under ``logdir`` (view in
    chrome://tracing or Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
