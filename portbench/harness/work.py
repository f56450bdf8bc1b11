"""The yardstick: the card's peaks and the operations and bytes of the
kernels. A model's FLOPs a step are its reference's ``model_flops``
(``reference/<r>.py``, found by ``manifest.reference``).

Peaks are NVIDIA's data sheet for one H100 SXM at 700 W (dense, no
sparsity). Every roofline share is rated against the bf16 tensor-core rate,
the highest at a precision the check of outputs accepts, so no
implementation can read over 100% and the count does not change with the
implementation.

The counts are copied from the program's and corrected:

* ``bert4clickpath_torch/utils/profiling.py:step_cost`` counted the fused CE
  as five times its forward and every (B, P) head position. The BERT4Rec
  reference's ``model_flops`` leaves out the backward's recomputed scores
  (3 x 2 N V D for the head) and counts only labelled rows N and valid
  catalog rows V; the encoder's dense layers count real (non-pad) tokens,
  and attention the real query-key pairs.
* ``chip_smoke.py:bound`` rated the CE products as three TF32 products; here
  the CE forward is 2 N V D operations and its backward 6 N V D (from x, W,
  logz and the labels the backward needs the scores again, then dx and dW),
  at the bf16 rate, whatever the implementation. Its byte count is kept:
  each input read once, each output written once.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s
PEAK_BYTES = 3.35e12  # HBM3 bytes/s

F32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def dtype_bytes(name: str) -> int:
    return {"float32": F32, "bfloat16": 2}[name]


def ce_forward(n: int, v: int, d: int, x_bytes: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the CE statistics of n labelled rows over v rows:
    read x and the f32 table, write (max, sum) a row."""
    return 2.0 * n * v * d, n * d * x_bytes + v * d * F32 + 2 * n * F32


def ce_backward(n: int, v: int, d: int, x_bytes: int) -> tuple[float, float]:
    """(FLOPs, bytes) of dx and dW: read x, the table, logz, dnll and the
    labels; write dx and the f32 dW."""
    flops = 6.0 * n * v * d
    nbytes = n * d * x_bytes + v * d * F32 + 3 * n * F32 + n * d * x_bytes + v * d * F32
    return flops, nbytes


def attention_forward(b: int, length: int, d: int, act_bytes: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one layer's attention forward on (b, length, d):
    q k^T and p v; read q, k, v and the key bias, write the output."""
    flops = 4.0 * b * length * length * d
    nbytes = 4 * b * length * d * act_bytes + b * length * F32
    return flops, nbytes


def attention_backward(b: int, length: int, d: int, act_bytes: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one layer's attention backward from q, k, v, the
    bias and dO: the scores again, dP, dV, dQ, dK; write dq, dk, dv."""
    flops = 10.0 * b * length * length * d
    nbytes = 7 * b * length * d * act_bytes + b * length * F32
    return flops, nbytes


def adam_bytes(numel: int, mu_bytes: int) -> float:
    """Read p, g, mu, nu; write p, mu, nu (f32 but mu)."""
    return numel * (F32 * 5 + 2 * mu_bytes)
