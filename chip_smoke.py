"""Drive the PyTorch port's serving path, its flagship train step, its
long-session path and a whole training run of the wide model once on one
CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  — requires a CUDA card; prints its name and power limit
   (nvidia-smi) and the TF32 flags (left off: the catalog scan and the CE
   are f32).
2. build   — builds the port's CUDA kernels from ``bert4clickpath_torch/csrc``
   with nvcc for sm_90a (one compile per source, in parallel) and prints the
   build time and ptxas' report.
3. kernels — holds each of the eleven kernels against its plain PyTorch version
   on the card at the shapes its main path gives it, with the tolerance
   stated, and times both (CUDA events; median device time of warm calls):
   the gather and whole-row attention at the flagship's shapes (the bf16
   backward on the tensor cores, two runs bit-equal, its dv from p kept as
   two bf16 terms measured against p rounded once and against a dense f64
   dv; the f32 backward the scalar kernel), the fused CE
   at its training shape, the three blockwise attention kernels at
   (16, 1024, 256) and at L=1000 in bf16 (all three on the tensor cores,
   two runs bit-equal, the dk/dv kernel's dv from p rounded to bf16 measured
   against p kept as two bf16 terms and against a dense f64 dv) and f32 (the
   scalar kernels), the fused dropout at
   (16384, 256) (bit-equal to its plain Philox version), the gather and
   the fused CE once more at the long-session path's shapes, and the
   two-pass CE backward (dx and dW kernels) with the forward at N=2,560,
   V=55,296, D=384 in f32 and bf16, with and without a bias, then at D=256
   timed beside the merged backward. Beside each kernel
   it computes the least time the card could take for the same work (bytes
   over 3.35 TB/s, operations over the published peak of their type) and,
   as a measurement only, times the one PyTorch call that computes the same
   function where there is one (``F.scaled_dot_product_attention`` and its
   autograd backward, ``F.dropout``); the port never calls those.
4. serve   — exports the flagship configuration (4 layers, d_model 256,
   4 heads, FFN 1024, L=53, qkv_fused, bf16 compute, tied softmax over a
   54,542-item catalog) with seeded random weights, loads it with
   ``ServingModel(device="cuda")``, answers requests of batch 1, 8 and 64,
   checks that both forward kernels were launched by those requests, and
   checks the answers against the same bundle served on the CPU (the plain
   path).
5. train   — the flagship train step at full width and depth, B=256, on
   Cloze batches of synthetic sessions: one warm-up step, two timed
   ``make_scan_train_step`` calls of K=20 steps (exact kernel launch counts
   per step required), one profiled call, two more (100 steps in all: every
   loss finite, the last 10 lower than the first 10 on average), five steps
   taken apart into synchronized stages, then one
   step at B=32 with dropout 0 on the card and on the CPU (plain versions)
   from the same weights, in f32 and in bf16 compute: loss and every
   parameter's gradient compared.
6. long-train — the long-session train step of
   ``examples/long_context/bench_torch.py`` at full width and depth (4
   layers, d_model 256, 4 heads, max_len 1024, learned positions, tied
   softmax over 20,000 items), B=16, L=1024, dropout 0.1 through the fused
   dropout kernel: a warm-up step, 20 timed ``make_train_step`` calls (exact
   launch counts: gather 1, blockwise forward / dq / dkv 4 each, dropout 18,
   CE forward and backward 1 each, whole-row attention 0), the same 20 steps
   with the mask back end, a profiled window, 60 steps in all with finite and
   falling losses; then one step at B=2, dropout 0, card vs CPU in f32 and
   bf16.
7. long-serve — the same configuration exported and served on the card:
   requests of batch 8 with ~1,000 items per session, 4 blockwise forward
   launches per request and no whole-row one, top-10 log-probs against the
   same bundle on the CPU.

8. wide-train — ``examples/bert4rec/train_torch.py``'s ``main`` in this
   process: ``--preset tpu --d_model 384 --heads 6 --layers 4 --qkv_fused``
   (FFN 1,536, bf16 compute, tied softmax over 54,542 simulated items) at
   B=256, 2 epochs of 40 steps with 8 eval batches each, ``--ckpt_keep 1``.
   Required: the exact launches (per train step 1 gather, 4 attention, 4
   attention backward, 1 CE forward, 1 dx pass, 1 dW pass and no merged CE
   backward; per eval batch 1 gather and 4 attention), a falling train loss,
   finite eval metrics in [0, 1], ``history.jsonl``, one committed
   checkpoint and the export; then one step and one eval batch alone, a
   timed and a profiled window, ``--resume`` for one more epoch (the step
   count continues), the trained export served by ``ServingModel`` on the
   card, and one train step and one eval batch at B=32, dropout 0, card vs
   CPU in f32 and bf16.

The line before the last is the card's name and power limit; the line
before that is the kernels' JSON summary; the last line is the device JSON.
Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
N_ITEMS = 54_542  # Beauty-sized catalog (bench.py N_ITEMS)
B_SERVE = (1, 8, 64)
REQUESTS = 50  # per batch size: p90 has 5 samples beyond it
PROFILED = 10  # requests per batch size in the profiled window
K = 10
# tolerances (stated): attention bf16 abs 2e-2 (one bf16 ulp of an O(1)
# output), f32 abs 1e-5 (sums in another order); gather within one ulp of
# its output type (both versions round the same f32 value once); served
# log-probs, GPU vs CPU plain path, both bf16, abs 2e-2
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
SERVE_TOL = 2e-2
# attention backward (atol, rtol): bf16 one or two ulps of an O(1) gradient
# (the tensor-core kernel sums p, dp and ds in the mma's order with the fast
# exp, so a ds or a gradient may round the other way; the share of this
# tolerance that each gradient uses is logged); f32 (the scalar kernel)
# sums in another order
ATTN_BWD_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-5, 1e-4)}
# fused CE (f32 x): logz abs 1e-4 (sums over 55k rows in another order);
# dx, dW, db within 1e-4 of the reference's largest magnitude (dx sums with
# atomics in an order that varies run to run)
CE_LOGZ_TOL = 1e-4
CE_GRAD_REL = 1e-4
# train phase: the flagship step at B=256, K steps per scan call
B_TRAIN = 256
K_TRAIN = 20
TRAIN_CALLS = 5  # 100 steps
B_CHECK = 32  # card vs CPU gradient check
# card vs CPU, one step from the same weights and batch, per compute dtype:
# (loss abs, every parameter's relative gradient norm error). f32: sums in
# another order (measured ~1e-6). bf16: a ReLU whose bf16 input rounds to
# the other side of 0 flips that unit's gradient, so ffn1's gradients carry
# bf16 noise. Measured at B=32 on an NVIDIA H100 (700 W) and its host CPU:
# the bf16 step is 6.9% (card) and 6.8% (CPU) from the f32 one in ffn1's
# gradients, and card vs CPU in bf16 differ by 3.06e-2 there (median
# 6.4e-3 over all parameters).
TRAIN_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 5e-2)}
# long-session path: examples/long_context/bench_torch.py --seq_len 1024 --batch 16
LONG_L, LONG_B, LONG_ITEMS, LONG_P = 1024, 16, 20_000, 10
LONG_TIMED = 20  # timed steps per dropout back end
LONG_STEPS = 60  # steps in all with the fused back end
LONG_B_CHECK = 2  # card vs CPU step
LONG_B_SERVE, LONG_REQUESTS = 8, 5
# wide training run: examples/bert4rec/train_torch.py --preset tpu --d_model 384
# --heads 6 --layers 4 --qkv_fused on simulated sessions at Beauty's catalog size
WIDE_D, WIDE_HEADS, WIDE_LAYERS = 384, 6, 4
WIDE_STEPS, WIDE_EPOCHS, WIDE_EVAL_BATCHES, WIDE_SESSIONS = 40, 2, 8, 20_000
WIDE_TIMED = 20  # train steps in the timed window after the run
DX_TARGETS = (132, 264, 528, 1056, 2112)  # dx grid sizes timed at the wide shapes (1 to 16 waves of blocks)
# eval sums, card vs CPU, relative to each sum's magnitude: f32 sums in
# another order; bf16 as the train step's loss tolerance
EVAL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# blockwise attention against its plain version. Forward (atol, rtol): the
# running maximum that p rounds against and the order of the f32 sums depend
# on the tile walk (in bf16 the tensor-core kernel's, 32 keys at a time, with
# the fast exp). In bf16, where a few keys carry a row, p's rounding (half
# an ulp on each side) moves the unrounded output by up to an ulp and the
# output's own rounding by another: two bf16 ulps of the reference (2^-6 of
# it) plus 2e-3 for values near 0; f32 abs 1e-5.
BLOCKWISE_TOL = {torch.bfloat16: (2e-3, 2.0**-6), torch.float32: (1e-5, 0.0)}
# Gradients (atol as a share of the plain version's largest magnitude, rtol).
# f32 (scalar kernels): the whole-row kernels' abs 1e-5 + rel 1e-4. bf16
# (tensor-core kernels): the f32 sums run in the mma's order and exp is the
# fast one, so a p, a ds or the gradient itself may round to the other
# neighbour: two bf16 ulps of the plain value (2^-6 of it) plus 2e-3 of the
# largest gradient, which is floored at 1e-2 because a row with one real key
# has p = 1 and ds = 0 but for the sums' rounding (its gradients are ~1e-6 of
# noise). Measured on an NVIDIA H100 80GB HBM3 at (16, 1024, 256) and L=1000:
# 0.37 / 0.33 / 0.30 of this tolerance at most for dq / dk / dv (one bf16 ulp
# of a value a quarter to half the largest). The fully padded batch row
# (p = 1 at every key, much larger gradients) is held apart, against its own
# largest magnitude.
BLOCKWISE_BWD_TOL = {torch.bfloat16: dict(share=2e-3, floor=1e-2, rtol=2.0**-6),
                     torch.float32: dict(atol=1e-5, rtol=1e-4)}
# published peaks of one H100 SXM (dense): device memory bytes/s, bf16 tensor
# FLOP/s, f32 FLOP/s outside the tensor cores (also used for integer work)
PEAK = {"bytes": 3.35e12, "bf16": 989e12, "f32": 67e12}


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound(n_bytes: float, ops: dict) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, each output written once) over
    the memory rate, and its operations (by operand type) over their peak."""
    by_bytes = n_bytes / PEAK["bytes"] * 1e3
    by_ops = sum(n / PEAK[kind] for kind, n in ops.items()) * 1e3
    return dict(bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops else "operations")


def attention_bounds(b, l, d, h, itemsize) -> dict:
    """Bounds of the attention kernels at (B, L, D), H heads. One product
    over all heads is 2 B L^2 D operations. The score, PV, dp, dq and dk
    products are rated at the input type (bf16: the tensor cores' rate).
    dp = do . v^T counts there too: do and v arrive in the input type, and
    widening them to f32 before the product changes no sum. The blockwise
    dv = p^T . do rounds p to the input type first, so it is rated there
    as well; the whole-row backward takes dv from the unrounded f32 p, an
    operand that exists in f32 alone, so its dv is rated at the f32 peak."""
    prod = 2.0 * b * l * l * d
    kind = "bf16" if itemsize == 2 else "f32"
    x, bias, rows = b * l * d * itemsize, b * l * 4, b * l * h * 4

    def ops(n_input_type, n_f32=0):
        counts = {kind: n_input_type * prod}
        counts["f32"] = counts.get("f32", 0.0) + n_f32 * prod
        return counts

    return {
        "fwd": bound(4 * x + bias, ops(2)),  # q, k, v in; out
        "fwd_lse": bound(4 * x + bias + rows, ops(2)),  # and lse out
        "bwd": bound(7 * x + bias, ops(4, 1)),  # whole-row: q, k, v, do in; dq, dk, dv out
        "dq": bound(5 * x + bias + 2 * rows, ops(3)),  # + lse, delta in; dq out: s, dp, dq
        "dkv": bound(6 * x + bias + 2 * rows, ops(4)),  # s, dp, dk, dv
    }


def dv_rounding_errors(q, k, v, bias, lse, do, h, dv_kernel, batch_rows) -> dict:
    """What rounding p to bf16 before dv = p^T . do costs, against a dense
    f64 dv from the same bf16 inputs and lse (None: the whole-row softmax in
    f64), over ``batch_rows``, slices of the batch taken one at a time (not
    a fully padded row: its p = 1 exists only where f32 absorbs s into the
    -1e9 bias):
    (rms, max) absolute error of ``output`` (the exact dv rounded to the bf16
    output: what no bf16 kernel can avoid), ``a`` (p rounded once to bf16,
    f32 sums, rounded to bf16), ``b`` (p split into two bf16 terms hi + lo,
    ~16 bits kept, likewise), ``f32_p`` (the unrounded f32 p, as the TPU
    kernel takes it) and ``kernel`` (the kernel's dv)."""
    d = q.shape[-1]
    scale = 1.0 / ((d // h) ** 0.5)
    split = lambda t, dt: t.unflatten(-1, (h, d // h)).to(dt)  # noqa: E731
    sums = {}
    for i in batch_rows:
        q64, k64, do64 = (split(t[i], torch.float64) for t in (q, k, do))
        s64 = torch.einsum("bqhd,bkhd->bhqk", q64, k64) * scale + bias[i].double()
        if lse is None:
            p64 = torch.softmax(s64, dim=-1)
        else:
            p64 = torch.exp(s64 - lse[i].double().transpose(1, 2).unsqueeze(-1))
        exact = torch.einsum("bhqk,bqhd->bkhd", p64, do64)
        p32, do32 = p64.float(), do64.float()
        hi = p32.bfloat16().float()
        lo = (p32 - hi).bfloat16().float()
        sum_f32 = lambda p: torch.einsum("bhqk,bqhd->bkhd", p, do32)  # noqa: E731
        got = {"output": exact.bfloat16().double(), "a": sum_f32(hi).bfloat16().double(),
               "b": (sum_f32(hi) + sum_f32(lo)).bfloat16().double(), "f32_p": sum_f32(p32).bfloat16().double(),
               "kernel": split(dv_kernel[i], torch.float64)}
        for name, val in got.items():
            err = (val - exact).abs()
            sq, mx, n = sums.get(name, (0.0, 0.0, 0))
            sums[name] = (sq + float((err * err).sum()), max(mx, float(err.max())), n + err.numel())
    return {name: ((sq / n) ** 0.5, mx) for name, (sq, mx, n) in sums.items()}


def sdpa_times(q, k, v, bias, do, h, reps: int = 20) -> tuple[float, float]:
    """(forward ms, backward ms) of ``F.scaled_dot_product_attention`` on
    the same inputs, the padding bias as its mask: a yardstick only."""
    import torch.nn.functional as F

    heads = lambda t: t.detach().unflatten(-1, (h, t.shape[-1] // h)).transpose(1, 2)  # noqa: E731
    qh, kh, vh = (heads(t).requires_grad_() for t in (q, k, v))
    mask = bias.to(q.dtype)
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    fwd = device_time_ms(lambda: F.scaled_dot_product_attention(qh.detach(), kh.detach(), vh.detach(), attn_mask=mask), reps)
    bwd = device_time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), heads(do), retain_graph=True), reps)
    return fwd, bwd


def device_time_ms(fn, reps: int = 50) -> float:
    """Median device time of one call, CUDA events around it. A short GPU
    sleep before each call keeps the device busy while the host enqueues,
    so the events bracket device work, not launch gaps."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)  # ~0.5 ms at H100 clocks
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


# -- phases -----------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA card: torch.cuda.is_available() is False")
    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | count {torch.cuda.device_count()}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} | "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    return card


def phase_build() -> None:
    from bert4clickpath_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"[build] {line.strip()}")


def _qkv_bias(b, seq, d, rng, full_pad_row: bool):
    from bert4clickpath_torch.constants import PAD_ID
    from bert4clickpath_torch.ops.masking import padding_bias

    qkv = torch.from_numpy(rng.standard_normal((b, seq, 3 * d), dtype=np.float32)).cuda()
    tokens = np.ones((b, seq), np.int32)
    for i, n in enumerate(rng.integers(1, seq + 1, size=b)):  # ragged padding
        tokens[i, n:] = PAD_ID
    if full_pad_row:
        tokens[0] = PAD_ID
    return qkv, padding_bias(torch.from_numpy(tokens).cuda())


def gather_kernel_at(rng, v_rows: int, seq: int, d: int, cases) -> dict:
    """The gather kernel against its plain version over a (v_rows, d) f32
    table and (seq, d) positions, for each (batch, output type) of ``cases``,
    ids including 0 and v_rows - 1; times and bound of the last bf16 case."""
    from bert4clickpath_torch.ops.kernels.gather import gather_scale_pos, gather_scale_pos_reference

    table = torch.from_numpy(rng.standard_normal((v_rows, d), dtype=np.float32) * 0.02).cuda()
    pos = torch.from_numpy(rng.standard_normal((seq, d), dtype=np.float32)).cuda()
    scale = float(d) ** 0.5  # sqrt(d_model)
    errs, times, n = [], None, 0
    with torch.no_grad():
        for b, dtype in cases:
            ids_np = rng.integers(0, v_rows, size=(b, seq)).astype(np.int32)
            ids_np[0, 0], ids_np[0, 1] = 0, v_rows - 1
            ids = torch.from_numpy(ids_np).cuda()
            got = gather_scale_pos(table, ids, pos, scale, dtype)
            want = gather_scale_pos_reference(table, ids, pos, scale, dtype)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            # one ulp of the output type at the reference's magnitude
            _, exp = torch.frexp(want.float())
            ulp = torch.ldexp(torch.ones_like(diff), exp - (8 if dtype == torch.bfloat16 else 24))
            err = diff.max().item()
            log(f"[kernels] gather V={v_rows} B={b} L={seq} D={d} out {dtype}: "
                f"max_abs_err {err:.3e}, worst err/ulp {(diff / ulp).max().item():.3f} (tol 1 ulp)")
            if bool((diff > ulp).any()):
                raise AssertionError(f"gather {dtype}: error above one ulp (max {err})")
            errs.append(err)
            if dtype == torch.bfloat16:
                times = (
                    device_time_ms(lambda: gather_scale_pos(table, ids, pos, scale, dtype)),
                    device_time_ms(lambda: gather_scale_pos_reference(table, ids, pos, scale, dtype)),
                )
                n = b * seq
                log(f"[kernels] gather B={b} L={seq} bf16: kernel {times[0] * 1e3:.1f} us, "
                    f"plain {times[1] * 1e3:.1f} us (median device time)")
    # ids in; one table row and the output per token; the L rows of pos. No
    # single PyTorch call gathers, scales and adds positions: library_ms null
    return dict(max_abs_err=max(errs), ms=times[0], plain_ms=times[1], library_ms=None,
                **bound(n * 4 + n * d * 4 + seq * d * 4 + n * d * 2, {"f32": 2.0 * n * d}))


def attention_forward_at(rng, b: int, seq: int, d: int, h: int) -> tuple[float, tuple[float, float]]:
    """The whole-row attention forward against its plain version at
    (b, seq, d) with h heads, bf16 and f32, qkv as strided column slices of
    one (b, seq, 3d) tensor, ragged padding and (b > 1) one fully padded
    row; returns the bf16 case's error and its (kernel, plain) ms."""
    from bert4clickpath_torch.ops.kernels.attention import mha, mha_reference

    out = None
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            qkv, bias = _qkv_bias(b, seq, d, rng, full_pad_row=(b > 1))
            qkv = qkv.to(dtype)
            q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
            got = mha(q, k, v, bias, h)
            want = mha_reference(q, k, v, bias, h)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"attention B={b} D={d} {dtype}: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            log(f"[kernels] attention B={b} L={seq} D={d} H={h} {dtype}: "
                f"max_abs_err {err:.3e} (tol {ATTN_TOL[dtype]:.0e})")
            if err > ATTN_TOL[dtype]:
                raise AssertionError(f"attention B={b} D={d} {dtype}: error {err} > {ATTN_TOL[dtype]}")
            if dtype == torch.bfloat16:
                times = (
                    device_time_ms(lambda: mha(q, k, v, bias, h)),
                    device_time_ms(lambda: mha_reference(q, k, v, bias, h)),
                )
                log(f"[kernels] attention B={b} D={d} bf16: kernel {times[0] * 1e3:.1f} us, "
                    f"plain {times[1] * 1e3:.1f} us (median device time)")
                out = (err, times)
    return out


def attention_backward_at(rng, b: int, seq: int, d: int, h: int, card: str):
    """The whole-row attention backward against its plain version at
    (b, seq, d) with h heads, bf16 (the tensor-core kernel) and f32 (the
    scalar one), q/k/v as strided slices of one (b, seq, 3d) tensor, ragged
    padding and one fully padded row, two runs bit-equal; in bf16 also the
    kernel's dv (p as two bf16 terms) against a dense f64 dv beside p
    rounded once; returns the bf16 case's error, its (kernel, plain) ms and
    the f32 case's (q, k, v, bias, do)."""
    from bert4clickpath_torch.ops.kernels.attention import mha_backward, mha_backward_reference

    err_bf16, times = None, None
    for dtype in (torch.bfloat16, torch.float32):
        qkv, bias = _qkv_bias(b, seq, d, rng, full_pad_row=True)
        qkv = qkv.to(dtype)
        q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
        do = torch.from_numpy(rng.standard_normal((b, seq, d), dtype=np.float32)).cuda().to(dtype)
        got = mha_backward(q, k, v, bias, do, h)
        want = mha_backward_reference(q, k, v, bias, do, h)
        again = mha_backward(q, k, v, bias, do, h)
        torch.cuda.synchronize()
        atol, rtol = ATTN_BWD_TOL[dtype]
        tag = f"attention backward B={b} L={seq} D={d} H={h} {dtype}"
        err, used = 0.0, {}
        for name, g, w, g2 in zip(("dq", "dk", "dv"), got, want, again):
            if not torch.isfinite(g).all():
                raise AssertionError(f"{tag}: non-finite {name}")
            if not torch.equal(g, g2):
                raise AssertionError(f"{tag}: two runs of {name} differ")
            diff = (g.float() - w.float()).abs()
            used[name] = (diff / (atol + rtol * w.float().abs())).max().item()
            if used[name] > 1.0:
                raise AssertionError(f"{tag}: {name} max error {diff.max().item()}, {used[name]} of the tolerance")
            err = max(err, diff.max().item())
        log(f"[kernels] {tag}: max_abs_err {err:.3e}, dq / dk / dv at {used['dq']:.3f} / {used['dk']:.3f} / "
            f"{used['dv']:.3f} of the tolerance (abs {atol:.0e} + rel {rtol:.0e}); two runs bit-equal")
        if dtype == torch.bfloat16:
            err_bf16 = err
            # the dv decision: p as hi + lo bf16 (b, shipped) against p rounded once (a)
            dv_errs = dv_rounding_errors(q, k, v, bias, None, do, h, got[2], [slice(1, b)])
            out_rms = dv_errs["output"][0]
            log(f"[kernels] {tag}: dv = p^T . do against a dense f64 dv, (rms, max) abs error: "
                + ", ".join(f"{n} ({e[0]:.4e}, {e[1]:.3e})" for n, e in dv_errs.items())
                + f"; a / output rms {dv_errs['a'][0] / out_rms:.4f}, b / output {dv_errs['b'][0] / out_rms:.4f}, "
                f"kernel / output {dv_errs['kernel'][0] / out_rms:.4f} (the kernel takes b: held to 1.05) [{card}]")
            if dv_errs["kernel"][0] > 1.05 * out_rms:
                raise AssertionError(f"{tag}: the kernel's dv is {dv_errs['kernel'][0] / out_rms} times the output "
                                     "rounding's error")
            times = (
                device_time_ms(lambda: mha_backward(q, k, v, bias, do, h)),
                device_time_ms(lambda: mha_backward_reference(q, k, v, bias, do, h)),
            )
            log(f"[kernels] attention backward B={b} D={d} bf16: kernel {times[0] * 1e3:.1f} us, "
                f"plain {times[1] * 1e3:.1f} us (median device time)")
    return err_bf16, times, (q, k, v, bias, do)


def phase_kernels(card: str) -> dict:
    rng = np.random.default_rng(SEED)
    seq, d, h = 53, 256, 4
    out = {}
    # attention: serving batches 1 and 64, the train step's 256
    held = {b: attention_forward_at(rng, b, seq, d, h) for b in (1, 64, B_TRAIN)}
    # the summary reports the train step's shape (B=256), its main path
    out["attention"] = dict(max_abs_err=max(err for err, _ in held.values()), ms=held[B_TRAIN][1][0],
                            plain_ms=held[B_TRAIN][1][1], **attention_bounds(B_TRAIN, seq, d, h, 2)["fwd"])

    # gather: the padded Beauty-sized table; the last case is the train
    # step's shape (B=256), whose times the summary reports
    out["gather"] = gather_kernel_at(
        rng, 55_296, seq, d, ((64, torch.bfloat16), (64, torch.float32), (B_TRAIN, torch.bfloat16)))
    out.update(training_kernels(rng, card))
    # the library call's forward was timed on the backward's inputs (same shape)
    out["attention"]["library_ms"] = out["attention_bwd"].pop("library_fwd_ms")
    out.update(long_context_kernels(rng, card))
    for name, row in out.items():
        log(f"[kernels] {name}: kernel {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
            f"(share {row['bound_ms'] / row['ms']:.3f}), plain {row['plain_ms']:.4f} ms, "
            f"library {row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 4)} ms [{card}]")
    return out


def training_kernels(rng, card: str) -> dict:
    """The train step's kernels at the flagship's training shapes, and the
    wide model's kernels at its own."""
    out = {}
    seq, d, h, b = 53, 256, 4, B_TRAIN
    err, times, (q, k, v, bias, do) = attention_backward_at(rng, b, seq, d, h, card)
    # the yardstick on the f32 case's inputs, in bf16 (the loop's last q, k, v)
    lib_fwd, lib_bwd = sdpa_times(*(t.to(torch.bfloat16) for t in (q, k, v)), bias, do.to(torch.bfloat16), h)
    log(f"[kernels] F.scaled_dot_product_attention B={b} L={seq} bf16 (a yardstick, not used by the port): "
        f"forward {lib_fwd * 1e3:.1f} us, backward {lib_bwd * 1e3:.1f} us [{card}]")
    out["attention_bwd"] = dict(max_abs_err=err, ms=times[0], plain_ms=times[1], library_ms=lib_bwd,
                                library_fwd_ms=lib_fwd, **attention_bounds(b, seq, d, h, 2)["bwd"])

    # fused CE: N = B * P rows, the padded Beauty-sized table, f32 x
    out.update(ce_kernels_at(rng, B_TRAIN * 10, 55_296, N_ITEMS, d))
    # the wide model's shapes: its gather and whole-row attention (the
    # summary rows stay on the flagship's), then the two-pass backward and
    # the forward at its D = 384, the dx grid's vocab split at three targets
    wide_rows = gather_kernel_at(rng, 55_296, seq, WIDE_D, ((B_TRAIN, torch.bfloat16),))
    wide_fwd = attention_forward_at(rng, b, seq, WIDE_D, WIDE_HEADS)
    wide_bwd = attention_backward_at(rng, b, seq, WIDE_D, WIDE_HEADS, card)
    log(f"[kernels] wide shapes (B={b} L={seq} D={WIDE_D} H={WIDE_HEADS}, bf16): gather {wide_rows['ms']:.4f} ms "
        f"(plain {wide_rows['plain_ms']:.4f}), attention {wide_fwd[1][0]:.4f} ms (plain {wide_fwd[1][1]:.4f}), "
        f"attention backward {wide_bwd[1][0]:.4f} ms (plain {wide_bwd[1][1]:.4f}) [{card}]")
    wide = ce_two_pass_at(rng, B_TRAIN * 10, 55_296, N_ITEMS, WIDE_D, card, dx_targets=DX_TARGETS)
    # at the flagship's D = 256 only the timing beside the merged kernel
    flag = ce_two_pass_at(rng, B_TRAIN * 10, 55_296, N_ITEMS, d, card,
                          dtypes=(torch.float32,), biases=(False,))["times"][torch.float32]
    log(f"[kernels] D={d} f32: the two-pass pair takes {flag['dx'] + flag['dw']:.3f} ms against the merged "
        f"backward's {flag['merged']:.3f} ms ({(flag['dx'] + flag['dw']) / flag['merged']:.2f}x) [{card}]")
    wide.pop("times")
    out.update(wide)
    return out


def ce_kernels_at(rng, n: int, v_rows: int, nv: int, d: int, off: int = 10) -> dict:
    """The fused CE kernels against their plain versions at n rows of f32 x
    over a (v_rows, d) f32 table whose valid window is rows off .. off + nv,
    without and with a bias, a fifth of the labels LABEL_PAD; times and
    bounds of the case without a bias."""
    from bert4clickpath_torch.constants import LABEL_PAD
    from bert4clickpath_torch.ops.fused_ce import _labels_model
    from bert4clickpath_torch.ops.kernels.fused_ce import (
        ce_backward,
        ce_backward_reference,
        ce_stats,
        ce_stats_reference,
    )

    out = {}
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).cuda()
    table = torch.from_numpy(rng.standard_normal((v_rows, d), dtype=np.float32) * 0.02).cuda()
    labels_np = rng.integers(0, nv, size=n).astype(np.int32)
    labels_np[rng.random(n) < 0.2] = LABEL_PAD
    labels = torch.from_numpy(labels_np).cuda()
    lab = _labels_model(labels, off)
    mask = (labels != LABEL_PAD).float()
    dnll = mask / mask.sum()
    fwd_err, bwd_err, t_fwd, t_bwd = 0.0, 0.0, None, None
    for with_bias in (False, True):
        bias = torch.from_numpy(rng.standard_normal(v_rows, dtype=np.float32)).cuda() if with_bias else None
        m, l = ce_stats(x, table, bias, off, nv)
        wm, wl = ce_stats_reference(x, table, bias, off, nv)
        logz, want_logz = m + torch.log(l), wm + torch.log(wl)
        got = ce_backward(x, table, bias, lab, want_logz, dnll, off, nv)
        want = ce_backward_reference(x, table, bias, lab, want_logz, dnll, off, nv)
        torch.cuda.synchronize()
        err = (logz - want_logz).abs().max().item()
        if not torch.isfinite(logz).all() or err > CE_LOGZ_TOL:
            raise AssertionError(f"CE forward (bias={with_bias}): logz error {err} > {CE_LOGZ_TOL}")
        fwd_err = max(fwd_err, err)
        for name, g, w in zip(("dx", "dW", "db"), got, want):
            if w is None:
                continue
            e = (g - w).abs().max().item()
            scale = w.abs().max().item()
            log(f"[kernels] CE backward N={n} V={v_rows} {name} (bias={with_bias}): max_abs_err {e:.3e}, "
                f"largest |value| {scale:.3e} (tol {CE_GRAD_REL:.0e} of it)")
            if not torch.isfinite(g).all() or e > CE_GRAD_REL * scale:
                raise AssertionError(f"CE backward {name} (bias={with_bias}): error {e} > {CE_GRAD_REL} x {scale}")
            bwd_err = max(bwd_err, e)
        blinded = torch.ones(v_rows, dtype=torch.bool, device=x.device)
        blinded[off : off + nv] = False
        if not bool((got[1][blinded] == 0).all()):
            raise AssertionError("CE backward: a blinded table row got a gradient")
        log(f"[kernels] CE forward N={n} V={v_rows} D={d} f32 (bias={with_bias}): logz max_abs_err {err:.3e} "
            f"(tol {CE_LOGZ_TOL:.0e}); LABEL_PAD rows {int((labels == LABEL_PAD).sum())}")
        if not with_bias:
            t_fwd = (
                device_time_ms(lambda: ce_stats(x, table, None, off, nv), reps=20),
                device_time_ms(lambda: ce_stats_reference(x, table, None, off, nv), reps=20),
            )
            t_bwd = (
                device_time_ms(lambda: ce_backward(x, table, None, lab, want_logz, dnll, off, nv), reps=20),
                device_time_ms(lambda: ce_backward_reference(x, table, None, lab, want_logz, dnll, off, nv), reps=20),
            )
            for name, (tk, tp), flop in (("forward", t_fwd, 2), ("backward", t_bwd, 6)):
                tflops = flop * n * v_rows * d / (tk * 1e-3) / 1e12
                log(f"[kernels] CE {name} N={n} V={v_rows} D={d} f32: kernel {tk:.3f} ms "
                    f"({tflops:.1f} TFLOP/s f32), plain {tp:.3f} ms (median device time)")
    # bounds count what this run's data needs: the nv rows of the valid
    # window (the rest is blinded), and in the backward only the rows whose
    # label is not LABEL_PAD (the others' dnll is 0). No PyTorch call
    # computes either function without the (N, V) logits: library_ms null
    live = int(mask.sum().item())
    out["ce_fwd"] = dict(max_abs_err=fwd_err, ms=t_fwd[0], plain_ms=t_fwd[1], library_ms=None,
                         **bound((n * d + nv * d + 2 * n) * 4, {"f32": 2.0 * n * nv * d}))
    out["ce_bwd"] = dict(max_abs_err=bwd_err, ms=t_bwd[0], plain_ms=t_bwd[1], library_ms=None,
                         **bound((2 * n * d + 2 * nv * d + 3 * n) * 4, {"f32": 6.0 * live * nv * d}))
    return out


def _held(tag: str, got, want, rel_scale: float, rel_elem: float = 0.0) -> float:
    """Raise unless |got - want| <= rel_scale * max|want| + rel_elem * |want|
    everywhere and got is finite; returns the largest absolute error."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err, scale = diff.max().item(), want.abs().max().item()
    log(f"[kernels] {tag}: max_abs_err {err:.3e}, largest |value| {scale:.3e} "
        f"(tol {rel_scale:.0e} of it + {rel_elem:.1e} of each value)")
    if not torch.isfinite(got).all() or bool((diff > rel_scale * scale + rel_elem * want.abs()).any()):
        raise AssertionError(f"{tag}: error {err} above the tolerance (largest |value| {scale})")
    return err


def _dx_splits_at(k, target: int, n: int, v_rows: int, d: int) -> int:
    shipped, k.DX_TARGET_BLOCKS = k.DX_TARGET_BLOCKS, target
    try:
        return k.ce_dx_splits(n, v_rows, d)[0]
    finally:
        k.DX_TARGET_BLOCKS = shipped


def ce_two_pass_at(rng, n: int, v_rows: int, nv: int, d: int, card: str, off: int = 10,
                   dtypes=(torch.float32, torch.bfloat16), biases=(False, True), dx_targets=()) -> dict:
    """The two-pass CE backward kernels (and the forward) against their plain
    versions at n rows of x over a (v_rows, d) f32 table whose valid window
    is rows off .. off + nv, for x of each of ``dtypes``, without and with
    a bias as ``biases`` says, a fifth of the labels LABEL_PAD; times and
    bounds of the f32 case without a bias (the train step's CE input is
    f32), the bf16 times logged. Where the merged kernel takes d, it is
    timed beside the pair in turns. ``dx_targets``: the dx pass of the f32
    case is also held and timed with its grid's vocab split aimed at each
    of these block counts (the wrapper's constant set for the call and put
    back).

    Tolerances. f32: sums in another order, 1e-4 of the largest magnitude
    (as the merged kernel). bf16: A rounds to bf16 before the products and
    an f32 exp that differs in its last bit can round an entry the other
    way, 1e-3 of the largest magnitude; dx, itself bf16, may besides round
    its f32 sum the other way: one bf16 ulp (2^-7 of the value)."""
    from bert4clickpath_torch.constants import LABEL_PAD
    from bert4clickpath_torch.ops.fused_ce import _labels_model
    from bert4clickpath_torch.ops.kernels import fused_ce as k

    x32 = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).cuda()
    table = torch.from_numpy(rng.standard_normal((v_rows, d), dtype=np.float32) * 0.02).cuda()
    labels_np = rng.integers(0, nv, size=n).astype(np.int32)
    labels_np[rng.random(n) < 0.2] = LABEL_PAD
    labels = torch.from_numpy(labels_np).cuda()
    lab = _labels_model(labels, off)
    mask = (labels != LABEL_PAD).float()
    dnll = mask / mask.sum()
    live = int(mask.sum().item())
    blinded = torch.ones(v_rows, dtype=torch.bool, device="cuda")
    blinded[off : off + nv] = False
    errs = {"fwd": 0.0, "dx": 0.0, "dw": 0.0}
    times = {}
    for dtype in dtypes:
        x = x32.to(dtype)
        rel, elem = (CE_GRAD_REL, 0.0) if dtype == torch.float32 else (1e-3, 2.0**-7)
        for with_bias in biases:
            bias = torch.from_numpy(rng.standard_normal(v_rows, dtype=np.float32)).cuda() if with_bias else None
            tag = f"N={n} V={v_rows} D={d} {dtype} bias={with_bias}"
            wm, wl = k.ce_stats_reference(x, table, bias, off, nv)
            want_logz = wm + torch.log(wl)
            if d <= k.MAX_D_FWD:
                m, l = k.ce_stats(x, table, bias, off, nv)
                e = (m + torch.log(l) - want_logz).abs().max().item()
                log(f"[kernels] CE forward {tag}: logz max_abs_err {e:.3e} (tol {CE_LOGZ_TOL:.0e})")
                if not torch.isfinite(m + torch.log(l)).all() or e > CE_LOGZ_TOL:
                    raise AssertionError(f"CE forward {tag}: logz error {e} > {CE_LOGZ_TOL}")
                errs["fwd"] = max(errs["fwd"], e)
            args = (x, table, bias, lab, want_logz, dnll, off, nv)
            dx = k.ce_backward_dx(*args)
            dw, db = k.ce_backward_dw(*args)
            again = k.ce_backward_dx(*args)
            want_dx = k.ce_backward_dx_reference(*args)
            want_dw, want_db = k.ce_backward_dw_reference(*args)
            torch.cuda.synchronize()
            e_dx = _held(f"CE dx pass {tag}", dx, want_dx, rel, elem)
            e_dw = _held(f"CE dW pass {tag} dW", dw, want_dw, rel)
            if with_bias:
                e_dw = max(e_dw, _held(f"CE dW pass {tag} db", db, want_db, CE_GRAD_REL))
            if not torch.equal(dx, again):
                raise AssertionError(f"CE dx pass {tag}: two runs differ (it sums in a fixed order)")
            if not bool((dw[blinded] == 0).all()):
                raise AssertionError(f"CE dW pass {tag}: a blinded table row got a gradient")
            if dtype == torch.float32:
                errs["dx"], errs["dw"] = max(errs["dx"], e_dx), max(errs["dw"], e_dw)
            if with_bias:
                continue
            t = {"dx": [], "dw": [], "merged": []}
            for _ in range(2):  # in turns
                t["dx"].append(device_time_ms(lambda: k.ce_backward_dx(*args), reps=10))
                t["dw"].append(device_time_ms(lambda: k.ce_backward_dw(*args), reps=10))
                if d <= k.MAX_D:
                    t["merged"].append(device_time_ms(lambda: k.ce_backward_merged(*args), reps=10))
            t = {name: min(v) for name, v in t.items() if v}
            t["dx_plain"] = device_time_ms(lambda: k.ce_backward_dx_reference(*args), reps=5)
            t["dw_plain"] = device_time_ms(lambda: k.ce_backward_dw_reference(*args), reps=5)
            if d <= k.MAX_D_FWD:
                t["fwd"] = device_time_ms(lambda: k.ce_stats(x, table, None, off, nv), reps=10)
                t["fwd_plain"] = device_time_ms(lambda: k.ce_stats_reference(x, table, None, off, nv), reps=5)
            times[dtype] = t
            if dtype == torch.float32 and dx_targets:
                shipped, sweep = k.DX_TARGET_BLOCKS, {}
                for _ in range(2):  # in turns
                    for target in dx_targets:
                        k.DX_TARGET_BLOCKS = target
                        try:
                            _held(f"CE dx pass {tag} target {target}", k.ce_backward_dx(*args), want_dx, rel, elem)
                            ms = device_time_ms(lambda: k.ce_backward_dx(*args), reps=10)
                        finally:
                            k.DX_TARGET_BLOCKS = shipped
                        sweep[target] = min(ms, sweep.get(target, ms))
                log(f"[kernels] CE dx pass {tag}, vocab split by target blocks (splits, ms): "
                    + ", ".join(f"{target}: ({_dx_splits_at(k, target, n, v_rows, d)}, {ms:.3f})"
                                for target, ms in sweep.items())
                    + f"; shipped {shipped} (best of two windows of median device time) [{card}]")
            unit = 2.0 * n * v_rows * d / 1e9  # GFLOP of one product over the whole table
            log(f"[kernels] CE two-pass {tag}: dx {t['dx']:.3f} ms ({2 * unit / t['dx']:.1f} TFLOP/s), "
                f"dW {t['dw']:.3f} ms ({2 * unit / t['dw']:.1f} TFLOP/s), plain dx {t['dx_plain']:.3f} ms, "
                f"plain dW {t['dw_plain']:.3f} ms"
                + (f", forward {t['fwd']:.3f} ms ({unit / t['fwd']:.1f} TFLOP/s), plain forward {t['fwd_plain']:.3f} ms"
                   if "fwd" in t else "")
                + (f"; merged backward {t['merged']:.3f} ms against dx + dW {t['dx'] + t['dw']:.3f} ms"
                   if "merged" in t else "") + f" (best of two windows of median device time) [{card}]")
    # bounds count what this run's data needs: the nv rows of the window and
    # the rows whose label is not LABEL_PAD; each pass is two products. No
    # PyTorch call computes either without the (N, V) logits: library_ms null
    t = times[torch.float32]
    common = (n * d + nv * d + 3 * n) * 4
    ops = {"f32": 4.0 * live * nv * d}
    return {
        "ce_bwd_dx": dict(max_abs_err=errs["dx"], ms=t["dx"], plain_ms=t["dx_plain"], library_ms=None,
                          **bound(common + n * d * 4, ops)),
        "ce_bwd_dw": dict(max_abs_err=errs["dw"], ms=t["dw"], plain_ms=t["dw_plain"], library_ms=None,
                          **bound(common + nv * d * 4, ops)),
        "times": times,
    }


def long_context_kernels(rng, card: str) -> dict:
    """The long-session path's kernels at its shapes: the three blockwise
    attention kernels at (16, L, 256), 4 heads, L = 1024 and 1000 (no tile
    divides it), bf16 and f32, q/k/v as strided slices of one (B, L, 3D)
    tensor, ragged padding, one fully padded row and one row whose first key
    tile is all padding; the fused dropout at (16384, 256); and the gather
    and the fused CE, which the kernels phase times at the flagship's
    shapes, held against their plain versions at this path's too: (16, 1024)
    ids over 20,480 rows with 1,024 positions, and N = 160 rows of x."""
    import torch.nn.functional as F

    from bert4clickpath_torch.ops.kernels.attention import (
        attention_delta,
        blockwise_dkv_reference,
        blockwise_dq_reference,
        blockwise_mha_dkv,
        blockwise_mha_dq,
        blockwise_mha_forward,
        blockwise_mha_reference,
    )
    from bert4clickpath_torch.ops.kernels.dropout import fused_dropout, fused_dropout_reference

    out = {}
    b, d, h = LONG_B, 256, 4
    errs = {}
    with torch.no_grad():
        for seq in (LONG_L, 1000):
            for dtype in (torch.bfloat16, torch.float32):
                qkv, bias = _qkv_bias(b, seq, d, rng, full_pad_row=True)
                bias[1, ..., :70] = -1e9  # a first key tile that is all padding ...
                bias[1, ..., seq - 1] = 0.0  # ... followed by a real key
                qkv = qkv.to(dtype)
                q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
                do = torch.from_numpy(rng.standard_normal((b, seq, d), dtype=np.float32)).cuda().to(dtype)
                got, lse = blockwise_mha_forward(q, k, v, bias, h)
                got2, lse2 = blockwise_mha_forward(q, k, v, bias, h)
                want, want_lse = blockwise_mha_reference(q, k, v, bias, h)
                # both backward versions take the plain forward's out and lse
                args = (q, k, v, bias, want_lse, do, attention_delta(do, want, h), h)
                grads = (blockwise_mha_dq(*args), *blockwise_mha_dkv(*args))
                want_grads = (blockwise_dq_reference(*args), *blockwise_dkv_reference(*args))
                torch.cuda.synchronize()
                tag = f"blockwise attention B={b} L={seq} D={d} H={h} {dtype}"
                if not torch.isfinite(got).all() or not torch.isfinite(lse).all():
                    raise AssertionError(f"{tag}: non-finite forward output")
                if not torch.equal(got, got2) or not torch.equal(lse, lse2):
                    raise AssertionError(f"{tag}: two runs of the forward differ")
                diff = (got.float() - want.float()).abs()
                err = diff.max().item()
                atol, rtol = BLOCKWISE_TOL[dtype]
                used = (diff / (atol + rtol * want.float().abs())).max().item()
                lse_err = ((lse - want_lse).abs() / want_lse.abs().clamp(min=1.0)).max().item()
                log(f"[kernels] {tag}: forward max_abs_err {err:.3e}, {used:.3f} of the tolerance "
                    f"(abs {atol:.0e} + rel {rtol:.1e}); lse max relative error {lse_err:.3e} (tol 1e-5); "
                    "two runs bit-equal")
                if used > 1.0 or lse_err > 1e-5:
                    raise AssertionError(f"{tag}: forward error {err} ({used} of the tolerance), lse {lse_err}")
                tol = BLOCKWISE_BWD_TOL[dtype]
                worst, used = {}, {}
                again = (blockwise_mha_dq(*args), *blockwise_mha_dkv(*args))
                for name, g, w, g2 in zip(("dq", "dk", "dv"), grads, want_grads, again):
                    if not torch.isfinite(g).all():
                        raise AssertionError(f"{tag}: non-finite {name}")
                    if not torch.equal(g, g2):
                        raise AssertionError(f"{tag}: two runs of {name} differ")
                    diff = (g.float() - w.float()).abs()
                    worst[name] = diff.max().item()
                    # batch row 0 is fully padded: held against its own magnitude
                    for part in (slice(0, 1), slice(1, None)):
                        wp = w[part].float().abs()
                        atol = tol["atol"] if "atol" in tol else tol["share"] * max(wp.max().item(), tol["floor"])
                        used[name] = max(used.get(name, 0.0), (diff[part] / (atol + tol["rtol"] * wp)).max().item())
                    if used[name] > 1.0:
                        raise AssertionError(f"{tag}: {name} max error {worst[name]}, {used[name]} of the tolerance")
                log(f"[kernels] {tag}: dq / dk / dv max_abs_err {worst['dq']:.3e} / {worst['dk']:.3e} / "
                    f"{worst['dv']:.3e}, {used['dq']:.3f} / {used['dk']:.3f} / {used['dv']:.3f} of the tolerance "
                    f"({tol}); two runs bit-equal")
                if dtype == torch.bfloat16 and seq == LONG_L:
                    errs = dict(fwd=err, dq=worst["dq"], dkv=max(worst["dk"], worst["dv"]))
                    kept = (q, k, v, bias, do, args)
                    # the dv decision: p rounded once to bf16 (a, shipped) against hi + lo (b)
                    dv_errs = dv_rounding_errors(q, k, v, bias, want_lse, do, h, grads[2],
                                                 [slice(i, i + 1) for i in range(1, b)])
                    log("[kernels] dv = p^T . do at this shape against a dense f64 dv, (rms, max) abs error: "
                        + ", ".join(f"{n} ({e[0]:.4e}, {e[1]:.3e})" for n, e in dv_errs.items())
                        + f"; a / output rms {dv_errs['a'][0] / dv_errs['output'][0]:.4f}, "
                        f"b / output {dv_errs['b'][0] / dv_errs['output'][0]:.4f} (a is taken up to 1.5) [{card}]")
                    if dv_errs["kernel"][0] > 1.5 * dv_errs["output"][0]:
                        raise AssertionError(f"{tag}: the kernel's dv is {dv_errs['kernel'][0] / dv_errs['output'][0]} "
                                             "times the output rounding's error")
        # times at the long-session shape, bf16; the plain versions hold
        # (B, H, L, L) f32 scores (268 MB), so they are timed a few times only
        q, k, v, bias, do, args = kept
        t = {
            "fwd": (device_time_ms(lambda: blockwise_mha_forward(q, k, v, bias, h), 20),
                    device_time_ms(lambda: blockwise_mha_reference(q, k, v, bias, h), 3)),
            "dq": (device_time_ms(lambda: blockwise_mha_dq(*args), 20),
                   device_time_ms(lambda: blockwise_dq_reference(*args), 3)),
            "dkv": (device_time_ms(lambda: blockwise_mha_dkv(*args), 20),
                    device_time_ms(lambda: blockwise_dkv_reference(*args), 3)),
        }
    lib_fwd, lib_bwd = sdpa_times(q, k, v, bias, do, h)
    log(f"[kernels] F.scaled_dot_product_attention B={b} L={LONG_L} bf16 (a yardstick, not used by the port): "
        f"forward {lib_fwd:.4f} ms, backward (dq, dk and dv together) {lib_bwd:.4f} ms [{card}]")
    bounds = attention_bounds(b, LONG_L, d, h, 2)
    flops = {"fwd": 4, "dq": 6, "dkv": 8}
    for key, name in (("fwd", "blockwise_fwd"), ("dq", "blockwise_dq"), ("dkv", "blockwise_dkv")):
        tk, tp = t[key]
        log(f"[kernels] {name} B={b} L={LONG_L} bf16: kernel {tk:.4f} ms "
            f"({flops[key] * b * LONG_L * LONG_L * d / (tk * 1e-3) / 1e12:.1f} TFLOP/s), plain {tp:.4f} ms [{card}]")
        # the library's backward computes dq, dk and dv in one call: its time
        # stands beside both backward kernels
        out[name] = dict(max_abs_err=errs[key], ms=tk, plain_ms=tp, library_ms=lib_fwd if key == "fwd" else lib_bwd,
                         **bounds["fwd_lse" if key == "fwd" else key])

    # fused dropout: bit-equal to the plain Philox version
    rate, n_rows = 0.1, LONG_B * LONG_L
    seed = torch.tensor([20_261_016], dtype=torch.int32, device="cuda")
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.from_numpy(rng.standard_normal((n_rows, d), dtype=np.float32)).cuda().to(dtype)
        got = fused_dropout(x, seed, rate)
        want = fused_dropout_reference(x, seed, rate)
        torch.cuda.synchronize()
        worst = max(worst, (got.float() - want.float()).abs().max().item())
        keep = (got != 0).float().mean().item()
        log(f"[kernels] dropout ({n_rows}, {d}) {dtype} rate {rate}: bit-equal to the plain version: "
            f"{torch.equal(got, want)}; keep rate {keep:.5f}")
        if not torch.equal(got, want):
            raise AssertionError(f"dropout {dtype}: kernel and plain version differ")
        sigma = (rate * (1 - rate) / x.numel()) ** 0.5
        if abs(keep - (1 - rate)) > 5 * sigma + 1e-4:  # + x's own zeros (none expected)
            raise AssertionError(f"dropout {dtype}: keep rate {keep}")
        if dtype == torch.bfloat16:
            xb = x
    g = torch.ones_like(xb).requires_grad_()
    y = fused_dropout(g, seed, rate)
    (dg,) = torch.autograd.grad(y, g, torch.ones_like(y))
    if not torch.equal(y != 0, dg != 0):
        raise AssertionError("dropout: the backward's mask differs from the forward's")
    # the mask depends on the seed and the element's place alone, not on x
    # (an x that is itself 0, one draw in 2^23 of numpy's f32 normal, stays 0)
    if not torch.equal((y != 0) & (xb != 0), fused_dropout(xb, seed, rate) != 0):
        raise AssertionError("dropout: the mask differs between two inputs under one seed")
    times = (
        device_time_ms(lambda: fused_dropout(xb, seed, rate)),
        device_time_ms(lambda: fused_dropout_reference(xb, seed, rate), 5),
        device_time_ms(lambda: F.dropout(xb, rate, training=True)),
    )
    log(f"[kernels] dropout ({n_rows}, {d}) bf16: kernel {times[0] * 1e3:.1f} us, plain Philox {times[1] * 1e3:.1f} us, "
        f"F.dropout (a yardstick, not used by the port) {times[2] * 1e3:.1f} us [{card}]")
    # what a dropout site costs the host (the train steps are host-bound):
    # 200 calls of each back end, the clock stopped after a synchronize
    from bert4clickpath_torch.models.encoder import apply_dropout

    gen = torch.Generator("cuda").manual_seed(SEED)
    host_us = {}
    for impl in ("fused", "mask", "fused", "mask"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            apply_dropout(xb, rate, gen, impl)
        torch.cuda.synchronize()
        host_us.setdefault(impl, []).append((time.perf_counter() - t0) / 200 * 1e6)
    log(f"[kernels] one dropout site's forward, wall us per call over 200 calls, two windows each in turns: "
        f"fused (seed draw + kernel) {host_us['fused']}, mask (rand, compare, scale, where) {host_us['mask']} [{card}]")
    n = xb.numel()
    # per element: one multiply, one compare, and a quarter of ten Philox
    # rounds of ~9 integer operations
    out["dropout"] = dict(max_abs_err=worst, ms=times[0], plain_ms=times[1], library_ms=times[2],
                          **bound(2 * n * 2 + 4, {"f32": n * (2 + 10 * 9 / 4)}))

    # the gather and the CE kernels at this path's shapes (the summary's rows
    # for them stay the flagship's, their main path)
    from bert4clickpath_torch.ops.fused_ce import padded_rows

    v_rows = padded_rows(LONG_ITEMS + 11)
    here = {"gather": gather_kernel_at(rng, v_rows, LONG_L, d, ((LONG_B, torch.float32), (LONG_B, torch.bfloat16))),
            **ce_kernels_at(rng, LONG_B * LONG_P, v_rows, LONG_ITEMS, d)}
    for name, row in here.items():
        log(f"[kernels] {name} at the long-session shape: kernel {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"by {row['bound_by']} (share {row['bound_ms'] / row['ms']:.3f}), plain {row['plain_ms']:.4f} ms [{card}]")
    return out


def flagship_config():
    from bert4clickpath_torch.config import FeatureConfig, HeadConfig, ModelConfig
    from bert4clickpath_torch.ops.fused_ce import padded_rows
    from bert4clickpath_torch.vocab import Vocabulary

    vocab = Vocabulary([f"item_{i}" for i in range(N_ITEMS)])
    cfg = ModelConfig(
        # rows padded as bench.py pads them (55,296 for 54,553 model rows)
        features={"items": FeatureConfig(padded_rows(vocab.model_vocab_size), 256)},
        num_layers=4,
        num_heads=4,
        ffn_dim=1024,
        dropout_rate=0.1,
        max_len=53,
        head=HeadConfig("tied_softmax", output_size=vocab.label_vocab_size),
        dtype="bfloat16",
        qkv_fused=True,
    )
    return cfg, vocab


def _sessions(rng, b):
    lens = rng.integers(1, 61, size=b)  # up to 60 events: some are truncated to 49
    return [[f"item_{i}" for i in rng.integers(0, N_ITEMS, size=n)] for n in lens]


def _check_result(res, b):
    if len(res) != b:
        raise AssertionError(f"{len(res)} results for {b} sessions")
    for items in res:
        scores = np.array([s for _, s in items])
        if len(items) != K or not np.isfinite(scores).all() or (scores > 0).any():
            raise AssertionError(f"bad result row: {items}")
        if (np.diff(scores) > 0).any():
            raise AssertionError("scores not descending")
        if not all(name.startswith("item_") for name, _ in items):
            raise AssertionError(f"non-item in result: {items}")


def profile_requests(served, rng, b: int) -> dict:
    """Where a request's time goes at batch b.

    Host clock, synchronizing between stages, median of PROFILED requests:
    host encode (strings -> ids, copied to the card), forward, catalog scan,
    and the rest (device->host copy, decoding). Then torch.profiler over the
    same number of unsynchronized requests: kernel launches and device time
    per request, the device's busy share, and the kernels with the most
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    stages = {"encode": [], "forward": [], "scan": [], "total": []}
    for _ in range(PROFILED):
        sessions = _sessions(rng, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats, positions = served.encode(sessions)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        x = served.head_inputs(feats, positions)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        scores, ids = served.rank(x, K)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        scores.cpu(), ids.cpu()
        t4 = time.perf_counter()
        for name, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t0)):
            stages[name].append(dt * 1e3)
    med = {name: statistics.median(v) for name, v in stages.items()}
    log(f"[profile] batch {b}: median ms, synchronized stages: encode {med['encode']:.3f}, "
        f"forward {med['forward']:.3f}, scan {med['scan']:.3f}, total {med['total']:.3f}")

    batches = [_sessions(rng, b) for _ in range(PROFILED)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # device events only: the host ones are not read
        t0 = time.perf_counter()
        for sessions in batches:
            served.recommend(sessions, k=K)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels) / PROFILED
    share = device_us / wall_us
    log(f"[profile] batch {b}: {launches:.0f} kernels/request, device busy {device_us / PROFILED:.1f} us "
        f"of {wall_us / PROFILED:.1f} us per request under the profiler (busy share {share:.3f})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile] batch {b}:   {e.self_device_time_total / PROFILED:8.1f} us/request "
            f"x{e.count / PROFILED:5.1f}  {e.key[:80]}")
    return dict(stages_ms=med, kernels_per_request=launches, busy_share=share)


def phase_serve(card: str) -> dict:
    from bert4clickpath_torch.data.synthetic import seeded_state_dict
    from bert4clickpath_torch.ops.kernels import _build
    from bert4clickpath_torch.training.checkpoint import export_serving
    from bert4clickpath_torch.training.serving import ServingModel

    cfg, vocab = flagship_config()
    rng = np.random.default_rng(SEED + 1)
    with tempfile.TemporaryDirectory() as tmp:
        export_serving(tmp, seeded_state_dict(cfg, SEED), cfg, {"items": vocab})
        t0 = time.perf_counter()
        served = ServingModel(tmp, device="cuda", warmup_batches=B_SERVE, warmup_k=K)
        torch.cuda.synchronize()
        log(f"[serve] flagship bundle loaded and warmed (buckets {B_SERVE}) in {time.perf_counter() - t0:.2f} s")

        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        lat = {}
        for b in B_SERVE:
            lat[b] = []
            for _ in range(REQUESTS):
                sessions = _sessions(rng, b)
                t0 = time.perf_counter()
                res = served.recommend(sessions, k=K)  # ends in a device->host copy
                lat[b].append(time.perf_counter() - t0)
                _check_result(res, b)
        counts = _build.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        # one embedding gather and one attention call per layer per request
        n_req = REQUESTS * len(B_SERVE)
        expected = {**dict.fromkeys(counts, 0), "gather": n_req, "attention": n_req * cfg.num_layers}
        log(f"[serve] launches during {n_req} requests: {counts} (expected {expected})")
        for name in ("gather", "attention"):
            if counts[name] == 0:
                raise AssertionError(f"the {name} kernel was not launched by the serving requests")
        if counts != expected:
            raise AssertionError(f"kernel launches {counts} != {expected}")
        profiles = {b: profile_requests(served, rng, b) for b in (1, 64)}
        stats = {}
        for b in B_SERVE:
            ms = np.array(lat[b]) * 1e3
            stats[b] = dict(p50_ms=float(np.percentile(ms, 50)), p90_ms=float(np.percentile(ms, 90)))
            log(f"[serve] batch {b}: p50 {stats[b]['p50_ms']:.3f} ms, p90 {stats[b]['p90_ms']:.3f} ms "
                f"over {REQUESTS} requests [{card}]")
        per_s = 64 / (stats[64]["p50_ms"] / 1e3)
        log(f"[serve] batch 64: {per_s:.1f} sessions/s at p50 [{card}]")
        log(f"[serve] peak device memory during requests: {peak / 2**20:.1f} MiB [{card}]")

        # the same bundle on the CPU (the kernels' plain versions)
        cpu = ServingModel(tmp, device="cpu")
        worst = 0.0
        for b in (1, 8):
            sessions = _sessions(rng, b)
            got, want = served.recommend(sessions, k=K), cpu.recommend(sessions, k=K)
            for g, w in zip(got, want):
                gs, ws = np.array([s for _, s in g]), np.array([s for _, s in w])
                worst = max(worst, float(np.abs(gs - ws).max()))
                gaps = np.diff(ws) < -SERVE_TOL
                sep = np.ones(K, bool)
                sep[:-1] &= gaps
                sep[1:] &= gaps
                if [n for (n, _), s in zip(g, sep) if s] != [n for (n, _), s in zip(w, sep) if s]:
                    raise AssertionError(f"GPU and CPU rankings differ: {g} vs {w}")
        log(f"[serve] GPU vs CPU plain path, batch 1 and 8: max |log-prob diff| {worst:.3e} (tol {SERVE_TOL})")
        if worst > SERVE_TOL:
            raise AssertionError(f"GPU and CPU log-probs differ by {worst} > {SERVE_TOL}")
    return dict(counts=counts, latency=stats, sessions_per_s_b64=per_s, peak_bytes=peak, profiles=profiles)


def _device_profile(fn, steps: int, tag: str, card: str) -> dict:
    """torch.profiler over one call of ``fn`` (``steps`` train steps): the
    device's busy share of the wall time, and the kernels with the most
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # device events only: the host ones are not read
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels) / steps
    share = device_us / wall_us
    log(f"[{tag}] profiled {steps} steps: {launches:.0f} device kernels/step, device busy "
        f"{device_us / steps / 1e3:.3f} ms of {wall_us / steps / 1e3:.3f} ms per step under the "
        f"profiler (busy share {share:.3f}) [{card}]")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    for e in top:
        log(f"[{tag}]   {e.self_device_time_total / steps / 1e3:8.3f} ms/step "
            f"({e.self_device_time_total / device_us:5.1%}) x{e.count / steps:5.1f}  {e.key[:90]}")
    return dict(kernels_per_step=launches, busy_share=share, device_ms_per_step=device_us / steps / 1e3)


def train_stages(model, tx, state, host_iter, num_valid: int, rng, card: str, reps: int = 5) -> dict:
    """Where a train step's time goes: host clock with a synchronize between
    stages, median of ``reps`` steps, the step taken apart as
    ``make_train_step`` composes it (host batch, encoder forward, CE
    forward, CE backward, encoder backward, optimizer)."""
    from bert4clickpath_torch.data.pipeline import to_device
    from bert4clickpath_torch.models.model import head_catalog
    from bert4clickpath_torch.ops.fused_ce import fused_masked_ce_sums

    names = list(state.params)
    params = [state.params[n] for n in names]
    table_name = f"embed_{model.config.item_feature}.weight"
    stages = {k: [] for k in ("host batch", "encoder fwd", "CE fwd", "CE bwd", "encoder bwd", "optimizer")}
    for _ in range(reps):
        marks = []

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        mark()
        batch = to_device(next(host_iter), "cuda")
        mark()
        gathered = model.gather_head_inputs(batch["features"], batch["head_positions"], rng)
        mark()
        x = gathered.detach().requires_grad_()
        table, bias, row_offset, _ = head_catalog(model.config, state.params)
        table = table.detach().requires_grad_()
        total, count = fused_masked_ce_sums(x, table, batch["labels"], row_offset, num_valid, bias=bias)
        loss = total / count.clamp(min=1.0)
        mark()
        dx, dtable = torch.autograd.grad(loss, (x, table))
        mark()
        grads = dict(zip(names, torch.autograd.grad(gathered, params, dx)))
        grads[table_name] = grads[table_name] + dtable
        mark()
        updates, state.opt_state = tx.update(grads, state.opt_state, state.params)
        with torch.no_grad():
            for name, p in state.params.items():
                p.add_(updates[name] * (1e-3 * state.lr_scale))
        mark()
        for name, (a, b) in zip(stages, zip(marks, marks[1:])):
            stages[name].append((b - a) * 1e3)
    med = {k: statistics.median(v) for k, v in stages.items()}
    log("[train] median ms per step, synchronized stages: "
        + ", ".join(f"{k} {v:.3f}" for k, v in med.items()) + f"; sum {sum(med.values()):.3f} [{card}]")
    return med


def phase_train(card: str) -> dict:
    from bert4clickpath_torch.config import TrainConfig
    from bert4clickpath_torch.data.cloze import ClozeBatch, stack_batches
    from bert4clickpath_torch.data.generator import ClickStreamGenerator
    from bert4clickpath_torch.data.pipeline import ClozeDataset, to_device
    from bert4clickpath_torch.data.synthetic import seeded_state_dict
    from bert4clickpath_torch.models.model import ClickstreamModel
    from bert4clickpath_torch.ops.kernels import _build
    from bert4clickpath_torch.training import schedules
    from bert4clickpath_torch.training.train_state import (
        TrainState,
        make_optimizer,
        make_scan_train_step,
        make_train_step,
    )

    t0 = time.perf_counter()
    cfg, _ = flagship_config()
    gen = ClickStreamGenerator(n_items=N_ITEMS, session_cohesiveness=200, seed=0)
    vocab = gen.item_vocab()
    num_valid = vocab.label_vocab_size
    items, _ = gen.generate_sessions(B_TRAIN * 4)
    ds = ClozeDataset(items, vocab, max_items=50)
    it = ds.train_batches(B_TRAIN, seed=0)
    host = [next(it) for _ in range(8)]
    # K steps per scan call over batches resident on the card (cycled copies
    # of the 8 host batches, as bench.py feeds the JAX scan step)
    stacked = to_device(stack_batches([host[i % len(host)] for i in range(K_TRAIN)]), "cuda")
    model = ClickstreamModel(cfg, device="cuda")
    model.load_state_dict(seeded_state_dict(cfg, SEED))
    tx = make_optimizer(TrainConfig(batch_size=B_TRAIN), mu_dtype=torch.bfloat16)
    state = TrainState.create(dict(model.named_parameters()), tx)
    kw = dict(fused_ce_num_valid=num_valid)
    step = make_train_step(model, tx, schedules.constant(1e-3), **kw)
    scan = make_scan_train_step(model, tx, schedules.constant(1e-3), **kw)
    rng = torch.Generator("cuda").manual_seed(SEED)
    log(f"[train] flagship B={B_TRAIN}, {num_valid} labels over {cfg.features['items'].vocab_rows} rows, "
        f"dropout {cfg.dropout_rate}, batcher backend {ds.backend}; set-up {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    state, loss = step(state, to_device(host[0], "cuda"), rng)
    log(f"[train] warm-up step: loss {loss.item():.4f} in {time.perf_counter() - t0:.3f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses, secs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        state, ls = scan(state, stacked, rng)
        ls[-1].item()  # the fetch waits for the K steps
        secs.append(time.perf_counter() - t0)
        losses.append(ls)
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_steps = 2 * K_TRAIN
    per_step = {"gather": 1, "attention": cfg.num_layers, "attention_bwd": cfg.num_layers, "ce_fwd": 1, "ce_bwd": 1}
    expected = {**dict.fromkeys(counts, 0), **{k: v * n_steps for k, v in per_step.items()}}
    log(f"[train] launches during {n_steps} timed steps: {counts} (expected {expected})")
    if counts != expected:
        raise AssertionError(f"kernel launches {counts} != {expected}")
    for i, dt in enumerate(secs):
        log(f"[train] timed call {i + 1}: {K_TRAIN} steps in {dt:.4f} s: {dt / K_TRAIN * 1e3:.3f} ms/step, "
            f"{B_TRAIN * K_TRAIN / dt:.1f} examples/s [{card}]")
    ex_s = B_TRAIN * K_TRAIN / secs[-1]
    log(f"[train] peak device memory over the timed steps: {peak / 2**20:.1f} MiB [{card}]")

    holder = {}

    def profiled():
        holder["state"], holder["losses"] = scan(state, stacked, rng)

    prof = _device_profile(profiled, K_TRAIN, "train", card)
    state = holder["state"]
    losses.append(holder["losses"])
    for _ in range(TRAIN_CALLS - 3):
        state, ls = scan(state, stacked, rng)
        losses.append(ls)
    stages = train_stages(model, tx, state, it, num_valid, rng, card)
    all_losses = torch.cat(losses).float().cpu().numpy()
    first, last = float(all_losses[:10].mean()), float(all_losses[-10:].mean())
    log(f"[train] {len(all_losses)} steps: mean loss of the first 10 {first:.4f}, of the last 10 {last:.4f}")
    if not np.isfinite(all_losses).all():
        raise AssertionError("a non-finite training loss")
    if not last < first:
        raise AssertionError(f"the loss did not fall: first 10 {first}, last 10 {last}")

    # one step at B=32, dropout 0: the card (kernels) vs the CPU (plain
    # versions), in f32 compute and in the flagship's bf16
    t0 = time.perf_counter()
    h0 = host[0]
    small = ClozeBatch({k: v[:B_CHECK] for k, v in h0.features.items()},
                       h0.head_positions[:B_CHECK], h0.labels[:B_CHECK])
    worst_errs = _card_vs_cpu_step(cfg, lambda device: to_device(small, device), num_valid, f"[train] B={B_CHECK}")
    log(f"[train] card vs CPU checks in {time.perf_counter() - t0:.2f} s")
    return dict(counts=counts, examples_per_s=ex_s, ms_per_step=secs[-1] / K_TRAIN * 1e3, peak_bytes=peak,
                profile=prof, stages_ms=stages, first10=first, last10=last, worst_grad_err=worst_errs)


def _long_batches(n: int, batch: int, seed: int) -> list:
    """n synthetic long-session batches (numpy, host)."""
    from bert4clickpath_torch.data.synthetic import synthetic_batch

    rng = np.random.default_rng(seed)
    return [synthetic_batch(rng, batch, LONG_L - 3, LONG_P, LONG_ITEMS) for _ in range(n)]


def _to(batch: dict, device) -> dict:
    return {
        "features": {k: torch.from_numpy(v).to(device) for k, v in batch["features"].items()},
        "head_positions": torch.from_numpy(batch["head_positions"]).to(device),
        "labels": torch.from_numpy(batch["labels"]).to(device),
    }


def _card_vs_cpu_step(cfg, batch_on, num_valid: int, tag: str) -> dict:
    """One step's loss and gradients at dropout 0 from the same weights on
    the card (kernels) and on the CPU (plain versions), in f32 and bf16;
    ``batch_on(device)`` gives the batch there."""
    from bert4clickpath_torch.data.synthetic import seeded_state_dict
    from bert4clickpath_torch.models.model import ClickstreamModel
    from bert4clickpath_torch.training.train_state import make_loss_fn

    worst_errs = {}
    for dtype, (loss_tol, grad_tol) in TRAIN_TOL.items():
        cfg0 = dataclasses.replace(cfg, dropout_rate=0.0, dtype=dtype)
        sd = seeded_state_dict(cfg0, SEED + 2)
        results = []
        for device in ("cuda", "cpu"):
            m = ClickstreamModel(cfg0, device=device)
            m.load_state_dict(sd)
            names = [n for n, _ in m.named_parameters()]
            loss = make_loss_fn(m, fused_ce_num_valid=num_valid)(batch_on(device))
            grads = torch.autograd.grad(loss, [p for _, p in m.named_parameters()])
            results.append((loss.item(), {n: g.float().cpu() for n, g in zip(names, grads)}))
        (gpu_loss, gpu_g), (cpu_loss, cpu_g) = results

        def rel_err(n):
            # a separate key projection's bias has a zero gradient in exact
            # arithmetic (the softmax does not see a shift of all keys): both
            # sides compute rounding noise there, so their difference is held
            # against the same layer's query bias gradient
            ref = cpu_g[n.replace("wk.bias", "wq.bias")]
            return ((gpu_g[n] - cpu_g[n]).norm() / ref.norm().clamp(min=1e-30)).item()

        errs = {n: rel_err(n) for n in cpu_g}
        worst = max(errs, key=lambda n: (not np.isfinite(errs[n]), errs[n]))
        log(f"{tag} dropout 0 {dtype}, card vs CPU: loss {gpu_loss:.6f} vs {cpu_loss:.6f} "
            f"(|diff| {abs(gpu_loss - cpu_loss):.2e}, tol {loss_tol:.0e}); relative gradient norm error "
            f"median {statistics.median(errs.values()):.2e}, worst {errs[worst]:.3e} at {worst} (tol {grad_tol:.0e})")
        if not abs(gpu_loss - cpu_loss) <= loss_tol or not errs[worst] <= grad_tol:
            raise AssertionError(
                f"card and CPU train steps differ ({dtype}): loss {gpu_loss} vs {cpu_loss}, {worst} {errs[worst]}"
            )
        worst_errs[dtype] = errs[worst]
    return worst_errs


def phase_long_train(card: str) -> dict:
    """The long-session train step: B=16, L=1024, full width and depth."""
    from bert4clickpath_torch.config import TrainConfig
    from bert4clickpath_torch.data.synthetic import long_context_config, seeded_state_dict
    from bert4clickpath_torch.models.model import ClickstreamModel
    from bert4clickpath_torch.ops.kernels import _build
    from bert4clickpath_torch.training import schedules
    from bert4clickpath_torch.training.train_state import TrainState, make_optimizer, make_train_step

    cfg = long_context_config(LONG_L, LONG_ITEMS)
    batches = [_to(b, "cuda") for b in _long_batches(4, LONG_B, SEED)]
    log(f"[long-train] B={LONG_B} L={LONG_L}, {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} heads, "
        f"{LONG_ITEMS} labels over {cfg.features['items'].vocab_rows} rows, dropout {cfg.dropout_rate}, {cfg.dtype}")

    def make(dropout_impl):
        model = ClickstreamModel(cfg, device="cuda", dropout_impl=dropout_impl)
        model.load_state_dict(seeded_state_dict(cfg, SEED))
        tx = make_optimizer(TrainConfig(batch_size=LONG_B), mu_dtype=torch.bfloat16)
        state = TrainState.create(dict(model.named_parameters()), tx)
        step = make_train_step(model, tx, schedules.constant(1e-3), fused_ce_num_valid=LONG_ITEMS)
        return state, step, torch.Generator("cuda").manual_seed(SEED)

    per_step = {"gather": 1, "blockwise_fwd": cfg.num_layers, "blockwise_dq": cfg.num_layers,
                "blockwise_dkv": cfg.num_layers, "dropout": 2 * (1 + 2 * cfg.num_layers), "ce_fwd": 1, "ce_bwd": 1,
                "attention": 0, "attention_bwd": 0}  # dropout: 9 sites, forward and backward
    expected = {**dict.fromkeys(_build.launch_counts(), 0), **{k: v * LONG_TIMED for k, v in per_step.items()}}

    def warm_up(impl, state, step, rng):
        t0 = time.perf_counter()
        state, loss = step(state, batches[0], rng)
        log(f"[long-train] dropout={impl}: warm-up step: loss {loss.item():.4f} in {time.perf_counter() - t0:.3f} s")
        return state, loss

    def timed_window(impl, state, step, rng, want):
        """LONG_TIMED steps: (state, losses, ms/step, peak bytes, counts)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        got = []
        t0 = time.perf_counter()
        for i in range(LONG_TIMED):
            state, loss = step(state, batches[(i + 1) % len(batches)], rng)
            got.append(loss)
        got[-1].item()  # the fetch waits for the steps
        dt = (time.perf_counter() - t0) / LONG_TIMED
        counts, peak = _build.launch_counts(), torch.cuda.max_memory_allocated()
        log(f"[long-train] dropout={impl}: launches during {LONG_TIMED} timed steps: {counts} (expected {want})")
        if counts != want:
            raise AssertionError(f"kernel launches {counts} != {want}")
        log(f"[long-train] dropout={impl}: {dt * 1e3:.3f} ms/step, {LONG_B / dt:.1f} examples/s, "
            f"peak device memory {peak / 2**20:.1f} MiB [{card}]")
        return state, got, dict(ms_per_step=dt * 1e3, examples_per_s=LONG_B / dt, peak_bytes=peak), counts

    # the two back ends in turns: fused, mask, fused again
    state, step, rng = make("fused")
    state, warm = warm_up("fused", state, step, rng)
    state, first_losses, fused_a, counts = timed_window("fused", state, step, rng, expected)
    mask_state, mask_step, mask_rng = make("mask")
    mask_state, _ = warm_up("mask", mask_state, mask_step, mask_rng)
    _, _, mask_t, _ = timed_window("mask", mask_state, mask_step, mask_rng, {**expected, "dropout": 0})
    del mask_state, mask_step
    state, second_losses, fused_b, _ = timed_window("fused", state, step, rng, expected)
    losses = [warm, *first_losses, *second_losses]
    result = dict(counts=counts, fused=fused_a, fused_again=fused_b, mask=mask_t)
    holder = {"state": state}

    def profiled():
        for i in range(5):
            holder["state"], ls = step(holder["state"], batches[i % len(batches)], rng)
            losses.append(ls)

    result["profile"] = _device_profile(profiled, 5, "long-train", card)
    device_ms = result["profile"]["device_ms_per_step"]
    log(f"[long-train] device time {device_ms:.3f} ms/step (profiled kernels) against {fused_b['ms_per_step']:.3f} "
        f"ms/step unprofiled: busy share {device_ms / fused_b['ms_per_step']:.3f} [{card}]")
    state = holder["state"]
    while len(losses) < LONG_STEPS:
        state, ls = step(state, batches[len(losses) % len(batches)], rng)
        losses.append(ls)
    all_losses = torch.stack(losses).float().cpu().numpy()
    first, last = float(all_losses[:10].mean()), float(all_losses[-10:].mean())
    log(f"[long-train] {len(all_losses)} steps: mean loss of the first 10 {first:.4f}, of the last 10 {last:.4f}")
    if not np.isfinite(all_losses).all():
        raise AssertionError("a non-finite training loss")
    if not last < first:
        raise AssertionError(f"the loss did not fall: first 10 {first}, last 10 {last}")
    t0 = time.perf_counter()
    small = _long_batches(1, LONG_B_CHECK, SEED + 3)[0]
    result["worst_grad_err"] = _card_vs_cpu_step(
        cfg, lambda device: _to(small, device), LONG_ITEMS, f"[long-train] B={LONG_B_CHECK}")
    log(f"[long-train] B={LONG_B_CHECK} card vs CPU checks in {time.perf_counter() - t0:.2f} s")
    result.update(first10=first, last10=last)
    return result


def phase_long_serve(card: str) -> dict:
    """Long sessions served on the card: batch 8, ~1,000 items per session."""
    from bert4clickpath_torch.data.synthetic import long_context_config, seeded_state_dict
    from bert4clickpath_torch.ops.kernels import _build
    from bert4clickpath_torch.training.checkpoint import export_serving
    from bert4clickpath_torch.training.serving import ServingModel
    from bert4clickpath_torch.vocab import Vocabulary

    cfg = long_context_config(LONG_L, LONG_ITEMS)
    vocab = Vocabulary([f"item_{i}" for i in range(LONG_ITEMS)])
    rng = np.random.default_rng(SEED + 4)

    def sessions():
        lens = rng.integers(900, 1100, size=LONG_B_SERVE)  # some are truncated to 1,020
        return [[f"item_{i}" for i in rng.integers(0, LONG_ITEMS, size=n)] for n in lens]

    with tempfile.TemporaryDirectory() as tmp:
        export_serving(tmp, seeded_state_dict(cfg, SEED), cfg, {"items": vocab})
        served = ServingModel(tmp, device="cuda", warmup_batches=(LONG_B_SERVE,), warmup_k=K)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lat = []
        for _ in range(LONG_REQUESTS):
            batch = sessions()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            res = served.recommend(batch, k=K)
            lat.append((time.perf_counter() - t0) * 1e3)
            counts = {k: n for k, n in _build.launch_counts().items() if n}
            _check_result(res, LONG_B_SERVE)
            expected = {"gather": 1, "blockwise_fwd": cfg.num_layers}
            if counts != expected:
                raise AssertionError(f"kernel launches of one request {counts} != {expected}")
        peak = torch.cuda.max_memory_allocated()
        log(f"[long-serve] {LONG_REQUESTS} requests of batch {LONG_B_SERVE}, ~1,000 items per session: launches per "
            f"request {counts}; latency ms {[round(x, 3) for x in lat]}, median {statistics.median(lat):.3f} ms; "
            f"peak device memory {peak / 2**20:.1f} MiB [{card}]")
        cpu = ServingModel(tmp, device="cpu")
        batch = sessions()
        got, want = served.recommend(batch, k=K), cpu.recommend(batch, k=K)
        worst = 0.0
        for g, w in zip(got, want):
            worst = max(worst, float(np.abs(np.array([s for _, s in g]) - np.array([s for _, s in w])).max()))
        log(f"[long-serve] GPU vs CPU plain path, batch {LONG_B_SERVE}: max |top-{K} log-prob diff| {worst:.3e} "
            f"(tol {SERVE_TOL})")
        if worst > SERVE_TOL:
            raise AssertionError(f"GPU and CPU log-probs differ by {worst} > {SERVE_TOL}")
    return dict(median_ms=statistics.median(lat), peak_bytes=peak, counts=counts)


def phase_wide_train(card: str) -> dict:
    """The training run as a user starts it: ``train_torch.py``'s ``main`` in
    this process on the wide tied-head model (4 layers, d_model 384, 6 heads),
    whose CE backward is the two-pass pair."""
    from bert4clickpath_torch.data.pipeline import to_device
    from bert4clickpath_torch.data.synthetic import seeded_state_dict
    from bert4clickpath_torch.models.model import ClickstreamModel
    from bert4clickpath_torch.ops import metrics as metrics_lib
    from bert4clickpath_torch.ops.kernels import _build
    from bert4clickpath_torch.training import checkpoint as ckpt_lib
    from bert4clickpath_torch.training.serving import ServingModel
    from bert4clickpath_torch.training.train_state import eval_params, make_eval_step
    from examples.bert4rec import train_torch

    model_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", f"wide_train_{os.getpid()}")
    shutil.rmtree(model_dir, ignore_errors=True)
    argv = ["--preset", "tpu", "--d_model", str(WIDE_D), "--heads", str(WIDE_HEADS), "--layers", str(WIDE_LAYERS),
            "--qkv_fused", "--simulated", "--n_items", str(N_ITEMS), "--n_sessions", str(WIDE_SESSIONS),
            "--batch", str(B_TRAIN), "--steps_per_epoch", str(WIDE_STEPS), "--eval_batches", str(WIDE_EVAL_BATCHES),
            "--eval_batch", str(B_TRAIN), "--ckpt_keep", "1", "--mu_dtype", "bfloat16", "--model_dir", model_dir]

    def history():
        with open(os.path.join(model_dir, "history.jsonl")) as f:
            return [json.loads(line) for line in f]

    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        run = train_torch.main(argv + ["--epochs", str(WIDE_EPOCHS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _build.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        cfg = run.model.config
        n_train, n_eval = WIDE_EPOCHS * WIDE_STEPS, WIDE_EPOCHS * WIDE_EVAL_BATCHES
        per_step = {"gather": 1, "attention": cfg.num_layers, "attention_bwd": cfg.num_layers, "ce_fwd": 1,
                    "ce_bwd_dx": 1, "ce_bwd_dw": 1, "ce_bwd": 0}
        per_eval = {"gather": 1, "attention": cfg.num_layers}  # no CE kernel: the chunked scan is plain PyTorch
        expected = {k: per_step.get(k, 0) * n_train + per_eval.get(k, 0) * n_eval for k in counts}
        log(f"[wide-train] {WIDE_EPOCHS} epochs of {WIDE_STEPS} steps at B={B_TRAIN}, {WIDE_EVAL_BATCHES} eval batches "
            f"each, in {wall:.2f} s (data generation included); launches {counts} (expected {expected})")
        if counts != expected:
            raise AssertionError(f"kernel launches {counts} != {expected}")
        records = history()
        if len(records) != WIDE_EPOCHS or any("early_stop" in r for r in records):
            raise AssertionError(f"history.jsonl: {records}")
        for r in records:
            log(f"[wide-train] {r}")
            if not np.isfinite(r["train_loss"]) or not np.isfinite(r["val_loss"]):
                raise AssertionError(f"a non-finite loss: {r}")
            for key in ("val_recall@5", "val_recall@10", "val_ndcg@5", "val_ndcg@10"):
                if not 0.0 <= r[key] <= 1.0:
                    raise AssertionError(f"{key} outside [0, 1]: {r}")
        if not records[-1]["train_loss"] < records[0]["train_loss"]:
            raise AssertionError(f"the train loss did not fall: {[r['train_loss'] for r in records]}")
        last = records[-1]
        log(f"[wide-train] epoch {last['epoch']} as the trainer timed it: {last['epoch_seconds'] / WIDE_STEPS * 1e3:.3f} "
            f"ms/step (host batches included), eval {last['eval_seconds'] / WIDE_EVAL_BATCHES * 1e3:.3f} ms/batch; "
            f"peak device memory {peak / 2**20:.1f} MiB [{card}]")
        ckpts = sorted(os.listdir(os.path.join(model_dir, "ckpts")))
        export = os.path.join(model_dir, "export")
        if len(ckpts) != 1 or not os.path.isfile(os.path.join(model_dir, "ckpts", ckpts[0], ckpt_lib.STATE_FILE)):
            raise AssertionError(f"expected one committed checkpoint, found {ckpts}")
        if not os.path.isfile(os.path.join(export, ckpt_lib.PARAMS_FILE)):
            raise AssertionError("no serving export")
        saved_step = int(ckpts[0].split("_")[1])

        # one step and one eval batch alone: the exact launches of each
        state, trainer, ds = run.state, run.trainer, run.dataset
        it = ds.train_batches(B_TRAIN, seed=SEED + 7)
        rng = torch.Generator("cuda").manual_seed(SEED + 7)
        batches = [to_device(next(it), "cuda") for _ in range(4)]
        evals = [to_device(b, "cuda") for b in ds.eval_batches(B_TRAIN, limit_batches=WIDE_EVAL_BATCHES)]
        _build.reset_launch_counts()
        state, _ = trainer.train_step(state, batches[0], rng)
        step_counts = {k: n for k, n in _build.launch_counts().items() if n}
        _build.reset_launch_counts()
        trainer.eval_step(eval_params(state), evals[0])
        eval_counts = {k: n for k, n in _build.launch_counts().items() if n}
        log(f"[wide-train] launches of one train step {step_counts}, of one eval batch {eval_counts}")
        if step_counts != {k: n for k, n in per_step.items() if n} or eval_counts != per_eval:
            raise AssertionError(f"launches per step {step_counts} / per eval batch {eval_counts}")

        # a timed window and a profiled one, batches already on the card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(WIDE_TIMED):
            state, loss = trainer.train_step(state, batches[i % len(batches)], rng)
        loss.item()
        ms_step = (time.perf_counter() - t0) / WIDE_TIMED * 1e3
        t0 = time.perf_counter()
        acc = None
        for b in evals:
            stats = trainer.eval_step(eval_params(state), b)
            acc = stats if acc is None else metrics_lib.merge(acc, stats)
        metrics_lib.finalize(acc)
        ms_eval = (time.perf_counter() - t0) / len(evals) * 1e3
        log(f"[wide-train] {WIDE_TIMED} train steps: {ms_step:.3f} ms/step, {B_TRAIN / ms_step * 1e3:.1f} examples/s; "
            f"{len(evals)} eval batches of {B_TRAIN}: {ms_eval:.3f} ms/batch [{card}]")
        holder = {"state": state}

        def profiled():
            for i in range(10):
                holder["state"], _ = trainer.train_step(holder["state"], batches[i % len(batches)], rng)

        prof = _device_profile(profiled, 10, "wide-train", card)
        log(f"[wide-train] device time {prof['device_ms_per_step']:.3f} ms/step (profiled kernels) against {ms_step:.3f} "
            f"ms/step unprofiled: busy share {prof['device_ms_per_step'] / ms_step:.3f} [{card}]")

        # resume for one more epoch: the step count continues from the saved one
        del run, state, trainer, holder, batches, evals
        train_torch.main(argv + ["--epochs", "1", "--resume"])
        resumed = history()[WIDE_EPOCHS]
        log(f"[wide-train] resumed from step {saved_step}: {resumed}")
        if resumed["step"] != saved_step + WIDE_STEPS:
            raise AssertionError(f"the resumed run's step {resumed['step']} != {saved_step} + {WIDE_STEPS}")

        # training to serving: the trained export answers a request
        served = ServingModel(export, device="cuda", warmup_batches=(8,), warmup_k=K)
        _build.reset_launch_counts()
        res = served.recommend(_sessions(np.random.default_rng(SEED + 8), 8), k=K)
        _check_result(res, 8)
        serve_counts = {k: n for k, n in _build.launch_counts().items() if n}
        log(f"[wide-train] the trained export served a batch-8 request: launches {serve_counts}; first row {res[0][:3]}")
        if serve_counts != per_eval:
            raise AssertionError(f"serving launches {serve_counts} != {per_eval}")
        del served
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)

    # one train step and one eval batch at B=32, dropout 0: card vs CPU
    t0 = time.perf_counter()
    h0 = next(ds.train_batches(B_CHECK, seed=SEED + 9))
    num_valid = cfg.head.output_size
    worst = _card_vs_cpu_step(cfg, lambda device: to_device(h0, device), num_valid, f"[wide-train] B={B_CHECK}")
    e0 = next(iter(ds.eval_batches(B_CHECK, limit_batches=1)))
    for dtype, tol in EVAL_TOL.items():
        cfg0 = dataclasses.replace(cfg, dropout_rate=0.0, dtype=dtype)
        sd = seeded_state_dict(cfg0, SEED + 2)
        sums = []
        for device in ("cuda", "cpu"):
            m = ClickstreamModel(cfg0, device=device)
            m.load_state_dict(sd)
            stats = make_eval_step(m, chunked_num_valid=num_valid)(dict(m.named_parameters()), to_device(e0, device))
            sums.append({k: float(v) for k, v in stats.items()})
        gpu, cpu = sums
        # the hit sums move by one whole hit where rounding reorders a near tie
        err = {k: abs(gpu[k] - cpu[k]) / max(abs(cpu[k]), 1.0) for k in cpu}
        log(f"[wide-train] eval batch B={B_CHECK} {dtype}, card vs CPU: {gpu} vs {cpu}; worst relative "
            f"difference {max(err.values()):.2e} (tol {tol:.0e})")
        if gpu["n"] != cpu["n"] or err["loss_sum"] > tol:
            raise AssertionError(f"card and CPU eval sums differ ({dtype}): {gpu} vs {cpu}")
        for key in (k for k in cpu if "@" in k):
            if abs(gpu[key] - cpu[key]) > 1.0 + tol * abs(cpu[key]):
                raise AssertionError(f"card and CPU eval sums differ ({dtype}) at {key}: {gpu[key]} vs {cpu[key]}")
    log(f"[wide-train] card vs CPU checks in {time.perf_counter() - t0:.2f} s")
    return dict(counts=counts, step_counts=step_counts, ms_per_step=ms_step, examples_per_s=B_TRAIN / ms_step * 1e3,
                eval_ms_per_batch=ms_eval, peak_bytes=peak, profile=prof, worst_grad_err=worst,
                train_loss=[r["train_loss"] for r in records])


def main() -> None:
    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        walls[name] = time.perf_counter() - t0
        log(f"[{name}] phase wall time {walls[name]:.2f} s")
        return result

    card = timed("device", phase_device)
    timed("build", phase_build)
    kernels = timed("kernels", phase_kernels, card)
    timed("serve", phase_serve, card)
    train = timed("train", phase_train, card)
    long_train = timed("long-train", phase_long_train, card)
    timed("long-serve", phase_long_serve, card)
    wide_train = timed("wide-train", phase_wide_train, card)
    # name, source, TPU kernel, counter (= key in `kernels`), the main path
    # whose launches are reported: the flagship train step's timed window,
    # the long-session train step's, or one step of the wide training run
    pallas = "bert4clickpath_tpu/ops/pallas/"
    rows = [
        ("fused_gather_scale_pos", "gather.cu", "gather.py:37", "gather", train),
        ("fused_mha_fwd", "attention.cu", "attention.py:54", "attention", train),
        ("fused_mha_bwd", "attention.cu", "attention.py:76", "attention_bwd", train),
        ("fused_ce_fwd", "fused_ce.cu", "fused_ce.py:134", "ce_fwd", train),
        ("fused_ce_bwd", "fused_ce.cu", "fused_ce.py:761", "ce_bwd", train),
        ("fused_ce_bwd_dx", "fused_ce_two_pass.cu", "fused_ce.py:293", "ce_bwd_dx", wide_train),
        ("fused_ce_bwd_dw", "fused_ce_two_pass.cu", "fused_ce.py:321", "ce_bwd_dw", wide_train),
        ("blockwise_mha_fwd", "attention_blockwise.cu", "attention.py:198", "blockwise_fwd", long_train),
        ("blockwise_mha_dq", "attention_blockwise.cu", "attention.py:245", "blockwise_dq", long_train),
        ("blockwise_mha_dkv", "attention_blockwise.cu", "attention.py:283", "blockwise_dkv", long_train),
        ("fused_dropout", "dropout.cu", "dropout.py:46", "dropout", long_train),
    ]
    summary = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"bert4clickpath_torch/csrc/{src}",
            "replaces": pallas + tpu,
            "launches": path["counts"][counter],
            **{k: kernels[counter][k] for k in
               ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        }
        for name, src, tpu, counter, path in rows
    ]}
    for row in summary["kernels"]:
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was not launched on its main path")
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
