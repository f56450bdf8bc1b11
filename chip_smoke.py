"""Drive the PyTorch port's serving path, its flagship train step, its
long-session path and a whole training run of the wide model once on one
CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  — requires a CUDA card; prints its name and power limit
   (nvidia-smi) and PyTorch's TF32 flags (left off: the catalog scan is f32,
   and so are the plain versions the kernels are held to; the CE backward
   kernels (merged, dx and dW) run their own products on the tensor cores,
   each f32 operand split into two tf32 terms inside the kernel, three
   products with f32 sums).
2. build   — builds the port's CUDA kernels from ``bert4clickpath_torch/csrc``
   with nvcc for sm_90a (one compile per source, in parallel) and prints the
   build time and ptxas' report, and the counts of warpgroup products
   (HGMMA) and TMA loads (UTMALDG) in ``cuobjdump -sass`` of the CE
   forward's two instances (f32 and bf16 x), the merged CE backward's four
   (D <= 128 and 256, f32 and bf16 x; with its TMA reduce-adds, UTMAREDG)
   and the bf16 blockwise attention forward's, dq's and dk/dv's four each
   (head-width tiles 16, 32, 64 and 128); raises unless each has them.
3. kernels — holds each of the eleven kernels against its plain PyTorch version
   on the card at the shapes its main path gives it, with the tolerance
   stated, and times both (CUDA events; median device time of warm calls):
   the gather and whole-row attention at the flagship's shapes (the bf16
   forward on the tensor cores at batch 1, 8, 64 and 256, two runs
   bit-equal; the bf16 backward on the tensor cores, two runs bit-equal, its dv from p kept as
   two bf16 terms measured against p rounded once and against a dense f64
   dv; the f32 backward the scalar kernel), the fused CE
   at its training shape (the forward on TMA loads and wgmma products, f32
   and bf16 x, two runs bit-equal, its schedule's two constants swept; the
   merged backward on TMA loads, wgmma products and TMA reduce-adds, run
   twice: dW and db bit-equal, dx within the tolerance each time and the
   two within 1e-5 of the largest |dx| of each other; both rated at tf32 x3
   with the f32 rating beside; the backward also held and timed with bf16
   x, and held again at D=128, its other instance, on the same rows and
   table), the three blockwise attention kernels at
   (16, 1024, 256) and at L=1000 in bf16 (all three on the tensor cores,
   the forward on TMA loads and wgmma products, two runs bit-equal, the
   dk/dv kernel's dv from p rounded to bf16 measured against p kept as two
   bf16 terms and against a dense f64 dv) and f32 (the scalar kernels), the
   bf16 forward again at batch 8, L=100 (below one 128-key stage) with
   head widths 32 and 128 (H=8 and 2; two runs bit-equal), none of them
   copying an input for its tensor maps (the copy counter stays 0 here, in
   the long-session phases and over the whole run), the fused dropout at
   (16384, 256) (bit-equal to its plain Philox version), the gather and
   the fused CE once more at the long-session path's shapes, and the
   two-pass CE backward (dx and dW kernels) with the forward at N=2,560,
   V=55,296, D=384 in f32 and bf16, with and without a bias (two runs of
   each pass bit-equal), then at D=256 timed beside the merged backward; the dx pass's numerics table (the
   shipped three TF32 products, and copies of its source built with one
   TF32 product and with three bf16 ones, beside the plain version's f32
   FMA, each against a dense f64 oracle at D=384 and 256, and on the card
   tests' wider logits, with its time); the CE forward, dx and dW kernels and the ``fused_softmax_ce``
   op with gradients at D=1,024, a width no kernel refuses. Beside each kernel
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
9. heads — the task heads and their example scripts at the flagship's width and
   depth (4 layers, d_model 256, 4 heads, FFN 1024, L=53, qkv_fused, bf16,
   dropout 0.1, B=256), each on its script's batches and configuration
   (``examples/chained/train_torch.py``, ``examples/tasks/multilabel_torch.py``,
   ``examples/bert4rec/transfer_torch.py``, ``multivariable_torch.py``):
   the transfer chain's Cloze pretrain (tied softmax, fused CE), its
   encoder restored under a binary head on [CLS]; the chained binary model
   (history 41 + basket 8, segment routing and embeddings, pos_weight 2);
   the multilabel model on [CLS] (12 classes); the multi-variable model
   (items 224 + events 32, softmax MLP head over the catalog through the
   fused CE with bias). Each takes a warm-up step and 20 timed steps (exact
   launches per step, finite losses, the last 5 below the first 5) and 2
   eval batches (exact launches); one train step at B=32 card vs CPU in f32
   and bf16 (the MLP heads' bf16 step held against the CPU's f32 step, see
   BF16_TO_F32), one eval batch card vs CPU (the binary counts equal but for
   logits within the tolerance of 0); the whole-row attention forward and
   backward held on the chained batch's pads inside the sequence; the
   multi-variable export served with dict sessions against the CPU; device
   profiles of the binary and multi-variable steps; then the four scripts'
   ``main`` on the card at small sizes.

10. sharded-ce — the CE kernels with their ``row_start`` on 4 row shards of
   the flagship table padded by ``padded_vocab_rows`` (57,344 rows): at the
   flagship's CE inputs (N = 2,560, D = 256, the merged backward) and the
   wide ones (D = 384, the pair), without and with a bias; each shard's
   forward and backward with its row_start, combined as the vocab-sharded
   tier combines them (the max, then the rescaled sum; dx summed, dW
   stacked, db in its window); logz, dx, dW and db held against the
   unsharded kernel call and the plain version; exact launches (4 forward,
   4 backward); times of the 4 shards beside the unsharded call.
11. tiers — two ranks sharing the card over gloo (``parallel/mesh.py:spawn``,
   ``parallel/drive.py``): the data-parallel tier at data = 2 and the
   vocab-sharded tier at model = 2 (``tied_bias``) on the flagship, three
   f32 steps each held against the one-process step on the same global
   batches (loss 1e-4; after one step the summed gradients 1e-3 of each
   norm; after three the parameters 1e-3 of each norm, or 2 lr steps
   element by element where Adam's first steps amplify rounding; the SPMD
   table gathered back), one eval batch each against the one-process eval, eight
   bf16 steps each over two batches cycled with falling losses, two bf16
   steps of the SPMD tier on
   the wide model (the CE pair), exact launches per rank and step; and the
   sharded checkpoint: the f32 vocab-sharded tier run RESUME_STEPS steps at
   once and again with a checkpoint after half of them
   (``spmd.save_sharded_checkpoint``: gathered, saved by rank 0), restored
   onto a fresh model and re-sharded (``spmd.restore_sharded_state``):
   the restored state bit-equal to the saved one; the later steps' losses
   and parameters held as a tier is held against one process (the merged
   CE backward's dx atomics make two runs of one step differ in the last
   bits).
12. tp-tiers — the tensor-parallel tier, the composed tensor-parallel and
   vocab-sharded tier and sampled softmax over the row-sharded table, two
   ranks sharing the card over gloo at (data, model) = (1, 2), global
   B=256: tp and tp_spmd on the flagship's widths with separate q/k/v (2
   heads and 512 FFN units a rank; ``tied_bias`` on tp_spmd), sampled_spmd
   on the flagship as it is with 1,024 negatives; f32 runs held against
   the one-process step on the same batches as in phase 11 (one step, three
   steps, an eval batch; one tp_spmd step in pre-LN; the sampled tier on
   the same negatives), eight bf16 steps of each with dropout 0.1 (the
   fused dropout kernel on tp_spmd) and a falling loss, the model ranks'
   encoder outputs under dropout bit-equal, the sampled negatives equal on
   both ranks, exact launches per rank and step.
13. cli-dp — ``torchrun --nproc_per_node=1 examples/bert4rec/train_torch.py
   --parallel dp``: a world of one over NCCL on the card, two epochs.
14. sampled — sampled softmax with 1,024 negatives: one flagship step at
   B=32 card vs CPU with the same negatives (f32), then one step at B=256
   on the card (launches: gather and attention only).
15. large-catalog — ``examples/large_catalog/stress_torch.py`` (BASELINE
   configs[4]) on one rank: its ``main`` at the defaults (10M items, a
   10,000,384 x 128 f32 table built in place, B=256, bf16, dropout 0.1),
   STRESS_STEPS steps with exact launches per step (CE forward 1, merged
   CE backward 1, whole-row attention 2 + 2, no gather), finite losses, the
   first within 0.5 of ln(10^7), peak memory printed; ``--sampled 8192``
   (no CE launch); the CE forward and merged backward at the stress shape
   (N=2,560; f32 x, as the step gives it, and bf16 x) against the plain
   version over 32 row windows (the sharded-ce phase's tolerances; its
   (N, V) logits would be 102 GB at once), timed beside it with their
   bounds, the merged backward's dx atomics timed against a copy built
   without them; the same checks at V=9,000,000, D=256 (V x D > 2^31);
   the whole-row attention at the stress model's (256, 53, 128), H=4
   (dh = 32) against plain and SDPA.
16. multihost — ``examples/multihost/demo_torch.py --procs 2``: 2 hosts of
   4 ranks sharing the card over gloo, every rank started with torchrun's
   environment; all ranks' losses agree and fall.

The line before the last is the card's name and power limit; the line
before that is the kernels' JSON summary; the last line is the device JSON.
Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
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
# the merged backward keeps its atomic adds for dx (ROADMAP.md Queue 3): two
# runs of its f32 dx may differ by this much of the largest |dx|
CE_DX_REPEAT = 1e-5
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
# The heads with an MLP (binary, multilabel, softmax) put one more bf16 ReLU
# between the loss and the encoder, and the binary and multilabel losses
# read one routed position (or one short segment) a row, so their gradients
# enter the encoder through a few rows: bf16 rounding moves them far more
# than it moves the tied head's Cloze step. At the flagship's width, B=32 and
# seeded weights, the CPU's own bf16 step is 1.6-7.9% (median over the
# parameters; worst 4.6-13%) from its f32 step on these heads; card vs CPU
# in bf16 measured 5.0% (worst 6.8%) on the binary [CLS] head and 3.6%
# (worst 5.3%) on the multi-variable softmax head (NVIDIA H100 80GB HBM3,
# 700 W): the 5e-2 above sits inside the noise. For those heads the
# card's bf16 step is held against the CPU's f32 step instead, no further
# from it than this multiple of the CPU's own bf16 step, in median and worst
# over the parameters (measured 0.72 to 1.41 of it); the f32 steps are held
# to each other at TRAIN_TOL as for every head.
BF16_TO_F32 = 2.0
# long-session path: examples/long_context/bench_torch.py --seq_len 1024 --batch 16
LONG_L, LONG_B, LONG_ITEMS, LONG_P = 1024, 16, 20_000, 10
LONG_TIMED = 20  # timed steps per dropout back end
LONG_STEPS = 60  # steps in all with the fused back end
LONG_B_CHECK = 2  # card vs CPU step
LONG_B_SERVE, LONG_REQUESTS = 8, 5
FWD_SHORT_L = 100  # the bf16 blockwise forward below one 128-key stage
# wide training run: examples/bert4rec/train_torch.py --preset tpu --d_model 384
# --heads 6 --layers 4 --qkv_fused on simulated sessions at Beauty's catalog size
WIDE_D, WIDE_HEADS, WIDE_LAYERS = 384, 6, 4
WIDE_STEPS, WIDE_EPOCHS, WIDE_EVAL_BATCHES, WIDE_SESSIONS = 40, 2, 8, 20_000
WIDE_TIMED = 20  # train steps in the timed window after the run
DX_TARGETS = (132, 264, 528, 1056, 2112)  # dx grid sizes timed at the wide shapes (1 to 16 waves of blocks)
# the CE forward's schedule, timed at the flagship's and long-session shapes:
# the units (row tile, vocab split) it aims at, and the fewest vocab tiles a
# split walks
FWD_GRID_SWEEPS = {"FWD_TARGET_UNITS": (2112, 4224, 8448, 16896, 33792), "FWD_MIN_TILES": (1, 2, 4, 8, 16)}
# heads phase: the task heads and their example scripts (examples/chained/train_torch.py,
# examples/tasks/multilabel_torch.py, examples/bert4rec/transfer_torch.py and
# multivariable_torch.py) at the flagship's width and depth, B=256, max_len 53
HEADS_BATCHES = 8  # host batches of B_TRAIN per model, cycled
HEADS_STEPS = 20  # timed train steps per model, after a warm-up step
HEADS_EVAL = 2  # eval batches per model
HEADS_PROFILED = 10  # train steps in a profiled window
HEADS_MAX_ITEMS = 50  # sessions of up to 50 items: 53 tokens
HEADS_HIST = 41  # chained: history 41 + basket 8, chained_length 53
N_CLASSES, N_EVENTS, POS_WEIGHT = 12, 8, 2.0
MV_DIMS = (224, 32)  # items + events embedding widths: the JAX script's 7:1, summing to d_model 256
# binary and multilabel eval logits, card vs CPU in f32: sums in another order
HEADS_LOGIT_TOL = 1e-4
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
# vocab-sharded CE: row shards of the padded flagship table (padded_vocab_rows)
SHARDS = 4
# parallel tiers on two ranks sharing the card: f32 steps held against one
# process; bf16 steps over two batches cycled, whose loss must fall (from
# seeded weights the loss sits near log(54,542) for the first steps, and a
# few distinct batches do not move it)
TIER_STEPS, TIER_BF16_STEPS, TIER_LR = 3, 8, 1e-3
RESUME_STEPS = 4  # the sharded-checkpoint run: checkpointed after half of them
# Adam's first steps are lr * sign(g): a gradient of rounding size (a ReLU
# unit barely active) steps a whole lr either way, so after three steps a
# tier's parameter may sit past 1e-3 of its norm from the one-process run's
# on a few elements. Such a parameter is held to the share of its elements
# apart by more than TIER_LR / 10, at most TIER_FLIP_SHARE (a fault that
# moves a whole parameter, or its steps' size, moves nearly every element
# past that). Adam's first moment after the three steps, the summed
# gradients of the steps, is held within TIER_MU_REL of each norm. Set from
# the readings on an H100 (PERF.md, section 6): at most 1.95e-3 of a
# parameter's elements apart (2 of 1,024), the first moment 6.6e-3 apart
TIER_FLIP_SHARE = 1e-2
TIER_MU_REL = 2e-2
SAMPLED = 1024  # sampled softmax: negatives a step
# the large-catalog phase: examples/large_catalog/stress_torch.py at its
# defaults (10M items, D = 128, B = 256), its sampled variant, and the CE
# kernels at the stress shape held against the plain version taken over row
# windows of the table (its (N, V) logits would be 102 GB at once)
STRESS_STEPS, STRESS_SAMPLED, STRESS_SAMPLED_STEPS = 20, 8192, 5
STRESS_WINDOWS = 32  # 312,512 rows a window: 3.2 GB of f32 logits
# the V x D > 2^31 case: 9.2 GB of table, every row id x D past int32 beyond
# row 8,388,608
BIG_V, BIG_D, BIG_WINDOWS = 9_000_000, 256, 64
MULTIHOST_PROCS = 2  # examples/multihost/demo_torch.py: hosts of 4 ranks each
# the numerics of the CE kernels' f32 products (csrc/fused_ce_mma.cuh
# kDxNumerics, tf32 x3): the operand type their products run at and how many
# products each product of the function takes
DX_RATING = ("tf32", 3)


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
    the memory rate, and its operations (by operand type) over their peak:
    the published peaks of one H100 SXM (dense), ``utils/profiling.py``'s
    H100_PEAKS (device memory bytes/s; bf16 and TF32 tensor FLOP/s; f32
    FLOP/s outside the tensor cores, also used for integer work)."""
    from bert4clickpath_torch.utils.profiling import H100_PEAKS as peak

    by_bytes = n_bytes / peak["bytes"] * 1e3
    by_ops = sum(n / peak[kind] for kind, n in ops.items()) * 1e3
    return dict(bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops else "operations")


def log_ce_fwd(tag: str, n: int, nv: int, d: int, dtype, ms: float, plain_ms: float, card: str) -> dict:
    """Logs the CE forward's time beside its bound at both ratings and its
    plain version's time at n rows of x over the nv rows of the window (the
    blinded rest needs no product): x and the window's table rows in, (m, l)
    out; its one product 2 n nv d rated at the numerics of the kernel that
    runs it (f32 x: DX_RATING, three tf32 products; bf16 x: one bf16
    product), and the same product at the f32 peak. Returns the former."""
    n_bytes = n * d * (2 if dtype == torch.bfloat16 else 4) + nv * d * 4 + 2 * n * 4
    prod = 2.0 * n * nv * d
    kind, terms = DX_RATING
    rated = bound(n_bytes, {"bf16": prod} if dtype == torch.bfloat16 else {kind: terms * prod})
    at_f32 = bound(n_bytes, {"f32": prod})
    numerics = "one bf16 product" if dtype == torch.bfloat16 else "tf32 x3"
    log(f"[kernels] CE forward {tag}: {ms:.4f} ms; bound {rated['bound_ms']:.4f} ms at {numerics} (share "
        f"{rated['bound_ms'] / ms:.3f}), {at_f32['bound_ms']:.4f} ms rated at f32 (share "
        f"{at_f32['bound_ms'] / ms:.3f}); plain {plain_ms:.4f} ms ({plain_ms / ms:.2f}x the kernel) [{card}]")
    return rated


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


def device_time_ms(fn, reps: int = 50, warm: int = 5) -> float:
    """Median device time of one call, CUDA events around it, after ``warm``
    calls. A short GPU sleep before each call keeps the device busy while
    the host enqueues, so the events bracket device work, not launch gaps."""
    for _ in range(warm):
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
        if "registers" in line or "Compiling entry" in line or "spill" in line or "Performance" in line:
            log(f"[build] {line.strip()}")
    forward_sass(_build)


def forward_sass(_build) -> None:
    """Counts, in ``cuobjdump -sass`` of the built library, of the warpgroup
    products (HGMMA) and TMA loads (UTMALDG) per instance of the kernels
    built on them: the CE forward (``ce_fwd_wgmma_kernel``, f32 and bf16 x),
    the merged CE backward (``ce_bwd_merged_wgmma_kernel``, D <= 128 and D
    <= 256, f32 and bf16 x; it adds with TMA reduce-adds, UTMAREDG, counted
    beside) and the
    bf16 blockwise attention forward, dq and dk/dv
    (``bmha_fwd_wgmma_kernel``, ``bmha_dq_wgmma_kernel``,
    ``bmha_dkv_wgmma_kernel``, one instance per head-width tile each);
    raises unless each instance has both."""
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", _build.library()._name], capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if any(k in fn for k in ("ce_fwd_wgmma_kernel", "bmha_fwd_wgmma_kernel", "bmha_dq_wgmma_kernel",
                                     "bmha_dkv_wgmma_kernel", "ce_bwd_merged_wgmma_kernel")):
                counts[fn] = {"HGMMA": 0, "UTMALDG": 0, **({"UTMAREDG": 0} if "ce_bwd_merged" in fn else {})}
        elif fn in counts:
            for op in counts[fn]:
                counts[fn][op] += op in line

    kinds = {"ce_fwd": "CE forward", "ce_bwd_merged": "CE merged backward", "bmha_fwd": "blockwise forward",
             "bmha_dq": "blockwise dq", "bmha_dkv": "blockwise dk/dv"}

    def name(fn):
        args = re.search(r"kernelI(\w+?)EEv", fn)
        kind = next(v for k, v in kinds.items() if f"{k}_wgmma" in fn)
        return f"{kind} <{args.group(1) if args else fn[-40:]}>"

    log("[build] SASS (cuobjdump -sass): " + "; ".join(
        f"{name(fn)}: " + ", ".join(f"{op} {n}" for op, n in c.items()) for fn, c in sorted(counts.items())))
    per_kind = {k: sum(f"{k}_wgmma" in fn for fn in counts) for k in kinds}
    if per_kind != {"ce_fwd": 2, "ce_bwd_merged": 4, "bmha_fwd": 4, "bmha_dq": 4, "bmha_dkv": 4} or any(
            min(c.values()) == 0 for c in counts.values()):
        raise AssertionError(f"the CE forward and backward and the blockwise kernels are not built on wgmma and "
                             f"TMA: {counts}")


def _qkv_bias(b, seq, d, rng, full_pad_row: bool, tokens=None):
    """Random (b, seq, 3d) q/k/v and the padding bias of ``tokens`` ((b, seq)
    int32 ids; None: ragged padding at the end of each row, and with
    ``full_pad_row`` row 0 all pads)."""
    from bert4clickpath_torch.constants import PAD_ID
    from bert4clickpath_torch.ops.masking import padding_bias

    qkv = torch.from_numpy(rng.standard_normal((b, seq, 3 * d), dtype=np.float32)).cuda()
    if tokens is None:
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


def attention_forward_at(rng, b: int, seq: int, d: int, h: int, tokens=None) -> tuple[float, tuple[float, float]]:
    """The whole-row attention forward against its plain version at
    (b, seq, d) with h heads, bf16 (the tensor-core kernel) and f32 (the
    scalar one), qkv as strided column slices of one (b, seq, 3d) tensor,
    ragged padding and (b > 1) one fully padded row, or the pads of
    ``tokens``, two runs bit-equal; returns the bf16 case's error and its
    (kernel, plain) ms."""
    from bert4clickpath_torch.ops.kernels.attention import mha, mha_reference

    out = None
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            qkv, bias = _qkv_bias(b, seq, d, rng, full_pad_row=(b > 1), tokens=tokens)
            qkv = qkv.to(dtype)
            q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
            got = mha(q, k, v, bias, h)
            again = mha(q, k, v, bias, h)
            want = mha_reference(q, k, v, bias, h)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"attention B={b} D={d} {dtype}: non-finite output")
            if not torch.equal(got, again):
                raise AssertionError(f"attention B={b} D={d} {dtype}: two runs differ")
            err = (got.float() - want.float()).abs().max().item()
            log(f"[kernels] attention B={b} L={seq} D={d} H={h} {dtype}: "
                f"max_abs_err {err:.3e} ({err / ATTN_TOL[dtype]:.3f} of the tol {ATTN_TOL[dtype]:.0e}); "
                "two runs bit-equal")
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


def attention_backward_at(rng, b: int, seq: int, d: int, h: int, card: str, tokens=None):
    """The whole-row attention backward against its plain version at
    (b, seq, d) with h heads, bf16 (the tensor-core kernel) and f32 (the
    scalar one), q/k/v as strided slices of one (b, seq, 3d) tensor, ragged
    padding and one fully padded row (or the pads of ``tokens``), two runs
    bit-equal; in bf16 also the
    kernel's dv (p as two bf16 terms) against a dense f64 dv beside p
    rounded once; returns the bf16 case's error, its (kernel, plain) ms and
    the f32 case's (q, k, v, bias, do)."""
    from bert4clickpath_torch.ops.kernels.attention import mha_backward, mha_backward_reference

    err_bf16, times = None, None
    for dtype in (torch.bfloat16, torch.float32):
        qkv, bias = _qkv_bias(b, seq, d, rng, full_pad_row=True, tokens=tokens)
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
    held = {b: attention_forward_at(rng, b, seq, d, h) for b in (*B_SERVE, B_TRAIN)}
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
    out.update(ce_kernels_at(rng, B_TRAIN * 10, 55_296, N_ITEMS, d, card=card))
    # the merged backward's other instance (D <= 128: 64 table rows a unit,
    # the large catalog's width) on the flagship's rows and table
    ce_kernels_at(rng, B_TRAIN * 10, 55_296, N_ITEMS, 128, card=card, sweep=False)
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
    dx_numerics_table(rng, card)
    ce_wide_row_at(rng, card)
    return out


def _ce_inputs(rng, n: int, v_rows: int, nv: int, d: int, w_scale: float, off: int = 10):
    """f32 x (n, d), a (v_rows, d) table of N(0, 1) * w_scale whose window is
    rows off .. off + nv, labels with a fifth LABEL_PAD, dnll the masked
    mean's, and logz from the plain forward: the dx pass's arguments."""
    from bert4clickpath_torch.constants import LABEL_PAD
    from bert4clickpath_torch.ops.fused_ce import _labels_model
    from bert4clickpath_torch.ops.kernels import fused_ce as k

    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).cuda()
    table = torch.from_numpy(rng.standard_normal((v_rows, d), dtype=np.float32) * w_scale).cuda()
    labels_np = rng.integers(0, nv, size=n).astype(np.int32)
    labels_np[rng.random(n) < 0.2] = LABEL_PAD
    labels = torch.from_numpy(labels_np).cuda()
    mask = (labels != LABEL_PAD).float()
    m, l = k.ce_stats_reference(x, table, None, off, nv)
    return (x, table, None, _labels_model(labels, off), m + torch.log(l), mask / mask.sum(), off, nv)


def _dx_f64(x, table, bias, lab, logz, dnll, off, nv) -> torch.Tensor:
    """dx of the same inputs in f64 (logz and dnll as given), 256 rows at a
    time: the oracle of the numerics decision."""
    w64 = table.double()
    rows = torch.arange(table.shape[0], device=x.device)
    inside = (rows >= off) & (rows < off + nv)
    out = []
    for r0 in range(0, x.shape[0], 256):
        s = x[r0 : r0 + 256].double() @ w64.T
        if bias is not None:
            s = s + bias.double()
        s = torch.where(inside, s, torch.full_like(s, -1e30))
        p = torch.exp(s - logz[r0 : r0 + 256].double()[:, None])
        onehot = (rows[None, :] == lab[r0 : r0 + 256].long()[:, None]).double()
        out.append((dnll[r0 : r0 + 256].double()[:, None] * (p - onehot)) @ w64)
    return torch.cat(out)


def _tune_module():
    """examples/long_context/tune_blockwise_bwd.py, which builds copies of
    the kernel sources with constants replaced and swaps their entries in."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "long_context",
                        "tune_blockwise_bwd.py")
    spec = importlib.util.spec_from_file_location("tune_blockwise_bwd", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dx_numerics_table(rng, card: str) -> dict:
    """The dx numerics decision: the shipped dx pass (tf32 x3) and the
    candidates measured beside it, each a copy of ``fused_ce_two_pass.cu``
    built with another ``kDxNumerics`` (one TF32 product; hi + lo bf16 in
    three products), against a dense f64 oracle of the same f32 inputs: rms
    error, largest error over the largest |dx|, and the largest error
    against the plain version over its largest |dx| (what CE_GRAD_REL = 1e-4
    holds), with the plain version's own (cuBLAS f32 FMA) f64 errors beside.
    At the main path's inputs (N=2,560, V=55,296, table N(0, 0.02^2): logits
    of a few tenths) at D=384 and 256, timed in turns; and at the card
    tests' wider logits (table N(0, 0.5^2): logits of ~10 at D=384, ~13 at
    D=713, ~16 at D=1,024), errors only. Raises if the shipped numerics
    misses 1e-4 anywhere."""
    from bert4clickpath_torch.ops.kernels import _build
    from bert4clickpath_torch.ops.kernels import fused_ce as k

    tune = _tune_module()
    entry = ["b4cp_ce_bwd_dx"]
    t0 = time.perf_counter()
    real = _build.library()
    built = tune.build_variants({"tf32": {"kDxNumerics": "kDxTf32"}, "bf16x3": {"kDxNumerics": "kDxBf16x3"}},
                                ["fused_ce_two_pass.cu"], entry)
    log(f"[kernels] dx numerics candidates built in {time.perf_counter() - t0:.1f} s")
    libs = {"tf32x3": real, **{name: tune._Swapped(real, lib, entry) for name, lib in built.items()}}
    cases = [("main", 384, 0.02, B_TRAIN * 10, 55_296, N_ITEMS), ("main", 256, 0.02, B_TRAIN * 10, 55_296, N_ITEMS),
             ("wide logits", 384, 0.5, B_TRAIN * 10, 55_296, N_ITEMS), ("wide logits", 713, 0.5, 130, 700, 683),
             ("wide logits", 1024, 0.5, 130, 700, 683)]
    table_rows = {}
    try:
        for kind, d, w_scale, n, v_rows, nv in cases:
            args = _ce_inputs(rng, n, v_rows, nv, d, w_scale)
            oracle = _dx_f64(*args)
            scale = oracle.abs().max().item()
            plain = k.ce_backward_dx_reference(*args)
            results = {"plain": plain}
            for name, lib in libs.items():
                _build._lib = lib
                results[name] = k.ce_backward_dx(*args)
            times = {}
            if kind == "main":
                for _ in range(2):  # in turns
                    for name, lib in libs.items():
                        _build._lib = lib
                        ms = device_time_ms(lambda: k.ce_backward_dx(*args), reps=10)
                        times[name] = min(ms, times.get(name, ms))
            _build._lib = real
            for name, got in results.items():
                err = got.double() - oracle
                row = dict(rms=err.square().mean().sqrt().item(), max_rel=err.abs().max().item() / scale,
                           vs_plain=(got - plain).abs().max().item() / plain.abs().max().item(), ms=times.get(name))
                table_rows[kind, d, name] = row
                log(f"[kernels] dx numerics {kind} N={n} V={v_rows} D={d} {name}: rms error {row['rms']:.4e}, "
                    f"max error / max|dx| {row['max_rel']:.3e} (f64 oracle), against the plain version "
                    f"{row['vs_plain']:.3e} (held to {CE_GRAD_REL:.0e})"
                    + (f", {row['ms']:.4f} ms" if row["ms"] is not None else "") + f" [{card}]")
    finally:
        _build._lib = real
    missed = {key: row["vs_plain"] for key, row in table_rows.items() if key[2] == "tf32x3" and row["vs_plain"] > CE_GRAD_REL}
    log(f"[kernels] dx numerics shipped: tf32x3; it misses {CE_GRAD_REL:.0e} at {missed or 'no case'}")
    if missed:
        raise AssertionError(f"the shipped dx numerics tf32x3 misses the f32 tolerance: {missed}")
    return table_rows


def ce_wide_row_at(rng, card: str, d: int = 1024) -> None:
    """The CE kernels at a row width past every whole tile they once held:
    forward, dx and dW against their plain versions (``ce_two_pass_at`` at
    N=2,560, V=55,296, f32 and bf16, with and without a bias), then the
    ``fused_softmax_ce`` op with gradients against the dense f32 oracle."""
    from bert4clickpath_torch.constants import LABEL_PAD
    from bert4clickpath_torch.ops.fused_ce import dense_softmax_ce, fused_softmax_ce

    ce_two_pass_at(rng, B_TRAIN * 10, 55_296, N_ITEMS, d, card)
    n, v_rows, off, nv = B_TRAIN * 10, 55_296, 10, N_ITEMS
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).cuda().requires_grad_()
    table = torch.from_numpy(rng.standard_normal((v_rows, d), dtype=np.float32) * 0.02).cuda().requires_grad_()
    labels_np = rng.integers(0, nv, size=n).astype(np.int32)
    labels_np[rng.random(n) < 0.2] = LABEL_PAD
    labels = torch.from_numpy(labels_np).cuda()
    nll = fused_softmax_ce(x, table, labels, off, nv)
    got = torch.autograd.grad(nll.sum(), (x, table))
    want = dense_softmax_ce(x, table, labels, off, nv)
    want_g = torch.autograd.grad(want.sum(), (x, table))
    err = (nll - want).abs().max().item()
    log(f"[kernels] fused_softmax_ce N={n} V={v_rows} D={d} f32: nll max_abs_err {err:.3e} (tol {CE_LOGZ_TOL:.0e})")
    if not torch.isfinite(nll).all() or err > CE_LOGZ_TOL:
        raise AssertionError(f"fused_softmax_ce at D={d}: nll error {err}")
    for name, g, w in zip(("dx", "dtable"), got, want_g):
        _held(f"fused_softmax_ce D={d} {name}", g, w, CE_GRAD_REL)


def ce_kernels_at(rng, n: int, v_rows: int, nv: int, d: int, off: int = 10, card: str = "",
                  sweep: bool = True) -> dict:
    """The fused CE kernels against their plain versions at n rows of f32 x
    over a (v_rows, d) f32 table whose valid window is rows off .. off + nv,
    without and with a bias, a fifth of the labels LABEL_PAD; times and
    bounds of the case without a bias. The backward is run twice: dW and db
    must repeat bit for bit (the merged kernel writes them once), dx is
    held to the tolerance in each run (it sums across vocab tiles with
    atomic adds). Where the merged kernel takes d, it is also held and timed
    on the same inputs in bf16 (within 2e-2 of the largest magnitude, dx
    + one bf16 ulp of the value; dW and db bit-equal over two runs). With
    ``sweep``, the forward's schedule constants are swept too."""
    from bert4clickpath_torch.constants import LABEL_PAD
    from bert4clickpath_torch.ops.fused_ce import _labels_model
    from bert4clickpath_torch.ops.kernels.fused_ce import (
        ce_backward,
        ce_backward_reference,
        ce_backward_route,
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
        m2, l2 = ce_stats(x, table, bias, off, nv)
        wm, wl = ce_stats_reference(x, table, bias, off, nv)
        logz, want_logz = m + torch.log(l), wm + torch.log(wl)
        if not torch.equal(m, m2) or not torch.equal(l, l2):
            raise AssertionError(f"CE forward (bias={with_bias}): two runs differ (nothing in it is atomic)")
        # bf16 x too (the train step's CE input is f32; the card tests hold
        # both): the table rounded to bf16, one exact bf16 product
        xb = x.to(torch.bfloat16)
        mb, lb = ce_stats(xb, table, bias, off, nv)
        mb2, lb2 = ce_stats(xb, table, bias, off, nv)
        wmb, wlb = ce_stats_reference(xb, table, bias, off, nv)
        err_b = (mb + torch.log(lb) - wmb - torch.log(wlb)).abs().max().item()
        log(f"[kernels] CE forward N={n} V={v_rows} D={d} bf16 x (bias={with_bias}): logz max_abs_err {err_b:.3e} "
            f"(tol {CE_LOGZ_TOL:.0e})")
        if not torch.equal(mb, mb2) or not torch.equal(lb, lb2) or err_b > CE_LOGZ_TOL:
            raise AssertionError(f"CE forward bf16 x (bias={with_bias}): error {err_b}, or two runs differ")
        got = ce_backward(x, table, bias, lab, want_logz, dnll, off, nv)
        again = ce_backward(x, table, bias, lab, want_logz, dnll, off, nv)
        want = ce_backward_reference(x, table, bias, lab, want_logz, dnll, off, nv)
        torch.cuda.synchronize()
        if not torch.equal(got[1], again[1]) or (with_bias and not torch.equal(got[2], again[2])):
            raise AssertionError(f"CE backward (bias={with_bias}): two runs of dW or db differ")
        dx_runs = (got[0] - again[0]).abs().max().item()
        err = (logz - want_logz).abs().max().item()
        if not torch.isfinite(logz).all() or err > CE_LOGZ_TOL:
            raise AssertionError(f"CE forward (bias={with_bias}): logz error {err} > {CE_LOGZ_TOL}")
        fwd_err = max(fwd_err, err)
        for name, g, g2, w in zip(("dx", "dW", "db"), got, again, want):
            if w is None:
                continue
            e = max((g - w).abs().max().item(), (g2 - w).abs().max().item())
            scale = w.abs().max().item()
            log(f"[kernels] CE backward N={n} V={v_rows} {name} (bias={with_bias}): max_abs_err {e:.3e}, "
                f"largest |value| {scale:.3e} (tol {CE_GRAD_REL:.0e} of it)")
            if not torch.isfinite(g).all() or e > CE_GRAD_REL * scale:
                raise AssertionError(f"CE backward {name} (bias={with_bias}): error {e} > {CE_GRAD_REL} x {scale}")
            bwd_err = max(bwd_err, e)
        dx_scale = want[0].abs().max().item()
        log(f"[kernels] CE backward N={n} V={v_rows} D={d} (bias={with_bias}): two runs, dW and db bit-equal, "
            f"dx apart by {dx_runs:.3e} at most ({dx_runs / dx_scale:.2e} of the largest |dx|, held to "
            f"{CE_DX_REPEAT:.0e}: atomic adds)")
        if dx_runs > CE_DX_REPEAT * dx_scale:
            raise AssertionError(f"CE backward (bias={with_bias}): two runs of dx differ by {dx_runs}")
        blinded = torch.ones(v_rows, dtype=torch.bool, device=x.device)
        blinded[off : off + nv] = False
        if not bool((got[1][blinded] == 0).all()):
            raise AssertionError("CE backward: a blinded table row got a gradient")
        if ce_backward_route(d) == "merged":
            merged_bf16_at(xb, table, bias, lab, want_logz, dnll, off, nv, blinded)
        log(f"[kernels] CE forward N={n} V={v_rows} D={d} f32 (bias={with_bias}): logz max_abs_err {err:.3e} "
            f"(tol {CE_LOGZ_TOL:.0e}), two runs bit-equal; LABEL_PAD rows {int((labels == LABEL_PAD).sum())}")
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
                    f"({tflops:.1f} TFLOP/s of f32 products), plain {tp:.3f} ms (median device time)")
            if sweep:
                ce_fwd_grid(x, table, want_logz, off, nv, card)
            if ce_backward_route(d) == "merged":
                xb = x.to(torch.bfloat16)
                tb = (device_time_ms(lambda: ce_backward(xb, table, None, lab, want_logz, dnll, off, nv), reps=20),
                      device_time_ms(lambda: ce_backward_reference(xb, table, None, lab, want_logz, dnll, off, nv),
                                     reps=20))
                log(f"[kernels] CE merged backward N={n} V={v_rows} D={d} bf16 x: kernel {tb[0]:.3f} ms, "
                    f"plain {tb[1]:.3f} ms (median device time) [{card}]")
    # bounds count what this run's data needs: the nv rows of the valid
    # window (the rest is blinded), and in the backward only the rows whose
    # label is not LABEL_PAD (the others' dnll is 0). No PyTorch call
    # computes either function without the (N, V) logits: library_ms null
    # Each product is rated at the numerics of the kernel that runs it
    # (DX_RATING, tf32 x3: three tf32 products for each), the f32 rating
    # logged beside, as for the two passes.
    live = int(mask.sum().item())
    out["ce_fwd"] = dict(max_abs_err=fwd_err, ms=t_fwd[0], plain_ms=t_fwd[1], library_ms=None,
                         **log_ce_fwd(f"N={n} V={v_rows} D={d} f32", n, nv, d, torch.float32, *t_fwd, card))
    bwd_bytes = (2 * n * d + 2 * nv * d + 3 * n) * 4
    kind, terms = DX_RATING
    rated = bound(bwd_bytes, {kind: terms * 6.0 * live * nv * d})
    at_f32 = bound(bwd_bytes, {"f32": 6.0 * live * nv * d})
    out["ce_bwd"] = dict(max_abs_err=bwd_err, ms=t_bwd[0], plain_ms=t_bwd[1], library_ms=None, **rated)
    log(f"[kernels] CE backward ({ce_backward_route(d)}) N={n} V={v_rows} D={d} f32: {t_bwd[0]:.4f} ms; bound "
        f"{rated['bound_ms']:.4f} ms at tf32 x3 ({terms} {kind} products for each of three; share "
        f"{rated['bound_ms'] / t_bwd[0]:.3f}), {at_f32['bound_ms']:.4f} ms rated at f32 (share "
        f"{at_f32['bound_ms'] / t_bwd[0]:.3f}); plain {t_bwd[1]:.4f} ms [{card}]")
    return out


def merged_bf16_at(xb, table, bias, lab, logz, dnll, off: int, nv: int, blinded) -> None:
    """The merged backward on bf16 x against its plain version: dx, dW and
    db within 2e-2 of the largest magnitude (A rounds to bf16 before the
    products and may round an entry the other way), dx besides one bf16 ulp
    of the value; dW and db bit-equal over two runs; blinded rows 0."""
    from bert4clickpath_torch.ops.kernels.fused_ce import ce_backward_merged, ce_backward_reference

    n, d = xb.shape
    got = ce_backward_merged(xb, table, bias, lab, logz, dnll, off, nv)
    again = ce_backward_merged(xb, table, bias, lab, logz, dnll, off, nv)
    want = ce_backward_reference(xb, table, bias, lab, logz, dnll, off, nv)
    torch.cuda.synchronize()
    if not torch.equal(got[1], again[1]) or (bias is not None and not torch.equal(got[2], again[2])):
        raise AssertionError(f"CE merged backward bf16 x D={d}: two runs of dW or db differ")
    used = []
    for name, g, w in zip(("dx", "dW", "db"), got, want):
        if w is None:
            continue
        w = w.float()
        tol = 2e-2 * w.abs().max().item() + (2.0**-7 * w.abs() if name == "dx" else 0.0)
        used.append(((g.float() - w).abs() / tol).max().item())
        if not torch.isfinite(g).all() or used[-1] > 1.0:
            raise AssertionError(f"CE merged backward bf16 x D={d} {name}: {used[-1]} of its tolerance")
    if not bool((got[1][blinded] == 0).all()):
        raise AssertionError("CE merged backward bf16 x: a blinded table row got a gradient")
    log(f"[kernels] CE merged backward N={n} V={table.shape[0]} D={d} bf16 x (bias={bias is not None}): dx / dW"
        f"{' / db' if bias is not None else ''} use " + " / ".join(f"{u:.3f}" for u in used)
        + " of 2e-2 of the largest (dx + one bf16 ulp); dW and db bit-equal over two runs")


def ce_fwd_grid(x, table, want_logz, off: int, nv: int, card: str) -> None:
    """The CE forward with each of its schedule's constants (FWD_GRID_SWEEPS:
    the units the vocab split aims at, the fewest tiles a split walks) set
    to each value in turn, the other shipped (the wrapper's constant set for
    the call and put back), logz held to CE_LOGZ_TOL at each, timed in
    turns: best of two windows of median device time per value."""
    from bert4clickpath_torch.ops.kernels import fused_ce as k

    n, v_rows = x.shape[0], table.shape[0]
    row_tiles = -(-n // k.FWD_ROWS)
    for name, values in FWD_GRID_SWEEPS.items():
        shipped, sweep = getattr(k, name), {}
        for _ in range(2):  # in turns
            for value in values:
                setattr(k, name, value)
                try:
                    m, l = k.ce_stats(x, table, None, off, nv)
                    err = (m + torch.log(l) - want_logz).abs().max().item()
                    if err > CE_LOGZ_TOL:
                        raise AssertionError(f"CE forward, {name} = {value}: logz error {err}")
                    ms = device_time_ms(lambda: k.ce_stats(x, table, None, off, nv), reps=10)
                    splits = k.ce_splits(n, v_rows)[0]
                finally:
                    setattr(k, name, shipped)
                sweep[value] = (splits, min(ms, sweep.get(value, (0, ms))[1]))
        log(f"[kernels] CE forward N={n} V={v_rows} D={x.shape[1]} f32, schedule by {name} (splits, units, ms): "
            + ", ".join(f"{value}: ({s}, {row_tiles * s}, {ms:.4f})" for value, (s, ms) in sweep.items())
            + f"; shipped {shipped} (best of two windows of median device time) [{card}]")


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
            m, l = k.ce_stats(x, table, bias, off, nv)
            m2, l2 = k.ce_stats(x, table, bias, off, nv)
            e = (m + torch.log(l) - want_logz).abs().max().item()
            log(f"[kernels] CE forward {tag}: logz max_abs_err {e:.3e} (tol {CE_LOGZ_TOL:.0e}), two runs bit-equal")
            if not torch.isfinite(m + torch.log(l)).all() or e > CE_LOGZ_TOL:
                raise AssertionError(f"CE forward {tag}: logz error {e} > {CE_LOGZ_TOL}")
            if not torch.equal(m, m2) or not torch.equal(l, l2):
                raise AssertionError(f"CE forward {tag}: two runs differ (nothing in it is atomic)")
            errs["fwd"] = max(errs["fwd"], e)
            args = (x, table, bias, lab, want_logz, dnll, off, nv)
            dx = k.ce_backward_dx(*args)
            dw, db = k.ce_backward_dw(*args)
            again = k.ce_backward_dx(*args)
            dw2, db2 = k.ce_backward_dw(*args)
            want_dx = k.ce_backward_dx_reference(*args)
            want_dw, want_db = k.ce_backward_dw_reference(*args)
            torch.cuda.synchronize()
            e_dx = _held(f"CE dx pass {tag}", dx, want_dx, rel, elem)
            e_dw = _held(f"CE dW pass {tag} dW", dw, want_dw, rel)
            if with_bias:
                e_dw = max(e_dw, _held(f"CE dW pass {tag} db", db, want_db, CE_GRAD_REL))
            if not torch.equal(dx, again):
                raise AssertionError(f"CE dx pass {tag}: two runs differ (it sums in a fixed order)")
            if not torch.equal(dw, dw2) or (with_bias and not torch.equal(db, db2)):
                raise AssertionError(f"CE dW pass {tag}: two runs differ (it sums in a fixed order)")
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
            log_ce_fwd(f"N={n} V={v_rows} D={d} {dtype}", n, nv, d, dtype, t["fwd"], t["fwd_plain"], card)
            unit = 2.0 * n * v_rows * d / 1e9  # GFLOP of one product over the whole table
            log(f"[kernels] CE two-pass {tag}: dx {t['dx']:.3f} ms ({2 * unit / t['dx']:.1f} TFLOP/s), "
                f"dW {t['dw']:.3f} ms ({2 * unit / t['dw']:.1f} TFLOP/s), plain dx {t['dx_plain']:.3f} ms, "
                f"plain dW {t['dw_plain']:.3f} ms"
                + f", forward {t['fwd']:.3f} ms ({unit / t['fwd']:.1f} TFLOP/s), plain forward {t['fwd_plain']:.3f} ms"
                + (f"; merged backward {t['merged']:.3f} ms against dx + dW {t['dx'] + t['dw']:.3f} ms"
                   if "merged" in t else "") + f" (best of two windows of median device time) [{card}]")
    # bounds count what this run's data needs: the nv rows of the window and
    # the rows whose label is not LABEL_PAD; each pass is two products, rated
    # at the numerics' operand type, three products each for a split (the
    # f32 rating logged beside). No PyTorch call computes either without the
    # (N, V) logits: library_ms null
    t = times[torch.float32]
    common = (n * d + nv * d + 3 * n) * 4
    ops = {"f32": 4.0 * live * nv * d}
    kind, terms = DX_RATING
    bounds = {}
    for name, label, out_bytes in (("dx", "dx", n * d * 4), ("dw", "dW", nv * d * 4)):
        bounds[name] = bound(common + out_bytes, {kind: terms * 4.0 * live * nv * d})
        log(f"[kernels] CE {label} pass N={n} V={v_rows} D={d} f32: {t[name]:.4f} ms; bound "
            f"{bounds[name]['bound_ms']:.4f} ms at tf32 x3 ({terms} {kind} products each; share "
            f"{bounds[name]['bound_ms'] / t[name]:.3f}), {bound(common + out_bytes, ops)['bound_ms']:.4f} ms "
            f"rated at f32 [{card}]")
    return {
        "ce_bwd_dx": dict(max_abs_err=errs["dx"], ms=t["dx"], plain_ms=t["dx_plain"], library_ms=None, **bounds["dx"]),
        "ce_bwd_dw": dict(max_abs_err=errs["dw"], ms=t["dw"], plain_ms=t["dw_plain"], library_ms=None, **bounds["dw"]),
        "times": times,
    }


def bwd_share(got, want, tol: dict) -> float:
    """The largest share of its tolerance (BLOCKWISE_BWD_TOL[dtype]) that a
    gradient uses about its plain version; batch row 0 (fully padded: p = 1
    at every key, much larger gradients) against its own largest
    magnitude."""
    diff = (got.float() - want.float()).abs()
    used = 0.0
    for part in (slice(0, 1), slice(1, None)):
        wp = want[part].float().abs()
        atol = tol["atol"] if "atol" in tol else tol["share"] * max(wp.max().item(), tol["floor"])
        used = max(used, (diff[part] / (atol + tol["rtol"] * wp)).max().item())
    return used


def bwd_other_width(rng, b: int, seq: int, d: int, heads: int, card: str) -> None:
    """The bf16 blockwise backward (dq and dk/dv from one call) at a head
    width other than the long-session path's, against its plain version
    within BLOCKWISE_BWD_TOL (the fully padded batch row 0 against its own
    largest magnitude), two runs bit-equal."""
    from bert4clickpath_torch.ops.kernels.attention import (
        attention_delta,
        blockwise_mha_backward,
        blockwise_mha_backward_reference,
        blockwise_mha_reference,
    )

    qkv, bias = _qkv_bias(b, seq, d, rng, full_pad_row=True)
    qkv = qkv.bfloat16()
    q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
    do = torch.from_numpy(rng.standard_normal((b, seq, d), dtype=np.float32)).cuda().bfloat16()
    out, lse = blockwise_mha_reference(q, k, v, bias, heads)
    got = blockwise_mha_backward(q, k, v, bias, out, lse, do, heads)
    again = blockwise_mha_backward(q, k, v, bias, out, lse, do, heads)
    want = blockwise_mha_backward_reference(q, k, v, bias, lse, do, attention_delta(do, out, heads), heads)
    torch.cuda.synchronize()
    tag = f"blockwise backward B={b} L={seq} D={d} H={heads} (dh = {d // heads}) bf16"
    used = {}
    for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
        if not torch.isfinite(g).all() or not torch.equal(g, g2):
            raise AssertionError(f"{tag}: {name} non-finite, or two runs differ")
        used[name] = bwd_share(g, w, BLOCKWISE_BWD_TOL[torch.bfloat16])
    log(f"[kernels] {tag}: dq / dk / dv {used['dq']:.3f} / {used['dk']:.3f} / {used['dv']:.3f} of the tolerance; "
        f"two runs bit-equal [{card}]")
    if max(used.values()) > 1.0:
        raise AssertionError(f"{tag}: {used} of the tolerance")


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

    from bert4clickpath_torch.ops.kernels import _build

    out = {}
    b, d, h = LONG_B, 256, 4
    errs = {}
    copies = _build.copy_counts()
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
                    worst[name] = (g.float() - w.float()).abs().max().item()
                    used[name] = bwd_share(g, w, tol)
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
        # the bf16 forward at the serving batch, below one 128-key stage, at
        # the other head widths of D = 256: dh = 32 and 128 (H = 8 and 2);
        # the backward there and at L = 1000 (several stages: dk/dv walks 64
        # query rows a stage at dh = 128, 128 at dh = 32)
        for heads in (8, 2):
            for seq in (FWD_SHORT_L, 1000):
                bwd_other_width(rng, LONG_B_SERVE, seq, d, heads, card)
        for heads in (8, 2):
            qkv, bias = _qkv_bias(LONG_B_SERVE, FWD_SHORT_L, d, rng, full_pad_row=True)
            qkv = qkv.bfloat16()
            q_, k_, v_ = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
            got, lse = blockwise_mha_forward(q_, k_, v_, bias, heads)
            got2, lse2 = blockwise_mha_forward(q_, k_, v_, bias, heads)
            want, want_lse = blockwise_mha_reference(q_, k_, v_, bias, heads)
            torch.cuda.synchronize()
            tag = f"blockwise forward B={LONG_B_SERVE} L={FWD_SHORT_L} D={d} H={heads} (dh = {d // heads}) bf16"
            if not torch.isfinite(got).all() or not torch.equal(got, got2) or not torch.equal(lse, lse2):
                raise AssertionError(f"{tag}: non-finite, or two runs differ")
            atol, rtol = BLOCKWISE_TOL[torch.bfloat16]
            diff = (got.float() - want.float()).abs()
            used = (diff / (atol + rtol * want.float().abs())).max().item()
            lse_err = ((lse - want_lse).abs() / want_lse.abs().clamp(min=1.0)).max().item()
            log(f"[kernels] {tag}: max_abs_err {diff.max().item():.3e}, {used:.3f} of the tolerance; lse max relative "
                f"error {lse_err:.3e} (tol 1e-5); two runs bit-equal")
            if used > 1.0 or lse_err > 1e-5:
                raise AssertionError(f"{tag}: error {used} of the tolerance, lse {lse_err}")
        made = {key: n - copies[key] for key, n in _build.copy_counts().items() if key.startswith("blockwise")}
        log(f"[kernels] the bf16 blockwise kernels' input copies (tensor maps) in this phase: {made}")
        if any(made.values()):
            raise AssertionError(f"the blockwise kernels copied inputs: {made}: strided q/k/v must need no copy")
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
        # delta = rowsum(do * out), plain PyTorch before the pair (SDPA's
        # backward computes its own inside the one call)
        out_bf16 = blockwise_mha_forward(q, k, v, bias, h)[0]
        delta_ms = device_time_ms(lambda: attention_delta(do, out_bf16, h), 20)
    lib_fwd, lib_bwd = sdpa_times(q, k, v, bias, do, h)
    pair = t["dq"][0] + t["dkv"][0]
    log(f"[kernels] F.scaled_dot_product_attention B={b} L={LONG_L} bf16 (a yardstick, not used by the port): "
        f"forward {lib_fwd:.4f} ms, backward (dq, dk and dv together) {lib_bwd:.4f} ms; the port's dq + dk/dv "
        f"{pair:.4f} ms ({pair / lib_bwd:.3f}x), attention_delta {delta_ms:.4f} ms, pair + delta "
        f"{pair + delta_ms:.4f} ms ({(pair + delta_ms) / lib_bwd:.3f}x) [{card}]")
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
            **ce_kernels_at(rng, LONG_B * LONG_P, v_rows, LONG_ITEMS, d, card=card)}
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


def _served_as_on_cpu(served, cpu, requests, tag: str) -> float:
    """Each request's top-K answers from the card against the same bundle
    served on the CPU (the plain path): log-probs within SERVE_TOL, and the
    same items wherever the CPU's scores are further apart than that. The
    CPU answers K+1 items, so that the K-th item counts as separated only
    when it is also that far above the first item outside the top K.
    Returns the largest log-prob difference."""
    worst = 0.0
    for sessions in requests:
        got, want = served.recommend(sessions, k=K), cpu.recommend(sessions, k=K + 1)
        for g, w_next in zip(got, want):
            w = w_next[:K]
            gs, ws = np.array([s for _, s in g]), np.array([s for _, s in w])
            worst = max(worst, float(np.abs(gs - ws).max()))
            gaps = np.diff([s for _, s in w_next]) < -SERVE_TOL  # K gaps: the last one to the (K+1)-th item
            sep = gaps.copy()
            sep[1:] &= gaps[:-1]
            if [n for (n, _), s in zip(g, sep) if s] != [n for (n, _), s in zip(w, sep) if s]:
                raise AssertionError(f"GPU and CPU rankings differ: {g} vs {w}")
    log(f"{tag}: GPU vs CPU plain path, max |top-{K} log-prob diff| {worst:.3e} (tol {SERVE_TOL})")
    if worst > SERVE_TOL:
        raise AssertionError(f"GPU and CPU log-probs differ by {worst} > {SERVE_TOL}")
    return worst


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
        _served_as_on_cpu(served, cpu, [_sessions(rng, b) for b in (1, 8)], "[serve] batch 1 and 8")
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


def _card_vs_cpu_step(cfg, batch_on, num_valid, tag: str, loss_fn=None) -> dict:
    """One step's loss and gradients at dropout 0 from the same weights on
    the card (kernels) and on the CPU (plain versions), in f32 and bf16;
    ``batch_on(device)`` gives the batch there; the loss is the train
    step's (the fused CE over ``num_valid`` labels, or dense logits through
    ``loss_fn``)."""
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
            loss = make_loss_fn(m, loss_fn, fused_ce_num_valid=num_valid)(batch_on(device))
            grads = torch.autograd.grad(loss, [p for _, p in m.named_parameters()])
            results.append((loss.item(), {n: g.float().cpu() for n, g in zip(names, grads)}))
        (gpu_loss, gpu_g), (cpu_loss, cpu_g) = results

        def rel_err(got, want, n):
            # a separate key projection's bias has a zero gradient in exact
            # arithmetic (the softmax does not see a shift of all keys): both
            # sides compute rounding noise there, so their difference is held
            # against the same layer's query bias gradient
            ref = want[n.replace("wk.bias", "wq.bias")]
            return ((got[n] - want[n]).norm() / ref.norm().clamp(min=1e-30)).item()

        errs = {n: rel_err(gpu_g, cpu_g, n) for n in cpu_g}
        worst = max(errs, key=lambda n: (not np.isfinite(errs[n]), errs[n]))
        log(f"{tag} dropout 0 {dtype}, card vs CPU: loss {gpu_loss:.6f} vs {cpu_loss:.6f} "
            f"(|diff| {abs(gpu_loss - cpu_loss):.2e}, tol {loss_tol:.0e}); relative gradient norm error "
            f"median {statistics.median(errs.values()):.2e}, worst {errs[worst]:.3e} at {worst} (tol {grad_tol:.0e})")
        grads_held = errs[worst] <= grad_tol
        if dtype == "bfloat16" and cfg.head.kind != "tied_softmax":
            # each side's bf16 step against the CPU's f32 step
            to_f32 = [{n: rel_err(g, f32_cpu, n) for n in f32_cpu} for g in (gpu_g, cpu_g)]
            (card_med, cpu_med), (card_max, cpu_max) = (
                [agg(e.values()) for e in to_f32] for agg in (statistics.median, max))
            log(f"{tag} dropout 0 bfloat16 against the CPU's float32 step: relative gradient norm error median "
                f"{card_med:.3e} (card) vs {cpu_med:.3e} (CPU), worst {card_max:.3e} vs {cpu_max:.3e} (the card's held "
                f"to {BF16_TO_F32:.1f}x the CPU's)")
            grads_held = card_med <= BF16_TO_F32 * cpu_med and card_max <= BF16_TO_F32 * cpu_max
        if not abs(gpu_loss - cpu_loss) <= loss_tol or not grads_held:
            raise AssertionError(
                f"card and CPU train steps differ ({dtype}): loss {gpu_loss} vs {cpu_loss}, {worst} {errs[worst]}"
            )
        worst_errs[dtype] = errs[worst]
        if dtype == "float32":
            f32_cpu = cpu_g
    return worst_errs


def _card_vs_cpu_eval(cfg, batch_on, num_valid, tag: str, loss_fn=None) -> None:
    """One eval batch's sums (the chunked catalog scan over ``num_valid``
    labels) at dropout 0 from the same weights on the card and on the CPU,
    in f32 and bf16: the loss sum within EVAL_TOL of its magnitude, each hit
    sum within one hit of it."""
    from bert4clickpath_torch.data.synthetic import seeded_state_dict
    from bert4clickpath_torch.models.model import ClickstreamModel
    from bert4clickpath_torch.training.train_state import make_eval_step

    for dtype, tol in EVAL_TOL.items():
        cfg0 = dataclasses.replace(cfg, dropout_rate=0.0, dtype=dtype)
        sd = seeded_state_dict(cfg0, SEED + 2)
        sums = []
        for device in ("cuda", "cpu"):
            m = ClickstreamModel(cfg0, device=device)
            m.load_state_dict(sd)
            step = make_eval_step(m, loss_fn=loss_fn, chunked_num_valid=num_valid)
            sums.append({k: float(v) for k, v in step(dict(m.named_parameters()), batch_on(device)).items()})
        gpu, cpu = sums
        # the hit sums move by one whole hit where rounding reorders a near tie
        err = {k: abs(gpu[k] - cpu[k]) / max(abs(cpu[k]), 1.0) for k in cpu}
        log(f"{tag} {dtype}, card vs CPU: {gpu} vs {cpu}; worst relative difference {max(err.values()):.2e} "
            f"(tol {tol:.0e})")
        if gpu["n"] != cpu["n"] or err["loss_sum"] > tol:
            raise AssertionError(f"card and CPU eval sums differ ({dtype}): {gpu} vs {cpu}")
        for key in (k for k in cpu if "@" in k):
            if abs(gpu[key] - cpu[key]) > 1.0 + tol * abs(cpu[key]):
                raise AssertionError(f"card and CPU eval sums differ ({dtype}) at {key}: {gpu[key]} vs {cpu[key]}")


def phase_long_train(card: str) -> dict:
    """The long-session train step: B=16, L=1024, full width and depth."""
    from bert4clickpath_torch.config import TrainConfig
    from bert4clickpath_torch.data.pipeline import to_device
    from bert4clickpath_torch.data.synthetic import long_context_config, seeded_state_dict
    from bert4clickpath_torch.models.model import ClickstreamModel
    from bert4clickpath_torch.ops.kernels import _build
    from bert4clickpath_torch.training import schedules
    from bert4clickpath_torch.training.train_state import TrainState, make_optimizer, make_train_step

    cfg = long_context_config(LONG_L, LONG_ITEMS)
    batches = [to_device(b, "cuda") for b in _long_batches(4, LONG_B, SEED)]
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
    copies = _build.copy_counts()  # the blockwise kernels' input copies: none on this path

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
        if _build.copy_counts() != copies:
            raise AssertionError(f"the blockwise kernels copied inputs: {_build.copy_counts()} (before {copies})")
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
        cfg, lambda device: to_device(small, device), LONG_ITEMS, f"[long-train] B={LONG_B_CHECK}")
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
        copies = _build.copy_counts()
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
            if _build.copy_counts() != copies:
                raise AssertionError(f"the blockwise kernels copied inputs: {_build.copy_counts()} (before {copies})")
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
    from bert4clickpath_torch.ops import metrics as metrics_lib
    from bert4clickpath_torch.ops.kernels import _build
    from bert4clickpath_torch.training import checkpoint as ckpt_lib
    from bert4clickpath_torch.training.serving import ServingModel
    from bert4clickpath_torch.training.train_state import eval_params
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
    _card_vs_cpu_eval(cfg, lambda device: to_device(e0, device), num_valid, f"[wide-train] eval batch B={B_CHECK}")
    log(f"[wide-train] card vs CPU checks in {time.perf_counter() - t0:.2f} s")
    return dict(counts=counts, step_counts=step_counts, ms_per_step=ms_step, examples_per_s=B_TRAIN / ms_step * 1e3,
                eval_ms_per_batch=ms_eval, peak_bytes=peak, profile=prof, worst_grad_err=worst,
                train_loss=[r["train_loss"] for r in records])


def _rows(batch, n: int) -> dict:
    """The first n rows of a host batch (a ClozeBatch or a dict of numpy
    arrays) as a dict."""
    if not isinstance(batch, dict):
        batch = {"features": batch.features, "head_positions": batch.head_positions, "labels": batch.labels}
    positions = batch.get("head_positions")
    return {"features": {k: v[:n] for k, v in batch["features"].items()},
            "head_positions": None if positions is None else positions[:n], "labels": batch["labels"][:n]}


def _card_vs_cpu_logits(cfg, batch_on, tag: str, loss_fn=None) -> int:
    """A binary or multilabel eval batch at dropout 0 in f32 from the same
    weights on the card and on the CPU: the logits within HEADS_LOGIT_TOL,
    the loss sum within EVAL_TOL of its magnitude, the label and positive
    counts equal, and the predicted-positive and true-positive counts equal
    but for labels whose logit lies within the tolerance of 0 (the
    threshold), which may fall on either side. Returns how many did."""
    from bert4clickpath_torch.constants import LABEL_PAD
    from bert4clickpath_torch.data.synthetic import seeded_state_dict
    from bert4clickpath_torch.models.model import ClickstreamModel
    from bert4clickpath_torch.training.train_state import make_eval_step

    cfg0 = dataclasses.replace(cfg, dropout_rate=0.0, dtype="float32")
    sd = seeded_state_dict(cfg0, SEED + 2)
    out = []
    for device in ("cuda", "cpu"):
        m = ClickstreamModel(cfg0, device=device)
        m.load_state_dict(sd)
        batch = batch_on(device)
        with torch.no_grad():
            logits = m(batch["features"], batch.get("head_positions")).cpu()
        stats = make_eval_step(m, loss_fn=loss_fn)(dict(m.named_parameters()), batch)
        out.append((logits, {k: float(v) for k, v in stats.items()}))
    (gpu_logits, gpu), (cpu_logits, cpu) = out
    labels = batch_on("cpu")["labels"]
    err = (gpu_logits - cpu_logits).abs().max().item()
    near = int(((cpu_logits.abs() <= HEADS_LOGIT_TOL) & (labels != LABEL_PAD)).sum())
    log(f"{tag} float32, card vs CPU: logits {tuple(cpu_logits.shape)} max |diff| {err:.3e} (tol "
        f"{HEADS_LOGIT_TOL:.0e}); sums {gpu} vs {cpu}; {near} labels with a logit within the tol of 0")
    if not err <= HEADS_LOGIT_TOL:
        raise AssertionError(f"{tag}: card and CPU logits differ by {err}")
    if abs(gpu["loss_sum"] - cpu["loss_sum"]) > EVAL_TOL["float32"] * max(abs(cpu["loss_sum"]), 1.0):
        raise AssertionError(f"{tag}: card and CPU loss sums differ: {gpu} vs {cpu}")
    for key in ("n", "positives_sum", "pred_positives_sum", "tp_sum"):
        if abs(gpu[key] - cpu[key]) > (near if key in ("pred_positives_sum", "tp_sum") else 0):
            raise AssertionError(f"{tag}: card and CPU {key} differ: {gpu} vs {cpu} ({near} logits near 0)")
    return near


def _heads_model(tag: str, cfg, host: list, evals: list, per_step: dict, card: str, weights=None, loss_fn=None,
                 num_valid=None, profile: bool = False) -> dict:
    """One task model as its script trains it, batches already on the card:
    a warm-up step, HEADS_STEPS timed steps over ``host`` (cycled) with
    dropout live, the exact launches of each (``per_step``), finite losses
    whose last 5 lie below the first 5 on average, then HEADS_EVAL eval
    batches (1 gather unless the model has two features, 1 whole-row
    attention a layer each) with finite metrics; with ``profile`` a
    device-only profiled window."""
    from bert4clickpath_torch.config import TrainConfig
    from bert4clickpath_torch.data.pipeline import to_device
    from bert4clickpath_torch.data.synthetic import seeded_state_dict
    from bert4clickpath_torch.models.model import ClickstreamModel
    from bert4clickpath_torch.ops import metrics as metrics_lib
    from bert4clickpath_torch.ops.kernels import _build
    from bert4clickpath_torch.training import schedules
    from bert4clickpath_torch.training.train_state import (
        TrainState,
        eval_params,
        make_eval_step,
        make_optimizer,
        make_train_step,
    )

    t0 = time.perf_counter()
    model = ClickstreamModel(cfg, device="cuda")
    model.load_state_dict(seeded_state_dict(cfg, SEED) if weights is None else weights)
    tx = make_optimizer(TrainConfig(batch_size=B_TRAIN), mu_dtype=torch.bfloat16)
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, tx, schedules.constant(1e-3), loss_fn=loss_fn, fused_ce_num_valid=num_valid)
    eval_step = make_eval_step(model, loss_fn=loss_fn, chunked_num_valid=num_valid)
    batches = [to_device(b, "cuda") for b in host]
    rng = torch.Generator("cuda").manual_seed(SEED)
    state, loss = step(state, batches[0], rng)
    log(f"[heads] {tag}: {cfg.head}, routing {cfg.routing} {cfg.segment_bounds or ''}, features "
        f"{ {k: (f.vocab_rows, f.embedding_dim) for k, f in cfg.features.items()} }, d_model {cfg.d_model}, "
        f"max_len {cfg.max_len}; warm-up step loss {loss.item():.4f}; set-up {time.perf_counter() - t0:.2f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses = []
    t0 = time.perf_counter()
    for i in range(HEADS_STEPS):
        state, loss = step(state, batches[(i + 1) % len(batches)], rng)
        losses.append(loss)
    losses = torch.stack(losses).float().cpu().numpy()  # the fetch waits for the steps
    ms_step = (time.perf_counter() - t0) / HEADS_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated()
    counts = {k: n for k, n in _build.launch_counts().items() if n}
    expected = {k: n * HEADS_STEPS for k, n in per_step.items() if n}
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    log(f"[heads] {tag}: {HEADS_STEPS} train steps at B={B_TRAIN}, dropout {cfg.dropout_rate}: {ms_step:.3f} ms/step, "
        f"{B_TRAIN / ms_step * 1e3:.1f} examples/s; peak device memory {peak / 2**20:.1f} MiB; mean loss of the "
        f"first 5 {first:.4f}, of the last 5 {last:.4f}; launches {counts} (expected {expected}) [{card}]")
    if counts != expected:
        raise AssertionError(f"{tag}: kernel launches {counts} != {expected}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"{tag}: a non-finite training loss: {losses}")
    if not last < first:
        raise AssertionError(f"{tag}: the loss did not fall: first 5 {first}, last 5 {last}")

    per_eval = {"gather": int(len(cfg.features) == 1), "attention": cfg.num_layers}
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    acc = None
    for b in evals:
        stats = eval_step(eval_params(state), to_device(b, "cuda"))
        acc = stats if acc is None else metrics_lib.merge(acc, stats)
    metrics = metrics_lib.finalize(acc)
    ms_eval = (time.perf_counter() - t0) / len(evals) * 1e3
    eval_counts = {k: n for k, n in _build.launch_counts().items() if n}
    expected = {k: n * len(evals) for k, n in per_eval.items() if n}
    log(f"[heads] {tag}: {len(evals)} eval batches, {ms_eval:.3f} ms/batch (host batches included): "
        f"{ {k: round(v, 4) for k, v in metrics.items()} }; launches {eval_counts} (expected {expected}) [{card}]")
    if eval_counts != expected:
        raise AssertionError(f"{tag}: eval launches {eval_counts} != {expected}")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{tag}: non-finite eval metrics {metrics}")

    prof = None
    if profile:
        holder = {"state": state}

        def profiled():
            for i in range(HEADS_PROFILED):
                holder["state"], _ = step(holder["state"], batches[i % len(batches)], rng)

        prof = _device_profile(profiled, HEADS_PROFILED, f"heads {tag}", card)
        state = holder["state"]
        log(f"[heads] {tag}: device time {prof['device_ms_per_step']:.3f} ms/step (profiled kernels) against "
            f"{ms_step:.3f} ms/step unprofiled: busy share {prof['device_ms_per_step'] / ms_step:.3f} [{card}]")
    return dict(state=state, counts={k: n // HEADS_STEPS for k, n in counts.items()}, ms_per_step=ms_step,
                eval_ms_per_batch=ms_eval, peak_bytes=peak, first5=first, last5=last, metrics=metrics, profile=prof)


def phase_heads(card: str) -> dict:
    """The binary and multilabel heads, segment-routed chained sessions, the
    transfer chain and the multi-variable model at the flagship's width and
    depth, each on its script's batches and configuration, then the four
    scripts' ``main`` on the card at small sizes."""
    import functools
    import itertools

    from bert4clickpath_torch.config import FeatureConfig, HeadConfig
    from bert4clickpath_torch.constants import PAD_ID
    from bert4clickpath_torch.data.generator import ClickStreamGenerator
    from bert4clickpath_torch.data.pipeline import ClozeDataset, to_device
    from bert4clickpath_torch.data.synthetic import seeded_state_dict
    from bert4clickpath_torch.ops.kernels import _build
    from bert4clickpath_torch.ops.losses import masked_binary_cross_entropy
    from bert4clickpath_torch.training import checkpoint as ckpt_lib
    from bert4clickpath_torch.training.serving import ServingModel
    from examples.bert4rec import multivariable_torch, transfer_torch
    from examples.chained import train_torch as chained
    from examples.tasks import multilabel_torch

    t0 = time.perf_counter()
    flag, _ = flagship_config()
    gen = ClickStreamGenerator(n_items=N_ITEMS, n_events=N_EVENTS, session_cohesiveness=200, seed=0)
    items, events = gen.generate_sessions(HEADS_BATCHES * B_TRAIN)
    vocab, event_vocab = gen.item_vocab(), gen.event_vocab()
    num_valid = vocab.label_vocab_size
    mx, n = HEADS_MAX_ITEMS, HEADS_BATCHES

    def first(stream, k: int = n) -> list:
        return list(itertools.islice(stream, k))

    def at_flagship(cfg, head, **fields):
        """A script's configuration at the flagship's width and depth."""
        keep = ("features", "num_layers", "num_heads", "ffn_dim", "dropout_rate", "positional", "dtype", "qkv_fused")
        return dataclasses.replace(cfg, **{**{f: getattr(flag, f) for f in keep}, "head": head, **fields})

    ds = ClozeDataset(items, vocab, max_items=mx)
    pw_loss = functools.partial(masked_binary_cross_entropy, pos_weight=POS_WEIGHT)
    enc = {"attention": flag.num_layers, "attention_bwd": flag.num_layers}
    ce = {"ce_fwd": 1, "ce_bwd": 1}
    # (tag, configuration, train batches, eval batches, launches per train step, kwargs)
    runs = {
        "transfer-1": (flag, first(ds.train_batches(B_TRAIN, seed=SEED)), list(ds.eval_batches(B_TRAIN, HEADS_EVAL)),
                       {"gather": 1, **enc, **ce}, dict(num_valid=num_valid)),
        "transfer-2": (at_flagship(transfer_torch.finetune_config(flag), HeadConfig("binary", (256,))),
                       first(transfer_torch.binary_batches(items, N_ITEMS, B_TRAIN, mx, np.random.default_rng(5))),
                       first(transfer_torch.binary_batches(items, N_ITEMS, B_TRAIN, mx, np.random.default_rng(7),
                                                           shuffle=False), HEADS_EVAL),
                       {"gather": 1, **enc}, dict(profile=True)),
        "chained": (at_flagship(chained.build_model_config(vocab, HEADS_HIST), HeadConfig("binary", (256, 128))),
                    first(chained.make_chained_batches(items, B_TRAIN, HEADS_HIST, np.random.default_rng(1),
                                                       n_catalog=N_ITEMS)),
                    first(chained.make_chained_batches(items, B_TRAIN, HEADS_HIST, np.random.default_rng(2),
                                                       train=False, n_catalog=N_ITEMS), HEADS_EVAL),
                    {"gather": 1, **enc}, dict(loss_fn=pw_loss)),
        "multilabel": (at_flagship(multilabel_torch.build_model_config(vocab, mx, N_CLASSES),
                                   HeadConfig("multilabel", (256,), N_CLASSES)),
                       first(multilabel_torch.make_batches(items, B_TRAIN, mx, N_CLASSES, np.random.default_rng(1))),
                       first(multilabel_torch.make_batches(items, B_TRAIN, mx, N_CLASSES, np.random.default_rng(2),
                                                           train=False), HEADS_EVAL),
                       {"gather": 1, **enc}, {}),
        "multi-variable": (
            at_flagship(multivariable_torch.build_model_config(vocab, event_vocab, mx),
                        HeadConfig("softmax", (256,), num_valid),
                        features={"items": FeatureConfig(vocab.model_vocab_size, MV_DIMS[0]),
                                  "events": FeatureConfig(event_vocab.model_vocab_size, MV_DIMS[1])}),
            first(multivariable_torch.make_pair_batches(items, events, B_TRAIN, mx, np.random.default_rng(1))),
            first(multivariable_torch.make_pair_batches(items, events, B_TRAIN, mx, np.random.default_rng(0),
                                                        train=False), HEADS_EVAL),
            {**enc, **ce}, dict(num_valid=num_valid, profile=True)),
    }
    for tag, (cfg, host, evals, _, _) in runs.items():
        if cfg.max_len != 53 or cfg.d_model != flag.d_model or len(host) != n or len(evals) != HEADS_EVAL:
            raise AssertionError(f"{tag}: max_len {cfg.max_len}, d_model {cfg.d_model}, {len(host)} / {len(evals)} "
                                 "batches")
    log(f"[heads] {len(items)} simulated sessions over {N_ITEMS} items and {N_EVENTS} events, batches of the five "
        f"models made in {time.perf_counter() - t0:.2f} s")

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        pretrained = os.path.join(tmp, "pretrained", ckpt_lib.PARAMS_FILE)
        for tag, (cfg, host, evals, per_step, kw) in runs.items():
            kw = dict(kw)
            if tag == "transfer-2":
                # stage 1's encoder and embeddings under a fresh binary head
                weights = ckpt_lib.restore_encoder(os.path.dirname(pretrained), seeded_state_dict(cfg, SEED + 1))
                saved = torch.load(pretrained, weights_only=True)
                moved = [k for k in weights if ckpt_lib.is_transferred(k)]
                if not moved or any(not torch.equal(weights[k], saved[k]) for k in moved):
                    raise AssertionError("restore_encoder did not carry stage 1's encoder across")
                log(f"[heads] transfer-2: {len(moved)} tensors restored from stage 1, "
                    f"{len(weights) - len(moved)} fresh ({sorted(set(weights) - set(moved))})")
                kw["weights"] = weights
            out[tag] = _heads_model(tag, cfg, host, evals, per_step, card, **kw)
            # what the later checks need of a trained model; then its memory
            # goes, so that each model's peak is its own
            params = out[tag].pop("state").params
            if tag == "transfer-1":
                ckpt_lib.save_params(pretrained, {k: v for k, v in params.items() if ckpt_lib.is_transferred(k)})
            elif tag == "multi-variable":
                export = ckpt_lib.export_serving(os.path.join(tmp, "mv_export"), params, cfg,
                                                 {"items": vocab, "events": event_vocab})
            del params

        # card vs CPU at B=32, dropout 0: one train step in f32 and bf16, and
        # one eval batch
        t0 = time.perf_counter()
        for tag, (cfg, host, evals, _, kw) in runs.items():
            loss_fn, nv = kw.get("loss_fn"), kw.get("num_valid")
            out[tag]["worst_grad_err"] = _card_vs_cpu_step(
                cfg, lambda device: to_device(_rows(host[0], B_CHECK), device), nv, f"[heads] {tag} B={B_CHECK}",
                loss_fn)
            eval_on = lambda device: to_device(_rows(evals[0], B_CHECK), device)  # noqa: E731
            if nv is None:
                out[tag]["near_zero_logits"] = _card_vs_cpu_logits(cfg, eval_on, f"[heads] {tag} eval B={B_CHECK}",
                                                                   loss_fn)
            else:
                _card_vs_cpu_eval(cfg, eval_on, nv, f"[heads] {tag} eval B={B_CHECK}", loss_fn)
        log(f"[heads] card vs CPU checks in {time.perf_counter() - t0:.2f} s")

        # the chained batches' pads inside the sequence, before each [SEP]:
        # the whole-row attention forward and backward against their plain
        # versions on that padding
        tokens = runs["chained"][1][0]["features"]["items"]
        pads = tokens == PAD_ID
        interior = int((pads[:, :-1] & ~pads[:, 1:]).any(axis=1).sum())
        if not interior:
            raise AssertionError("no chained row has a pad before a real token")
        log(f"[heads] interior pads: {interior} of {len(tokens)} chained rows have a pad before a real token; the "
            "whole-row kernels held on their padding:")
        rng = np.random.default_rng(SEED + 12)
        attention_forward_at(rng, B_TRAIN, tokens.shape[1], flag.d_model, flag.num_heads, tokens=tokens)
        attention_backward_at(rng, B_TRAIN, tokens.shape[1], flag.d_model, flag.num_heads, card, tokens=tokens)

        # the multi-variable model's export served with dict sessions
        cfg_mv = runs["multi-variable"][0]
        rng = np.random.default_rng(SEED + 13)

        def mv_sessions(b: int) -> list:
            lens = rng.integers(1, 61, size=b)
            return [{"items": [f"item_{i}" for i in rng.integers(0, N_ITEMS, size=k)],
                     "events": [f"event_{e}" for e in rng.integers(0, N_EVENTS, size=k)]} for k in lens]

        served = ServingModel(export, device="cuda", warmup_batches=(8,), warmup_k=K)
        lat = []
        for _ in range(5):
            batch = mv_sessions(8)
            _build.reset_launch_counts()
            t1 = time.perf_counter()
            res = served.recommend(batch, k=K)
            lat.append((time.perf_counter() - t1) * 1e3)
            _check_result(res, 8)
            counts = {k: c for k, c in _build.launch_counts().items() if c}
            if counts != {"attention": cfg_mv.num_layers}:
                raise AssertionError(f"multi-variable serving launches {counts}")
        log(f"[heads] multi-variable export served batch-8 dict-session requests: launches per request {counts}, "
            f"latency ms {[round(x, 3) for x in lat]}; first row {res[0][:3]} [{card}]")
        out["multi-variable"]["serve_ms"] = statistics.median(lat)
        _served_as_on_cpu(served, ServingModel(export, device="cpu"), [mv_sessions(b) for b in (1, 8)],
                          "[heads] multi-variable served, batch 1 and 8")
        # the four scripts as a user runs them, on the card, at small sizes
        scripts = [
            ("chained", chained.main, ["--n_items", "300", "--n_sessions", "640", "--epochs", "2"]),
            ("multilabel", multilabel_torch.main, ["--n_items", "500", "--n_sessions", "640", "--epochs", "2"]),
            ("transfer", transfer_torch.main, ["--pretrain_steps", "40", "--finetune_steps", "20", "--pos_frac", "0.7"]),
            ("multi-variable", multivariable_torch.main, ["--n_sessions", "640", "--epochs", "2"]),
        ]
        for name, main_fn, argv in scripts:
            _build.reset_launch_counts()
            t1 = time.perf_counter()
            result = main_fn(argv + ["--model_dir", os.path.join(tmp, f"script_{name}")])
            torch.cuda.synchronize()
            counts = {k: c for k, c in _build.launch_counts().items() if c}
            log(f"[heads] {name} script on the card in {time.perf_counter() - t1:.2f} s: launches {counts}")
            if not counts.get("attention") or not counts.get("attention_bwd"):
                raise AssertionError(f"{name} script: the attention kernels were not launched: {counts}")
            if name in ("transfer", "multi-variable") and not (counts.get("ce_fwd") and counts.get("ce_bwd")):
                raise AssertionError(f"{name} script: the CE kernels were not launched: {counts}")
            if name == "transfer":
                if not all(0.0 <= result[arm]["f1"] <= 1.0 for arm in ("scratch", "transfer")):
                    raise AssertionError(f"transfer script: {result}")
            elif not all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]) for r in result.trainer.history):
                raise AssertionError(f"{name} script: {result.trainer.history}")
    return out


# -- the vocab-sharded CE, the parallel tiers, the DP CLI, sampled softmax --


def _sharded_pass(k, x, table, bias, lab, logz, dnll, off, nv, v_local, backward: bool):
    """The CE entries on each row shard of ``table`` with its row_start,
    combined as the vocab-sharded tier combines them (here in one process):
    logz from the shards' (m, l) by the max and the rescaled sum; or dx
    summed, the dW shards stacked, db in its window."""
    shards = table.shape[0] // v_local
    parts = []
    for s in range(shards):
        lo = s * v_local
        tb, bb = table[lo : lo + v_local], None if bias is None else bias[lo : lo + v_local]
        if backward:
            parts.append(k.ce_backward(x, tb, bb, lab, logz, dnll, off, nv, lo))
        else:
            parts.append(k.ce_stats(x, tb, bb, off, nv, lo))
    if not backward:
        m = torch.stack([p[0] for p in parts])
        gmax = m.max(dim=0).values
        return gmax + torch.log((torch.stack([p[1] for p in parts]) * torch.exp(m - gmax)).sum(dim=0))
    dx = torch.stack([p[0].float() for p in parts]).sum(dim=0).to(x.dtype)
    db = None if bias is None else torch.cat([p[2] for p in parts])
    return dx, torch.cat([p[1] for p in parts]), db


def sharded_ce_at(rng, d: int, card: str) -> dict:
    """The CE kernels on SHARDS row shards of the padded flagship table
    (``padded_vocab_rows(rows, SHARDS)``), each with its row_start, at N =
    2,560 rows of f32 x: logz, dx, dW and db combined from the shards held
    against the unsharded kernel call and the plain version (logz within
    1e-5 of the plain logz's magnitude, gradients within CE_GRAD_REL of the
    plain version's largest), without and with a bias; launches exact (one
    forward and one backward entry per shard). Times of the 4 shards' calls
    in turns with the unsharded call (no bias)."""
    from bert4clickpath_torch.constants import LABEL_PAD
    from bert4clickpath_torch.ops.fused_ce import _labels_model
    from bert4clickpath_torch.ops.kernels import _build
    from bert4clickpath_torch.ops.kernels import fused_ce as k
    from bert4clickpath_torch.parallel.spmd import padded_vocab_rows

    _, vocab = flagship_config()
    n, off, nv = B_TRAIN * 10, 10, N_ITEMS
    rows = padded_vocab_rows(vocab.model_vocab_size, SHARDS)
    v_local = rows // SHARDS
    route = k.ce_backward_route(d)
    bwd_counts = {"ce_bwd": SHARDS} if route == "merged" else {"ce_bwd_dx": SHARDS, "ce_bwd_dw": SHARDS}
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).cuda()
    table = torch.from_numpy(rng.standard_normal((rows, d), dtype=np.float32) * 0.02).cuda()
    labels_np = rng.integers(0, nv, size=n).astype(np.int32)
    labels_np[rng.random(n) < 0.2] = LABEL_PAD
    labels = torch.from_numpy(labels_np).cuda()
    lab = _labels_model(labels, off)
    mask = (labels != LABEL_PAD).float()
    dnll = mask / mask.sum()
    errs = {"fwd": 0.0, "bwd": 0.0, "dx": 0.0, "dw": 0.0}
    tag = f"N={n} V={rows} ({SHARDS} shards of {v_local}) D={d} f32"
    for with_bias in (False, True):
        bias = torch.from_numpy(rng.standard_normal(rows, dtype=np.float32)).cuda() if with_bias else None
        wm, wl = k.ce_stats_reference(x, table, bias, off, nv)
        plain_logz = wm + torch.log(wl)
        m, l = k.ce_stats(x, table, bias, off, nv)
        _build.reset_launch_counts()
        logz = _sharded_pass(k, x, table, bias, lab, None, None, off, nv, v_local, False)
        torch.cuda.synchronize()
        fwd_counts = {c: v for c, v in _build.launch_counts().items() if v}
        scale = plain_logz.abs().max().item()
        e_plain = (logz - plain_logz).abs().max().item()
        e_full = (logz - (m + torch.log(l))).abs().max().item()
        log(f"[sharded-ce] forward {tag} bias={with_bias}: logz max_abs_err {e_plain:.3e} against plain, "
            f"{e_full:.3e} against the unsharded kernel (tol {1e-5 * scale:.3e}: 1e-5 of |logz|); launches {fwd_counts}")
        if fwd_counts != {"ce_fwd": SHARDS} or not torch.isfinite(logz).all() or max(e_plain, e_full) > 1e-5 * scale:
            raise AssertionError(f"sharded CE forward {tag} bias={with_bias}: {e_plain}, {e_full}, {fwd_counts}")
        errs["fwd"] = max(errs["fwd"], e_plain)
        args = (x, table, bias, lab, plain_logz, dnll, off, nv)
        _build.reset_launch_counts()
        got = _sharded_pass(k, *args, v_local, True)
        torch.cuda.synchronize()
        counts = {c: v for c, v in _build.launch_counts().items() if v}
        full = k.ce_backward(*args)
        want = k.ce_backward_reference(*args)
        for name, g, f, w in zip(("dx", "dW", "db"), got, full, want):
            if w is None:
                continue
            scale = w.abs().max().item()
            e_w, e_f = (g - w).abs().max().item(), (g - f).abs().max().item()
            log(f"[sharded-ce] backward ({route}) {tag} bias={with_bias} {name}: max_abs_err {e_w:.3e} against "
                f"plain, {e_f:.3e} against the unsharded kernel, largest |value| {scale:.3e} (tol {CE_GRAD_REL:.0e} "
                f"of it)")
            if not torch.isfinite(g).all() or max(e_w, e_f) > CE_GRAD_REL * scale:
                raise AssertionError(f"sharded CE backward {tag} bias={with_bias} {name}: {e_w}, {e_f} > {scale}")
            key = "bwd" if route == "merged" else ("dx" if name == "dx" else "dw")
            errs[key] = max(errs[key], e_w)
        if counts != bwd_counts:
            raise AssertionError(f"sharded CE backward {tag}: launches {counts}, want {bwd_counts}")
    # times, no bias, in turns: the shards' calls summed against the one call
    args = (x, table, None, lab, plain_logz, dnll, off, nv)
    t = {"fwd": [], "fwd_full": [], "bwd": [], "bwd_full": []}
    for _ in range(2):
        t["fwd"].append(device_time_ms(lambda: _sharded_pass(k, x, table, None, lab, None, None, off, nv, v_local,
                                                             False), reps=10))
        t["fwd_full"].append(device_time_ms(lambda: k.ce_stats(x, table, None, off, nv), reps=10))
        t["bwd"].append(device_time_ms(lambda: _sharded_pass(k, *args, v_local, True), reps=10))
        t["bwd_full"].append(device_time_ms(lambda: k.ce_backward(*args), reps=10))
    t = {name: min(v) for name, v in t.items()}

    def plain_pass(backward):
        parts = []
        for s in range(SHARDS):
            lo = s * v_local
            tb = table[lo : lo + v_local]
            parts.append(k.ce_backward_reference(x, tb, None, lab, plain_logz, dnll, off, nv, lo) if backward
                         else k.ce_stats_reference(x, tb, None, off, nv, lo))
        return parts

    t["fwd_plain"] = device_time_ms(lambda: plain_pass(False), reps=5)
    t["bwd_plain"] = device_time_ms(lambda: plain_pass(True), reps=5)
    log(f"[sharded-ce] times {tag}: forward {t['fwd']:.4f} ms over the {SHARDS} shards against {t['fwd_full']:.4f} "
        f"ms unsharded ({t['fwd'] / t['fwd_full']:.3f}x); backward ({route}) {t['bwd']:.4f} ms against "
        f"{t['bwd_full']:.4f} ms ({t['bwd'] / t['bwd_full']:.3f}x); plain {t['fwd_plain']:.4f} / {t['bwd_plain']:.4f} "
        f"ms (best of two windows of median device time) [{card}]")
    # bounds: the work of the unsharded call (the window's rows and the
    # labelled rows), plus each shard's (m, l) written; no PyTorch call
    # computes either without the (N, V) logits: library_ms null
    live = int(mask.sum().item())
    kind, terms = DX_RATING
    fwd_bound = bound(n * d * 4 + nv * d * 4 + SHARDS * 2 * n * 4, {kind: terms * 2.0 * n * nv * d})
    common = (n * d + nv * d + 3 * n) * 4
    out = {"fwd": dict(max_abs_err=errs["fwd"], ms=t["fwd"], plain_ms=t["fwd_plain"], library_ms=None, **fwd_bound)}
    log(f"[sharded-ce] forward {tag}: {t['fwd']:.4f} ms over the {SHARDS} shards, bound "
        f"{fwd_bound['bound_ms']:.4f} ms ({fwd_bound['bound_by']}) [{card}]")
    if route == "merged":
        out["bwd"] = dict(max_abs_err=errs["bwd"], ms=t["bwd"], plain_ms=t["bwd_plain"], library_ms=None,
                          **bound((2 * n * d + 2 * nv * d + 3 * n) * 4, {kind: terms * 6.0 * live * nv * d}))
        return out
    # the pair: each pass timed alone over the shards, its plain half too
    for name, entry, ref, out_bytes in (("dx", k.ce_backward_dx, k.ce_backward_dx_reference, n * d * 4),
                                        ("dw", k.ce_backward_dw, k.ce_backward_dw_reference, nv * d * 4)):
        def run(fn=entry):
            return [fn(x, table[s * v_local : (s + 1) * v_local], None, lab, plain_logz, dnll, off, nv, s * v_local)
                    for s in range(SHARDS)]

        def run_plain(fn=ref):
            return [fn(x, table[s * v_local : (s + 1) * v_local], None, lab, plain_logz, dnll, off, nv, s * v_local)
                    for s in range(SHARDS)]

        ms = min(device_time_ms(run, reps=10) for _ in range(2))
        out[name] = dict(max_abs_err=errs[name], ms=ms, plain_ms=device_time_ms(run_plain, reps=5), library_ms=None,
                         **bound(common + out_bytes, {kind: terms * 4.0 * live * nv * d}))
        log(f"[sharded-ce] {name} pass {tag}: {ms:.4f} ms over the {SHARDS} shards, bound "
            f"{out[name]['bound_ms']:.4f} ms, plain {out[name]['plain_ms']:.4f} ms [{card}]")
    return out


def phase_sharded_ce(card: str) -> dict:
    """The CE kernels with their row_start on 4 row shards: the flagship's
    CE inputs (D = 256, the merged backward) and the wide ones (D = 384, the
    pair)."""
    rng = np.random.default_rng(SEED + 5)
    flag, wide = sharded_ce_at(rng, 256, card), sharded_ce_at(rng, WIDE_D, card)
    return {"ce_fwd_sharded": flag["fwd"], "ce_bwd_sharded": flag["bwd"],
            "ce_bwd_dx_sharded": wide["dx"], "ce_bwd_dw_sharded": wide["dw"], "ce_fwd_sharded_wide": wide["fwd"]}


def _key_bias_mask(name: str, n: int) -> np.ndarray:
    """The elements of a parameter that are a key-projection bias: all of
    ``wk.bias``, the k third of a fused QKV bias, none of anything else."""
    key = np.zeros(n, bool)
    if name.endswith("wk.bias"):
        key[:] = True
    elif name.endswith("wqkv.bias"):
        key[n // 3 : 2 * (n // 3)] = True
    return key


def _rel_errs(got: dict, want: dict, key_bias_steps: float) -> dict:
    """Per parameter, |got - want| / |want| (norms). The key bias has a
    zero gradient in exact arithmetic: both sides step on noise, so it is
    held only to its steps' size (``key_bias_steps``, an absolute bound)
    and left out of the norm (a parameter that is all key bias is left
    out)."""
    errs = {}
    for name, w in want.items():
        g, w = np.asarray(got[name], np.float64).reshape(-1), np.asarray(w, np.float64).reshape(-1)
        key = _key_bias_mask(name, w.shape[0])
        if key.any() and np.abs(g[key] - w[key]).max() > key_bias_steps:
            raise AssertionError(f"{name}: the key bias moved more than its steps allow")
        if key.all():
            continue
        g, w = g[~key], w[~key]
        errs[name] = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
    return errs


def _apart_shares(got: dict, want: dict, threshold: float) -> dict:
    """Per parameter, the share of its elements apart by more than
    ``threshold``; the key bias left out, as in :func:`_rel_errs`."""
    out = {}
    for name, w in want.items():
        apart = (np.abs(np.asarray(got[name], np.float64) - np.asarray(w, np.float64)) > threshold).reshape(-1)
        key = _key_bias_mask(name, apart.shape[0])
        if not key.all():
            out[name] = float(apart[~key].mean())
    return out


def _tier_batches() -> tuple:
    """The tier phases' global batches over the flagship catalog: TIER_STEPS
    Cloze train batches of B_TRAIN rows and one eval batch."""
    from bert4clickpath_torch.data.generator import ClickStreamGenerator
    from bert4clickpath_torch.data.pipeline import ClozeDataset

    gen = ClickStreamGenerator(n_items=N_ITEMS, session_cohesiveness=200, seed=1)
    items, _ = gen.generate_sessions(B_TRAIN * 8)
    ds = ClozeDataset(items, gen.item_vocab(), max_items=50)
    it = ds.train_batches(B_TRAIN, seed=0)
    return [next(it) for _ in range(TIER_STEPS)], next(ds.eval_batches(B_TRAIN))


def _as_np(b) -> dict:
    return {"features": dict(b.features), "head_positions": b.head_positions, "labels": b.labels}


def _one_process(cfg, sd, host, ev, num_valid: int, lr: float, dense: bool = False, negatives=None):
    """The port's one-process train step on the card over the full global
    batches (the fused CE; ``dense``: logits and the head's loss;
    ``negatives``: sampled softmax on one array of them a step), and one
    eval batch unless ``ev`` is None: (losses, params, Adam's first moment,
    eval sums)."""
    from bert4clickpath_torch.config import TrainConfig
    from bert4clickpath_torch.data.pipeline import to_device
    from bert4clickpath_torch.models.model import ClickstreamModel
    from bert4clickpath_torch.training import schedules
    from bert4clickpath_torch.training.train_state import TrainState, make_eval_step, make_optimizer, make_train_step

    model = ClickstreamModel(cfg, device="cuda")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    tx = make_optimizer(TrainConfig())
    step = make_train_step(model, tx, schedules.constant(lr), fused_ce_num_valid=None if dense else num_valid,
                           sampled_softmax_samples=None if negatives is None else len(negatives[0]))
    state = TrainState.create(dict(model.named_parameters()), tx)
    losses = []
    for i, b in enumerate(host):
        extra = () if negatives is None else (torch.from_numpy(negatives[i]).to("cuda"),)
        state, loss = step(state, to_device(b, "cuda"), None, *extra)
        losses.append(loss.item())
    stats = {}
    if ev is not None:
        stats = make_eval_step(model, chunked_num_valid=num_valid)(state.params, to_device(ev, "cuda"))
    params = {k: v.detach().cpu().numpy() for k, v in state.params.items()}
    mu = {k: v.float().cpu().numpy() for k, v in state.opt_state.mu.items()}
    return losses, params, mu, {k: float(v) for k, v in stats.items()}


def _check_tier_runs(tag: str, results: dict, jobs: dict, per_step: dict, per_eval: dict, card: str,
                     kind_of, falls) -> None:
    """Each tier run of a phase: exact launches per rank and step
    (``per_step[kind_of(name)]``) and per eval batch, finite losses, and a
    falling loss where ``falls(name)``; ms/step printed for information."""
    for name, per_rank in results.items():
        kind = kind_of(name)
        steps = len(jobs[name]["batches"])
        for r in per_rank:
            got = {c: v for c, v in r["train_launches"].items() if v}
            want = {c: v * steps for c, v in per_step[kind].items()}
            if got != want:
                raise AssertionError(f"[{tag}] {name} rank {r['coords']}: launches {got}, want {want}")
            if jobs[name]["eval_batches"]:
                got = {c: v for c, v in r["eval_launches"].items() if v}
                if got != per_eval[kind]:
                    raise AssertionError(f"[{tag}] {name} eval rank {r['coords']}: launches {got}")
            if not np.all(np.isfinite(r["losses"])):
                raise AssertionError(f"[{tag}] {name}: a loss is not finite: {r['losses']}")
        ms = [1e3 * statistics.median(r["step_seconds"][1:] or r["step_seconds"]) for r in per_rank]
        log(f"[{tag}] {name}: losses {np.round(per_rank[0]['losses'], 5).tolist()}; launches per rank and step "
            f"{per_step[kind]}; {', '.join(f'{m:.1f}' for m in ms)} ms/step on the two ranks (information only: "
            f"two ranks share one card over gloo) [{card}]")
        losses = per_rank[0]["losses"]
        if falls(name) and not losses[-2:].mean() < losses[:2].mean():
            raise AssertionError(f"[{tag}] {name}: the loss did not fall: {losses}")


def _hold_against_one_process(tag: str, results: dict, refs: dict) -> None:
    """Each tier run against its one-process reference (losses, params,
    Adam's first moment, eval sums): one step, the loss 1e-4 and the
    gradients (Adam's first moment) 1e-3 of each norm; more steps, the
    criteria of :func:`phase_tiers`."""
    for name, (losses, params, mu, stats) in refs.items():
        steps = len(losses)
        for r in results[name]:
            loss_err = float(np.max(np.abs(r["losses"] - losses) / np.abs(losses)))
            if steps == 1:
                # the gradients, summed over the tier's ranks, against one
                # process: Adam's first moment after one step
                errs = _rel_errs(r["mu"], mu, float("inf"))
                worst = max(errs, key=errs.get)
                log(f"[{tag}] {name} rank {r['coords']} against one process: loss rel err {loss_err:.2e} (tol 1e-4); "
                    f"gradients (Adam's first moment after one step) median rel err "
                    f"{statistics.median(errs.values()):.2e}, worst {errs[worst]:.2e} at {worst} (tol 1e-3)")
                if loss_err > 1e-4 or errs[worst] > 1e-3:
                    raise AssertionError(f"[{tag}] {name}: the gradients differ from the one-process step's")
                continue
            # after three steps: within 1e-3 of each parameter's norm, or
            # with at most TIER_FLIP_SHARE of its elements apart by more
            # than lr / 10 (Adam's sign-like first steps; see the constant);
            # the first moment within TIER_MU_REL
            errs = _rel_errs(r["params"], params, 2 * TIER_LR * steps)
            shares = _apart_shares(r["params"], params, TIER_LR / 10)
            past = {k: e for k, e in errs.items() if e > 1e-3}
            mu_errs = _rel_errs(r["mu"], mu, float("inf"))
            worst, worst_mu = max(errs, key=errs.get), max(mu_errs, key=mu_errs.get)
            ev_got = r["evals"][0] if stats else {}
            ev_err = max((abs(ev_got[k] - v) / max(abs(v), 1.0) for k, v in stats.items()), default=0.0)
            log(f"[{tag}] {name} rank {r['coords']} against one process: loss rel err {loss_err:.2e} (tol 1e-4); "
                f"parameters median rel err {statistics.median(errs.values()):.2e}, worst {errs[worst]:.2e} at "
                f"{worst}; {len(past)} of {len(errs)} past 1e-3 of their norm, their shares of elements apart by "
                f"more than lr/10 {', '.join(f'{k} {shares[k]:.3e}' for k in sorted(past))} (tol "
                f"{TIER_FLIP_SHARE:.0e}); largest share of any parameter {max(shares.values()):.3e}; Adam's first "
                f"moment median rel err {statistics.median(mu_errs.values()):.2e}, worst {mu_errs[worst_mu]:.2e} at "
                f"{worst_mu} (tol {TIER_MU_REL:.0e}); eval sums worst rel diff {ev_err:.2e} "
                f"({ev_got.get('n', 0):.0f} rows)")
            if (loss_err > 1e-4 or any(shares[k] > TIER_FLIP_SHARE for k in past) or mu_errs[worst_mu] > TIER_MU_REL
                    or ev_got.get("n") != stats.get("n") or ev_err > EVAL_TOL["float32"]):
                raise AssertionError(f"[{tag}] {name} differs from the one-process run")
            for key in (k for k in stats if "@" in k):
                if abs(ev_got[key] - stats[key]) > 1.0:
                    raise AssertionError(f"[{tag}] {name} eval {key}: {ev_got[key]} against {stats[key]}")


def phase_tiers(card: str) -> dict:
    """The data-parallel tier (data = 2) and the vocab-sharded SPMD tier
    (model = 2, tied_bias) with two ranks sharing the one card over gloo,
    on the flagship (4L/256d, qkv_fused, tied softmax over 54,542 items,
    global B = 256, dropout 0), in f32 against the port's one-process step
    on the same global batches: one step (loss 1e-4 relative; the summed
    gradients, as Adam's first moment, within 1e-3 of each norm), then
    three (losses 1e-4; every parameter within 1e-3 of its norm, or, where
    Adam's sign-like first steps turned a gradient of rounding size into a
    whole step either way, with at most TIER_FLIP_SHARE of its elements
    apart by more than lr / 10; Adam's first moment within TIER_MU_REL of
    each norm; the SPMD table gathered back) and one eval batch against the
    one-process eval;
    eight bf16 steps
    of each over two batches cycled, the last two losses below the first
    two; two bf16 steps of the SPMD tier on the
    wide model (D = 384: the CE pair with its row_start); exact kernel
    launches per rank and step. ms/step is printed for information only:
    two ranks sharing one card over gloo say nothing of a multi-card
    tier."""
    from bert4clickpath_torch.data.synthetic import seeded_state_dict
    from bert4clickpath_torch.ops.kernels import _build
    from bert4clickpath_torch.parallel import drive
    from bert4clickpath_torch.parallel.mesh import spawn
    from bert4clickpath_torch.parallel.spmd import padded_vocab_rows

    t0 = time.perf_counter()
    cfg, vocab = flagship_config()
    num_valid = vocab.label_vocab_size
    rows = cfg.features["items"].vocab_rows
    if padded_vocab_rows(vocab.model_vocab_size, 2) != rows:
        raise AssertionError("the flagship table does not cut into two equal shards")
    f32 = dataclasses.replace(cfg, dropout_rate=0.0, dtype="float32")
    f32_bias = dataclasses.replace(f32, head=dataclasses.replace(f32.head, tied_bias=True))
    wide = dataclasses.replace(
        f32_bias, dtype="bfloat16", features={"items": dataclasses.replace(cfg.features["items"], embedding_dim=WIDE_D)},
        num_heads=WIDE_HEADS, ffn_dim=4 * WIDE_D)
    host, ev = _tier_batches()
    sd, sd_bias, sd_wide = (
        {k: v.numpy() for k, v in seeded_state_dict(c, SEED + 3).items()} for c in (f32, f32_bias, wide))
    common = dict(device="cuda", num_valid=num_valid, lr=TIER_LR)
    jobs = {
        "dp f32": dict(tier="dp", mesh=(2, 1), config=f32.to_json(), state=sd, eval_batches=[_as_np(ev)]),
        "spmd f32": dict(tier="spmd", mesh=(1, 2), config=f32_bias.to_json(), state=sd_bias,
                         eval_batches=[_as_np(ev)]),
        "dp bf16": dict(tier="dp", mesh=(2, 1), config=dataclasses.replace(f32, dtype="bfloat16").to_json(),
                        state=sd, eval_batches=[]),
        "spmd bf16": dict(tier="spmd", mesh=(1, 2), config=dataclasses.replace(f32_bias, dtype="bfloat16").to_json(),
                          state=sd_bias, eval_batches=[]),
        "spmd wide bf16": dict(tier="spmd", mesh=(1, 2), config=wide.to_json(), state=sd_wide, eval_batches=[]),
        # one step: Adam's first moment is then (1 - b1) x the summed gradient
        "dp f32 step 1": dict(tier="dp", mesh=(2, 1), config=f32.to_json(), state=sd, eval_batches=[]),
        "spmd f32 step 1": dict(tier="spmd", mesh=(1, 2), config=f32_bias.to_json(), state=sd_bias, eval_batches=[]),
        # the sharded checkpoint: RESUME_STEPS steps at once, and the same
        # steps checkpointed, restored and re-sharded halfway
        "spmd f32 uninterrupted": dict(tier="spmd", mesh=(1, 2), config=f32_bias.to_json(), state=sd_bias,
                                       eval_batches=[]),
        "spmd f32 resumed": dict(tier="spmd", mesh=(1, 2), config=f32_bias.to_json(), state=sd_bias, eval_batches=[],
                                 resume_after=RESUME_STEPS // 2),
    }
    for name, job in jobs.items():
        batches = (host[:1] if "step 1" in name else [host[i % len(host)] for i in range(RESUME_STEPS)]
                   if "uninterrupted" in name or "resumed" in name else host if "f32" in name
                   else host[:2] if "wide" in name else [host[i % 2] for i in range(TIER_BF16_STEPS)])
        job.update(common, batches=[_as_np(b) for b in batches])
    log(f"[tiers] flagship f32/bf16 on two ranks sharing the card over gloo, global B={B_TRAIN}; "
        f"set-up {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        jobs["spmd f32 resumed"]["checkpoint_dir"] = os.path.join(tmp, "ckpts")
        ranks = spawn(drive.run_jobs, 2, os.path.join(tmp, "store"), (list(jobs.values()),), timeout_s=600)
    log(f"[tiers] the two ranks ran {len(jobs)} jobs in {time.perf_counter() - t0:.2f} s")
    results = {name: [r[i] for r in ranks] for i, name in enumerate(jobs)}
    # the one-process references on the card: three steps, and one step
    refs = {name: _one_process(cfg_, sd_, host[:steps], ev, num_valid, TIER_LR)
            for name, cfg_, sd_, steps in (("dp f32", f32, sd, TIER_STEPS), ("spmd f32", f32_bias, sd_bias, TIER_STEPS),
                                           ("dp f32 step 1", f32, sd, 1), ("spmd f32 step 1", f32_bias, sd_bias, 1))}
    per_step = {"dp": {"gather": 1, "attention": 4, "attention_bwd": 4, "ce_fwd": 1, "ce_bwd": 1},
                "spmd": {"attention": 4, "attention_bwd": 4, "ce_fwd": 1, "ce_bwd": 1},
                "spmd wide": {"attention": 4, "attention_bwd": 4, "ce_fwd": 1, "ce_bwd_dx": 1, "ce_bwd_dw": 1}}
    per_eval = {"dp": {"gather": 1, "attention": 4}, "spmd": {"attention": 4}}
    _check_tier_runs("tiers", results, jobs, per_step, per_eval, card,
                     kind_of=lambda name: "spmd wide" if "wide" in name else name.split()[0],
                     falls=lambda name: "bf16" in name and "wide" not in name)
    _hold_against_one_process("tiers", results, refs)
    # the resumed run: the restored, re-sharded state bit-equal to the
    # saved one on every rank (exact); the steps after it held against the
    # uninterrupted run as a tier against one process (losses 1e-4, the
    # parameters after the last step within 1e-3 of their norm or
    # TIER_FLIP_SHARE): the merged CE backward sums dx with atomic adds, so
    # two runs of the same steps differ in their last bits (CE_DX_REPEAT)
    # and Adam's first steps turn that into lr-sized steps of noise-sized
    # gradients; the CPU test holds the same route bit-equal
    for whole, resumed in zip(results["spmd f32 uninterrupted"], results["spmd f32 resumed"]):
        errs = _rel_errs(resumed["params"], whole["params"], 2 * TIER_LR * RESUME_STEPS)
        shares = _apart_shares(resumed["params"], whole["params"], TIER_LR / 10)
        past = {k: e for k, e in errs.items() if e > 1e-3}
        loss_err = float(np.max(np.abs(resumed["losses"] - whole["losses"]) / np.abs(whole["losses"])))
        log(f"[tiers] sharded checkpoint, rank {whole['coords']}: {RESUME_STEPS} steps with a checkpoint, restore "
            f"and re-shard after {RESUME_STEPS // 2}: restored state apart from the saved one in "
            f"{resumed['restore_apart']} (want none); losses {resumed['losses'].tolist()} against "
            f"{whole['losses'].tolist()} uninterrupted, worst rel err {loss_err:.2e} (tol 1e-4; bit-equal: "
            f"{np.array_equal(whole['losses'], resumed['losses'])}); parameters after the last step: worst rel err "
            f"{max(errs.values()):.2e}, {len(past)} past 1e-3 of their norm, largest share of elements apart by "
            f"more than lr/10 {max(shares.values()):.3e} (tol {TIER_FLIP_SHARE:.0e})")
        if (resumed["restore_apart"] != [] or loss_err > 1e-4
                or any(shares[k] > TIER_FLIP_SHARE for k in past)):
            raise AssertionError("[tiers] the resumed run differs from the uninterrupted one")
    return {"spmd": results["spmd f32"][0]["train_launches"],
            "spmd wide": results["spmd wide bf16"][0]["train_launches"]}


def phase_tp_tiers(card: str) -> dict:
    """The tensor-parallel tier (``parallel/tp.py``), its composition with
    the vocab-sharded tier (``parallel/tp_spmd.py``) and sampled softmax
    over the row-sharded table (``spmd.make_sampled_spmd_train_step``),
    each with two ranks sharing the one card over gloo at (data, model) =
    (1, 2), global B = 256.

    tp and tp_spmd run the flagship's widths (4L/256d, 4 heads, 2 a rank of
    head width 64, FFN 1,024, 512 a rank, L=53, sinusoidal positions, tied
    softmax over 54,542 items: 55,296 rows, 27,648 a shard on tp_spmd, with
    ``tied_bias`` there) with separate q/k/v: the column split needs
    separate projections, so both tiers refuse ``qkv_fused`` (in the JAX
    package too) and the flagship's ``qkv_fused`` is turned off here.
    sampled_spmd runs the flagship as it is (``qkv_fused``) on SAMPLED
    negatives.

    In f32 and dropout 0, against the port's one-process step on the same
    global batches (tp against the dense loss, as the tier's; tp_spmd
    against the fused CE; sampled_spmd against the sampled step on the same
    negatives), with the criteria of :func:`phase_tiers`: one step (loss
    1e-4, Adam's first moment 1e-3 of each norm), three steps and one eval
    batch (tp, tp_spmd); one tp_spmd step in pre-LN. Eight bf16 steps of
    each over two batches cycled, with dropout 0.1 (the mask back end on tp
    and sampled_spmd, the fused dropout kernel on tp_spmd), the last two
    losses below the first two, the model ranks' encoder output under
    dropout bit-equal after them, and the sampled tier's negatives, drawn
    by the step, equal on both ranks. Exact kernel launches per rank and
    step: attention forward and backward once a layer on every tier, the
    gather on tp, the CE forward and merged backward (with their
    row_start) on tp_spmd, no CE kernel on tp or sampled_spmd."""
    from bert4clickpath_torch.data.synthetic import seeded_state_dict
    from bert4clickpath_torch.ops.losses import sample_negatives
    from bert4clickpath_torch.parallel import drive
    from bert4clickpath_torch.parallel.mesh import spawn

    t0 = time.perf_counter()
    cfg, vocab = flagship_config()
    num_valid = vocab.label_vocab_size
    sampled32 = dataclasses.replace(cfg, dropout_rate=0.0, dtype="float32")
    tp32 = dataclasses.replace(sampled32, qkv_fused=False)
    tps32 = dataclasses.replace(tp32, head=dataclasses.replace(tp32.head, tied_bias=True))
    tps32_pre = dataclasses.replace(tps32, norm_style="pre")
    bf16 = lambda c: dataclasses.replace(c, dtype="bfloat16", dropout_rate=cfg.dropout_rate)  # noqa: E731
    host, ev = _tier_batches()
    weights = {}  # config JSON: seeded weights

    def weights_of(c) -> dict:
        key = c.to_json()
        if key not in weights:
            weights[key] = {k: v.numpy() for k, v in seeded_state_dict(c, SEED + 3).items()}
        return weights[key]

    negatives = [sample_negatives(num_valid, SAMPLED, g).numpy()
                 for g in [torch.Generator().manual_seed(SEED + 6)] for _ in range(TIER_STEPS)]
    # name: (tier, config, f32 steps or 0 for the bf16 run, an eval batch, dropout back end)
    plan = {
        "tp f32": ("tp", tp32, TIER_STEPS, True, None),
        "tp f32 step 1": ("tp", tp32, 1, False, None),
        "tp_spmd f32": ("tp_spmd", tps32, TIER_STEPS, True, None),
        "tp_spmd f32 step 1": ("tp_spmd", tps32, 1, False, None),
        "tp_spmd pre-LN f32 step 1": ("tp_spmd", tps32_pre, 1, False, None),
        "sampled_spmd f32": ("sampled_spmd", sampled32, TIER_STEPS, False, None),
        "sampled_spmd f32 step 1": ("sampled_spmd", sampled32, 1, False, None),
        "tp bf16": ("tp", tp32, 0, False, "mask"),
        "tp_spmd bf16": ("tp_spmd", tps32, 0, False, "fused"),
        "sampled_spmd bf16": ("sampled_spmd", sampled32, 0, False, "mask"),
    }
    jobs = {}
    for name, (tier, c, steps, with_eval, dropout) in plan.items():
        batches = host[:steps] if steps else [host[i % 2] for i in range(TIER_BF16_STEPS)]
        job = dict(tier=tier, mesh=(1, 2), config=(bf16(c) if dropout else c).to_json(), state=weights_of(c),
                   device="cuda", num_valid=num_valid, lr=TIER_LR, batches=[_as_np(b) for b in batches],
                   eval_batches=[_as_np(ev)] if with_eval else [], num_samples=SAMPLED)
        if tier == "sampled_spmd" and steps:
            job["negatives"] = negatives[:steps]
        elif tier == "sampled_spmd":
            job["negatives_seed"] = SEED
        if dropout:
            job.update(dropout_impl=dropout, dropout_seed=SEED, probe_activations=True)
        jobs[name] = job
    log(f"[tp-tiers] tp, tp_spmd and sampled_spmd at (1, 2) on two ranks sharing the card over gloo, global "
        f"B={B_TRAIN}; set-up {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn(drive.run_jobs, 2, os.path.join(tmp, "store"), (list(jobs.values()),), timeout_s=600)
    log(f"[tp-tiers] the two ranks ran {len(jobs)} jobs in {time.perf_counter() - t0:.2f} s")
    results = {name: [r[i] for r in ranks] for i, name in enumerate(jobs)}
    refs = {}
    for name, (tier, c, steps, with_eval, dropout) in plan.items():
        if steps:
            refs[name] = _one_process(c, weights_of(c), host[:steps], ev if with_eval else None, num_valid, TIER_LR,
                                      dense=tier == "tp", negatives=jobs[name].get("negatives"))
    attention = {"attention": 4, "attention_bwd": 4}
    per_step = {"tp": {"gather": 1, **attention}, "tp_spmd": {**attention, "ce_fwd": 1, "ce_bwd": 1},
                "tp_spmd fused": {**attention, "ce_fwd": 1, "ce_bwd": 1, "dropout": 18}, "sampled_spmd": attention}
    per_eval = {"tp": {"gather": 1, "attention": 4}, "tp_spmd": {"attention": 4}}
    _check_tier_runs("tp-tiers", results, jobs, per_step, per_eval, card,
                     kind_of=lambda name: plan[name][0] + (" fused" if plan[name][4] == "fused" else ""),
                     falls=lambda name: not plan[name][2])
    _hold_against_one_process("tp-tiers", results, refs)
    for name, (tier, _, _, _, dropout) in plan.items():
        if not dropout:
            continue
        a, c = (r["activations"] for r in results[name])
        if not np.array_equal(a, c):
            raise AssertionError(f"[tp-tiers] {name}: the model ranks' encoder outputs under dropout differ")
        log(f"[tp-tiers] {name}: the two model ranks' encoder outputs under dropout ({dropout}) bit-equal, "
            f"shape {a.shape}")
    drawn = [r["negatives"] for r in results["sampled_spmd bf16"]]
    if not all(np.array_equal(a, c) for a, c in zip(*drawn)) or len(drawn[0]) != TIER_BF16_STEPS:
        raise AssertionError("[tp-tiers] the sampled tier's ranks drew different negatives")
    log(f"[tp-tiers] sampled_spmd bf16: both ranks drew the same {SAMPLED} negatives in each of "
        f"{TIER_BF16_STEPS} steps")
    return {name: results[name][0]["train_launches"] for name in ("tp f32", "tp_spmd f32", "sampled_spmd f32")}


def phase_cli_dp(card: str) -> None:
    """``train_torch.py --parallel dp`` under ``torchrun --nproc_per_node=1``:
    a world of one over NCCL on the card, two short epochs of the tied
    preset; the history is written."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
               os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "bert4rec", "train_torch.py"),
               "--parallel", "dp", "--simulated", "--preset", "tpu", "--n_items", "5000", "--n_sessions", "4000",
               "--batch", "64", "--epochs", "2", "--steps_per_epoch", "10", "--eval_batches", "2",
               "--model_dir", os.path.join(tmp, "run")]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        log(f"[cli-dp] {' '.join(cmd[2:5])} train_torch.py ... exited {out.returncode} in "
            f"{time.perf_counter() - t0:.2f} s")
        for line in out.stdout.splitlines()[-6:]:
            log(f"[cli-dp] {line}")
        if out.returncode != 0:
            raise AssertionError(f"train_torch.py --parallel dp failed:\n{out.stderr[-3000:]}")
        if "data-parallel over 1 ranks" not in out.stdout:
            raise AssertionError("train_torch.py did not take the data-parallel tier")
        with open(os.path.join(tmp, "run", "history.jsonl")) as f:
            hist = [json.loads(line) for line in f]
        if len(hist) != 2 or not all(np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"]) for h in hist):
            raise AssertionError(f"bad history: {hist}")
        log(f"[cli-dp] history: {[(h['step'], round(h['train_loss'], 4), round(h['val_loss'], 4)) for h in hist]}")


def phase_sampled(card: str) -> None:
    """Sampled softmax (1,024 negatives) on the flagship: one step's loss
    and gradients on the card against the CPU with the same negatives (f32,
    dropout 0, B=32, TRAIN_TOL), then one train step on the card at B=256
    with its launches (gather and attention; no CE kernel)."""
    from bert4clickpath_torch.config import TrainConfig
    from bert4clickpath_torch.data.generator import ClickStreamGenerator
    from bert4clickpath_torch.data.pipeline import ClozeDataset, to_device
    from bert4clickpath_torch.data.synthetic import seeded_state_dict
    from bert4clickpath_torch.models.model import ClickstreamModel
    from bert4clickpath_torch.ops.kernels import _build
    from bert4clickpath_torch.ops.losses import sample_negatives
    from bert4clickpath_torch.training import schedules
    from bert4clickpath_torch.training.train_state import TrainState, make_loss_fn, make_optimizer, make_train_step

    cfg, vocab = flagship_config()
    num_valid = vocab.label_vocab_size
    gen = ClickStreamGenerator(n_items=N_ITEMS, session_cohesiveness=200, seed=2)
    items, _ = gen.generate_sessions(B_TRAIN * 2)
    ds = ClozeDataset(items, gen.item_vocab(), max_items=50)
    host = next(ds.train_batches(B_TRAIN, seed=0))
    small = next(ds.train_batches(B_CHECK, seed=1))
    neg = sample_negatives(num_valid, SAMPLED, torch.Generator().manual_seed(SEED))
    loss_tol, grad_tol = TRAIN_TOL["float32"]
    cfg32 = dataclasses.replace(cfg, dropout_rate=0.0, dtype="float32")
    sd = seeded_state_dict(cfg32, SEED + 4)
    results = []
    for device in ("cuda", "cpu"):
        m = ClickstreamModel(cfg32, device=device)
        m.load_state_dict(sd)
        loss = make_loss_fn(m, fused_ce_num_valid=num_valid)(to_device(small, device), None, neg.to(device))
        grads = torch.autograd.grad(loss, list(m.parameters()))
        results.append((loss.item(), {n: g.float().cpu() for (n, _), g in zip(m.named_parameters(), grads)}))
    (gl, gg), (cl, cg) = results
    errs = {n: ((gg[n] - cg[n]).norm() / cg[n.replace("wk.bias", "wq.bias")].norm().clamp(min=1e-30)).item()
            for n in cg}
    worst = max(errs, key=errs.get)
    log(f"[sampled] {SAMPLED} negatives, B={B_CHECK} f32 dropout 0, card vs CPU: loss {gl:.6f} vs {cl:.6f} "
        f"(tol {loss_tol:.0e}); relative gradient norm error median {statistics.median(errs.values()):.2e}, worst "
        f"{errs[worst]:.2e} at {worst} (tol {grad_tol:.0e})")
    if abs(gl - cl) > loss_tol or errs[worst] > grad_tol:
        raise AssertionError("sampled softmax: card and CPU steps differ")
    model = ClickstreamModel(cfg, device="cuda")
    model.load_state_dict(seeded_state_dict(cfg, SEED + 4))
    tx = make_optimizer(TrainConfig(), mu_dtype=torch.bfloat16)
    step = make_train_step(model, tx, schedules.constant(1e-3), fused_ce_num_valid=num_valid,
                           sampled_softmax_samples=SAMPLED,
                           negatives_generator=torch.Generator("cuda").manual_seed(SEED))
    state = TrainState.create(dict(model.named_parameters()), tx)
    batch = to_device(host, "cuda")
    state, _ = step(state, batch, torch.Generator("cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state, loss = step(state, batch, torch.Generator("cuda").manual_seed(SEED + 1))
    loss = loss.item()
    ms = (time.perf_counter() - t0) * 1e3
    counts = {c: v for c, v in _build.launch_counts().items() if v}
    want = {"gather": 1, "attention": 4, "attention_bwd": 4}
    log(f"[sampled] flagship B={B_TRAIN} bf16 dropout {cfg.dropout_rate} step on the card: loss {loss:.4f}, "
        f"{ms:.1f} ms (host clock, one step), launches {counts} [{card}]")
    if counts != want or not np.isfinite(loss):
        raise AssertionError(f"sampled softmax step: launches {counts} (want {want}), loss {loss}")


def _windowed_plain(x, table, lab, logz, dnll, off: int, nv: int, windows: int):
    """The plain CE version over row windows of ``table``, each with its
    row_start, combined as the vocab-sharded tier combines shards. Without
    ``logz``: the logz of the forward (the windows' (m, l) by the max and
    the rescaled sum). With it: (dx, dW) of the merged backward, each
    window's A rounded to x's dtype as the plain version rounds it, dx
    summed over the windows in f32 and rounded once to x's dtype (as the
    unwindowed plain version's one f32 product), dW the windows' rows."""
    from bert4clickpath_torch.ops.kernels import fused_ce as k

    v, d = table.shape
    per = -(-v // windows)
    if logz is None:
        parts = [k.ce_stats_reference(x, table[lo : lo + per], None, off, nv, lo) for lo in range(0, v, per)]
        m = torch.stack([p[0] for p in parts])
        gmax = m.max(dim=0).values
        return gmax + torch.log((torch.stack([p[1] for p in parts]) * torch.exp(m - gmax)).sum(dim=0))
    dx = torch.zeros((x.shape[0], d), dtype=torch.float32, device=x.device)
    dw = torch.empty((v, d), dtype=torch.float32, device=x.device)
    for lo in range(0, v, per):
        tw = table[lo : lo + per]
        a = k._adjoint(x, tw, None, lab, logz, dnll, off, nv, lo).to(x.dtype).float()
        dx += a @ tw.to(x.dtype).float()
        dw[lo : lo + per] = a.T @ x.float()
        del a
    return dx.to(x.dtype), dw


def large_ce_at(v_rows: int, d: int, labels_np, windows: int, card: str, dtype, timed: bool) -> dict:
    """The CE forward and the merged backward at N = labels_np.size rows of
    x in ``dtype`` over a (v_rows, d) f32 table of N(0, 0.02^2) drawn on the
    card, the labels those of the stress batch: logz, dx and dW held against
    the plain version over ``windows`` row windows (logz within 1e-5 of the
    largest |logz|, dx and dW within CE_GRAD_REL of their largest value:
    the sharded-ce phase's tolerances; a bf16 dx adds the one bf16 ulp of
    the value between its neighbours, where the two f32 sums straddle a
    rounding boundary), the forward run twice bit-equal; with ``timed``,
    the kernels' and the windowed plain version's times and the bounds (a
    product rated at the numerics of the kernel that runs it: f32 x three
    tf32 products, bf16 x one bf16 product), and for f32 x the merged
    backward's dx reduce-adds measured against a copy of its source built
    without them (``kCeBwdDxReduce = false``)."""
    from bert4clickpath_torch.constants import LABEL_PAD, NUM_RESERVED_TOKENS
    from bert4clickpath_torch.ops.fused_ce import _labels_model
    from bert4clickpath_torch.ops.kernels import fused_ce as k

    n, off = labels_np.size, NUM_RESERVED_TOKENS
    nv = v_rows - off - 1
    generator = torch.Generator("cuda").manual_seed(SEED + 7)
    x = torch.randn((n, d), generator=generator, device="cuda").to(dtype)
    table = torch.randn((v_rows, d), generator=generator, device="cuda").mul_(0.02)
    labels = torch.from_numpy(np.ascontiguousarray(labels_np.reshape(-1))).cuda()
    lab = _labels_model(labels, off)
    mask = (labels != LABEL_PAD).float()
    dnll = mask / mask.sum()
    short = "bf16" if dtype == torch.bfloat16 else "f32"
    tag = (f"N={n} V={v_rows:,} D={d} {short} x (V x D = {v_rows * d:,}"
           f"{' > 2^31' if v_rows * d >= 2**31 else ''})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want_logz = _windowed_plain(x, table, None, None, None, off, nv, windows)
    m, l = k.ce_stats(x, table, None, off, nv)
    m2, l2 = k.ce_stats(x, table, None, off, nv)
    logz = m + torch.log(l)
    scale = want_logz.abs().max().item()
    e_fwd = (logz - want_logz).abs().max().item()
    log(f"[large-catalog] CE forward {tag}: schedule {k.ce_splits(n, v_rows)} (vocab splits, tiles a split); logz "
        f"max_abs_err {e_fwd:.3e} against the plain version over {windows} windows (tol {1e-5 * scale:.3e}: 1e-5 "
        f"of |logz|); two runs bit-equal")
    if not torch.isfinite(logz).all() or e_fwd > 1e-5 * scale or not (torch.equal(m, m2) and torch.equal(l, l2)):
        raise AssertionError(f"CE forward {tag}: error {e_fwd}, or two runs differ")
    del m2, l2
    want_dx, want_dw = _windowed_plain(x, table, lab, want_logz, dnll, off, nv, windows)
    got_dx, got_dw, _ = k.ce_backward(x, table, None, lab, want_logz, dnll, off, nv)
    torch.cuda.synchronize()
    errs = {}
    for name, g, w in (("dx", got_dx, want_dx), ("dW", got_dw, want_dw)):
        diff, w = (g.float() - w.float()).abs(), w.float()
        e, top = diff.max().item(), w.abs().max().item()
        tol = CE_GRAD_REL * top
        if g.dtype == torch.bfloat16:  # one bf16 ulp of the value, as gather_kernel_at computes it
            tol = tol + torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - 8)
        used = (diff / tol).max().item()
        log(f"[large-catalog] CE backward ({k.ce_backward_route(d)}) {tag} {name}: max_abs_err {e:.3e}, largest "
            f"|value| {top:.3e}; {used:.3f} of the tolerance ({CE_GRAD_REL:.0e} of the largest"
            f"{' + one bf16 ulp of the value' if g.dtype == torch.bfloat16 else ''})")
        if not torch.isfinite(g).all() or used > 1.0:
            raise AssertionError(f"CE backward {tag} {name}: error {e}, {used} of the tolerance")
        errs[name] = e
    blinded = torch.ones(v_rows, dtype=torch.bool, device="cuda")
    blinded[off : off + nv] = False
    if not bool((got_dw[blinded] == 0).all()):
        raise AssertionError(f"CE backward {tag}: a blinded table row got a gradient")
    del want_dx, want_dw, got_dx, got_dw, diff, tol
    log(f"[large-catalog] {tag}: checks took {time.perf_counter() - t0:.2f} s")
    if not timed:
        return {}
    bwd = lambda: k.ce_backward(x, table, None, lab, want_logz, dnll, off, nv)  # noqa: E731
    ms_fwd = device_time_ms(lambda: k.ce_stats(x, table, None, off, nv), 5, warm=1)
    ms_bwd = device_time_ms(bwd, 5, warm=1)
    plain_fwd = device_time_ms(lambda: _windowed_plain(x, table, None, None, None, off, nv, windows), 2, warm=1)
    plain_bwd = device_time_ms(lambda: _windowed_plain(x, table, lab, want_logz, dnll, off, nv, windows), 2,
                               warm=1)
    live = int(mask.sum().item())
    itemsize = x.element_size()
    kind, terms = ("bf16", 1) if dtype == torch.bfloat16 else DX_RATING
    fwd = dict(max_abs_err=e_fwd, ms=ms_fwd, plain_ms=plain_fwd, library_ms=None,
               **log_ce_fwd(tag, n, nv, d, dtype, ms_fwd, plain_fwd, card))
    # merged backward: x, the window's rows, labels, logz and dnll in; dx
    # and dW out; three products over the labelled rows (scores, dx, dW)
    bwd_row = dict(max_abs_err=max(errs.values()), ms=ms_bwd, plain_ms=plain_bwd, library_ms=None,
                   **bound(2 * n * d * itemsize + 2 * nv * d * 4 + 3 * n * 4, {kind: terms * 6.0 * live * nv * d}))
    log(f"[large-catalog] CE merged backward {tag}: {ms_bwd:.3f} ms; bound {bwd_row['bound_ms']:.3f} ms "
        f"({bwd_row['bound_by']}, {terms} {kind} product(s) for each; share {bwd_row['bound_ms'] / ms_bwd:.3f}); plain "
        f"over {windows} windows {plain_bwd:.3f} ms ({plain_bwd / ms_bwd:.2f}x the kernel); {live} labelled rows "
        f"[{card}]")
    if dtype == torch.float32:
        ce_atomics_share(bwd, ms_bwd, tag, card)
    return {"ce_fwd_large": fwd, "ce_bwd_large": bwd_row}


def ce_atomics_share(bwd, ms_bwd: float, tag: str, card: str) -> None:
    """The merged backward's dx reduction across units: the kernel timed in
    turns with a copy of its source built without it (``kCeBwdDxReduce =
    false``: the dx product kept, its TMA reduce-adds dropped; a tune
    variant, whose dx is not the sum), through
    ``examples/long_context/tune_blockwise_bwd.py``'s ``build_variants``."""
    from bert4clickpath_torch.ops.kernels import _build

    tune = _tune_module()
    entry = ["b4cp_ce_bwd"]
    real = _build.library()
    variant = tune._Swapped(real, tune.build_variants({"no_dx_atomics": {"kCeBwdDxReduce": "false"}}, ["fused_ce.cu"],
                                                      entry)["no_dx_atomics"], entry)
    times = {"shipped": [ms_bwd], "no_dx_atomics": []}
    try:
        for name in ("no_dx_atomics", "no_dx_atomics", "shipped"):
            _build._lib = variant if name == "no_dx_atomics" else real
            times[name].append(device_time_ms(bwd, 3, warm=1))
    finally:
        _build._lib = real
    shipped, without = min(times["shipped"]), min(times["no_dx_atomics"])
    log(f"[large-catalog] CE merged backward {tag}: {shipped:.3f} ms shipped, {without:.3f} ms without the dx "
        f"atomics (in turns, best of each): the atomics {shipped - without:.3f} ms, {(shipped - without) / shipped:.1%} "
        f"of the kernel [{card}]")


def phase_large_catalog(card: str) -> tuple[dict, dict]:
    """``examples/large_catalog/stress_torch.py`` (BASELINE configs[4]) on
    one rank: its ``main`` at the defaults (10M items: 10,000,384 table rows
    of 128, B = 256, bf16, dropout 0.1), STRESS_STEPS timed steps with exact
    launches per step (CE forward 1, merged CE backward 1, whole-row
    attention 2 + 2, no gather: the tier's lookup is the sharded plain one),
    every loss finite and the first within 0.5 of ln(10^7); then
    ``--sampled`` (no CE launch). Then the CE kernels at the stress shape
    against the plain version over row windows, the V x D > 2^31 case, and
    the whole-row attention at the stress model's head width, dh = 32.
    Returns (kernel rows, launches per stress step)."""
    import math

    import torch.distributed as dist

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "large_catalog"))
    import stress_torch

    from bert4clickpath_torch.data.synthetic import synthetic_batch

    t0 = time.perf_counter()
    run = stress_torch.main(["--steps", str(STRESS_STEPS)],
                            profile=lambda steps, fn: _device_profile(fn, steps, "large-catalog", card))
    want = {"ce_fwd": 1, "ce_bwd": 1, "attention": 2, "attention_bwd": 2}
    log(f"[large-catalog] stress {run['rows']:,} rows: first loss {run['first_loss']:.4f} (ln 10^7 = "
        f"{math.log(1e7):.4f}), last {run['loss']:.4f}; {run['ms_per_step']:.1f} ms/step, "
        f"{run['examples_per_s']:.1f} examples/s (host clock); launches per step {run['launches']}; peak "
        f"{run['peak_bytes'] / 2**30:.2f} GiB; {time.perf_counter() - t0:.2f} s [{card}]")
    if (run["launches"] != want or not all(math.isfinite(v) for v in run["losses"])
            or abs(run["first_loss"] - math.log(1e7)) > 0.5 or run["shard_rows"] != run["rows"]):
        raise AssertionError(f"stress: launches {run['launches']} (want {want}), losses {run['losses']}")
    per_step = run["launches"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sampled = stress_torch.main(["--sampled", str(STRESS_SAMPLED), "--steps", str(STRESS_SAMPLED_STEPS)])
    want = {"attention": 2, "attention_bwd": 2}
    log(f"[large-catalog] stress --sampled {STRESS_SAMPLED}: first loss {sampled['first_loss']:.4f}, last "
        f"{sampled['loss']:.4f}; {sampled['ms_per_step']:.1f} ms/step (host clock); launches per step "
        f"{sampled['launches']}; peak {sampled['peak_bytes'] / 2**30:.2f} GiB; {time.perf_counter() - t0:.2f} s "
        f"[{card}]")
    if sampled["launches"] != want or not all(math.isfinite(v) for v in sampled["losses"]):
        raise AssertionError(f"stress --sampled: launches {sampled['launches']} (want {want})")
    if dist.is_initialized():
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # the CE kernels at the stress shape, on the stress batch's labels: f32
    # x, as the SPMD step gives them (gather_head_inputs returns f32), for
    # the summary; bf16 x logged beside
    host = synthetic_batch(np.random.default_rng(0), 256, 50, 10, 10_000_000)
    out = large_ce_at(run["rows"], 128, host["labels"], STRESS_WINDOWS, card, torch.float32, timed=True)
    torch.cuda.empty_cache()
    large_ce_at(run["rows"], 128, host["labels"], STRESS_WINDOWS, card, torch.bfloat16, timed=True)
    torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.bfloat16):
        large_ce_at(BIG_V, BIG_D, host["labels"], BIG_WINDOWS, card, dtype, timed=False)
        torch.cuda.empty_cache()

    # whole-row attention at the stress model's shape: (256, 53, 128), H = 4
    rng = np.random.default_rng(SEED + 8)
    b, seq, d, h = 256, 53, 128, 4
    fwd_err, fwd_times = attention_forward_at(rng, b, seq, d, h)
    bwd_err, bwd_times, (q, k, v, bias, do) = attention_backward_at(rng, b, seq, d, h, card)
    lib_fwd, lib_bwd = sdpa_times(*(t.to(torch.bfloat16) for t in (q, k, v)), bias, do.to(torch.bfloat16), h)
    bounds = attention_bounds(b, seq, d, h, 2)
    out["attention_dh32"] = dict(max_abs_err=fwd_err, ms=fwd_times[0], plain_ms=fwd_times[1], library_ms=lib_fwd,
                                 **bounds["fwd"])
    out["attention_bwd_dh32"] = dict(max_abs_err=bwd_err, ms=bwd_times[0], plain_ms=bwd_times[1],
                                     library_ms=lib_bwd, **bounds["bwd"])
    for name, row in out.items():
        log(f"[large-catalog] {name}: kernel {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
            f"(share {row['bound_ms'] / row['ms']:.3f}), plain {row['plain_ms']:.4f} ms, library "
            f"{row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 4)} ms [{card}]")
    return out, per_step


def phase_multihost(card: str) -> None:
    """``examples/multihost/demo_torch.py --procs MULTIHOST_PROCS`` on the
    card: hosts of 4 ranks each, every rank started as torchrun starts it,
    all sharing the one card over gloo; it asserts that every rank reports
    the same falling losses and prints ``multihost demo OK``."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "multihost", "demo_torch.py")
    out = subprocess.run([sys.executable, script, "--procs", str(MULTIHOST_PROCS)], capture_output=True, text=True,
                         timeout=600)
    for line in out.stdout.splitlines():
        log(f"[multihost] {line}")
    if out.returncode != 0 or "multihost demo OK" not in out.stdout:
        raise AssertionError(f"multihost demo failed ({out.returncode}): {out.stderr[-3000:]}")


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
    heads = timed("heads", phase_heads, card)
    log("[heads] launches per train step: " + json.dumps({tag: run["counts"] for tag, run in heads.items()}))
    kernels.update(timed("sharded-ce", phase_sharded_ce, card))
    tiers = timed("tiers", phase_tiers, card)
    tp_tiers = timed("tp-tiers", phase_tp_tiers, card)
    log("[tp-tiers] launches per rank in the f32 runs: " + json.dumps(tp_tiers))
    timed("cli-dp", phase_cli_dp, card)
    timed("sampled", phase_sampled, card)
    large, stress_counts = timed("large-catalog", phase_large_catalog, card)
    kernels.update(large)
    timed("multihost", phase_multihost, card)
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
        ("fused_ce_bwd_dw", "fused_ce_mma.cuh", "fused_ce.py:321", "ce_bwd_dw", wide_train),
        ("blockwise_mha_fwd", "attention_blockwise.cu", "attention.py:198", "blockwise_fwd", long_train),
        ("blockwise_mha_dq", "attention_blockwise.cu", "attention.py:245", "blockwise_dq", long_train),
        ("blockwise_mha_dkv", "attention_blockwise.cu", "attention.py:283", "blockwise_dkv", long_train),
        ("fused_dropout", "dropout.cu", "dropout.py:46", "dropout", long_train),
        # the CE kernels with their row_start on a row shard: held in the
        # sharded-ce phase, launched on the vocab-sharded tier's main path
        # (rank 0's timed steps; the pair on the wide model)
        ("fused_ce_fwd_sharded", "fused_ce.cu", "fused_ce.py:134", "ce_fwd_sharded", {"counts": tiers["spmd"]}),
        ("fused_ce_bwd_sharded", "fused_ce.cu", "fused_ce.py:761", "ce_bwd_sharded", {"counts": tiers["spmd"]}),
        ("fused_ce_bwd_dx_sharded", "fused_ce_two_pass.cu", "fused_ce.py:293", "ce_bwd_dx_sharded",
         {"counts": tiers["spmd wide"]}),
        ("fused_ce_bwd_dw_sharded", "fused_ce_mma.cuh", "fused_ce.py:321", "ce_bwd_dw_sharded",
         {"counts": tiers["spmd wide"]}),
        # the large-catalog path (stress_torch.py, 10,000,384 rows, D = 128,
        # bf16 x): its timed steps' launches per step
        ("fused_ce_fwd_large", "fused_ce.cu", "fused_ce.py:134", "ce_fwd_large", {"counts": stress_counts}),
        ("fused_ce_bwd_large", "fused_ce.cu", "fused_ce.py:761", "ce_bwd_large", {"counts": stress_counts}),
        ("fused_mha_fwd_dh32", "attention.cu", "attention.py:54", "attention_dh32", {"counts": stress_counts}),
        ("fused_mha_bwd_dh32", "attention.cu", "attention.py:76", "attention_bwd_dh32", {"counts": stress_counts}),
    ]
    summary = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"bert4clickpath_torch/csrc/{src}",
            "replaces": pallas + tpu,
            "launches": path["counts"][re.sub(r"_(sharded|large|dh32)$", "", counter)],
            **{k: kernels[counter][k] for k in
               ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        }
        for name, src, tpu, counter, path in rows
    ]}
    for row in summary["kernels"]:
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was not launched on its main path")
    from bert4clickpath_torch.ops.kernels import _build

    log(f"[summary] input copies the kernels' wrappers made in the whole run: {_build.copy_counts()}")
    if any(_build.copy_counts().values()):
        raise AssertionError(f"a wrapper copied inputs on a main path: {_build.copy_counts()}")
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
