"""Drive the PyTorch port's serving path and its train step once on one
CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  — requires a CUDA card; prints its name and power limit
   (nvidia-smi) and the TF32 flags (left off: the catalog scan and the CE
   are f32).
2. build   — builds the port's CUDA kernels from ``bert4clickpath_torch/csrc``
   with nvcc for sm_90a and prints the build time and ptxas' report.
3. kernels — holds each kernel against its plain PyTorch version on the card,
   the forward kernels at the serving shapes and the training kernels (MHA
   backward, fused CE forward and backward) at the flagship's training
   shapes, with the tolerance stated, and times both (CUDA events; median
   device time of warm calls).
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

The line before the last is the card's name and power limit; the line
before that is the kernels' JSON summary; the last line is the device JSON.
Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
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
REQUESTS = 100  # per batch size: p90 has 10 samples beyond it
PROFILED = 10  # requests per batch size in the profiled window
K = 10
# tolerances (stated): attention bf16 abs 2e-2 (one bf16 ulp of an O(1)
# output), f32 abs 1e-5 (sums in another order); gather within one ulp of
# its output type (both versions round the same f32 value once); served
# log-probs, GPU vs CPU plain path, both bf16, abs 2e-2
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
SERVE_TOL = 2e-2
# attention backward (atol, rtol): bf16 one or two ulps of an O(1) gradient
# (p, dp and ds summed in another order, so ds may round the other way);
# f32 sums in another order
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


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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


def phase_kernels() -> dict:
    from bert4clickpath_torch.ops.kernels.attention import mha, mha_reference
    from bert4clickpath_torch.ops.kernels.gather import gather_scale_pos, gather_scale_pos_reference

    rng = np.random.default_rng(SEED)
    seq, d, h = 53, 256, 4
    out = {}
    with torch.inference_mode():
        # attention: qkv as strided column slices of one (B, L, 3D) tensor
        errs, times = [], {}
        for b in (1, 64, B_TRAIN):  # serving batches 1 and 64, the train step's 256
            for dtype in (torch.bfloat16, torch.float32):
                qkv, bias = _qkv_bias(b, seq, d, rng, full_pad_row=(b > 1))
                qkv = qkv.to(dtype)
                q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
                got = mha(q, k, v, bias, h)
                want = mha_reference(q, k, v, bias, h)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    raise AssertionError(f"attention B={b} {dtype}: non-finite output")
                err = (got.float() - want.float()).abs().max().item()
                log(f"[kernels] attention B={b} L={seq} D={d} H={h} {dtype}: "
                    f"max_abs_err {err:.3e} (tol {ATTN_TOL[dtype]:.0e})")
                if err > ATTN_TOL[dtype]:
                    raise AssertionError(f"attention B={b} {dtype}: error {err} > {ATTN_TOL[dtype]}")
                if dtype == torch.bfloat16:
                    errs.append(err)
                    times[b] = (
                        device_time_ms(lambda: mha(q, k, v, bias, h)),
                        device_time_ms(lambda: mha_reference(q, k, v, bias, h)),
                    )
                    log(f"[kernels] attention B={b} bf16: kernel {times[b][0] * 1e3:.1f} us, "
                        f"plain {times[b][1] * 1e3:.1f} us (median device time)")
        # the summary reports the train step's shape (B=256), its main path
        out["attention"] = dict(max_abs_err=max(errs), ms=times[B_TRAIN][0], plain_ms=times[B_TRAIN][1])

        # gather: the padded Beauty-sized table, ids including 0 and V-1
        v_rows = 55_296
        table = torch.from_numpy(rng.standard_normal((v_rows, d), dtype=np.float32) * 0.02).cuda()
        pos = torch.from_numpy(rng.standard_normal((seq, d), dtype=np.float32)).cuda()
        scale = 16.0  # sqrt(d_model)
        errs, times = [], None
        for b, dtype in ((64, torch.bfloat16), (64, torch.float32), (B_TRAIN, torch.bfloat16)):
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
                log(f"[kernels] gather B={b} bf16: kernel {times[0] * 1e3:.1f} us, "
                    f"plain {times[1] * 1e3:.1f} us (median device time)")
        # the last timing is the train step's shape (B=256)
        out["gather"] = dict(max_abs_err=max(errs), ms=times[0], plain_ms=times[1])
    out.update(training_kernels(rng))
    return out


def training_kernels(rng) -> dict:
    """The train step's kernels at the flagship's training shapes."""
    from bert4clickpath_torch.constants import LABEL_PAD
    from bert4clickpath_torch.ops.fused_ce import _labels_model
    from bert4clickpath_torch.ops.kernels.attention import mha_backward, mha_backward_reference
    from bert4clickpath_torch.ops.kernels.fused_ce import (
        ce_backward,
        ce_backward_reference,
        ce_stats,
        ce_stats_reference,
    )

    out = {}
    seq, d, h, b = 53, 256, 4, B_TRAIN
    # attention backward: B=256, ragged padding and one fully padded row
    errs, times = [], None
    for dtype in (torch.bfloat16, torch.float32):
        qkv, bias = _qkv_bias(b, seq, d, rng, full_pad_row=True)
        qkv = qkv.to(dtype)
        q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
        do = torch.from_numpy(rng.standard_normal((b, seq, d), dtype=np.float32)).cuda().to(dtype)
        got = mha_backward(q, k, v, bias, do, h)
        want = mha_backward_reference(q, k, v, bias, do, h)
        torch.cuda.synchronize()
        atol, rtol = ATTN_BWD_TOL[dtype]
        err = 0.0
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            if not torch.isfinite(g).all():
                raise AssertionError(f"attention backward {name} {dtype}: non-finite")
            diff = (g.float() - w.float()).abs()
            if bool((diff > atol + rtol * w.float().abs()).any()):
                raise AssertionError(f"attention backward {name} {dtype}: max error {diff.max().item()}")
            err = max(err, diff.max().item())
        log(f"[kernels] attention backward B={b} L={seq} D={d} H={h} {dtype}: "
            f"max_abs_err {err:.3e} (tol abs {atol:.0e} + rel {rtol:.0e})")
        if dtype == torch.bfloat16:
            errs.append(err)
            times = (
                device_time_ms(lambda: mha_backward(q, k, v, bias, do, h)),
                device_time_ms(lambda: mha_backward_reference(q, k, v, bias, do, h)),
            )
            log(f"[kernels] attention backward B={b} bf16: kernel {times[0] * 1e3:.1f} us, "
                f"plain {times[1] * 1e3:.1f} us (median device time)")
    out["attention_bwd"] = dict(max_abs_err=max(errs), ms=times[0], plain_ms=times[1])

    # fused CE: N = B * P rows, the padded Beauty-sized table, f32 x
    n, v_rows, off, nv = B_TRAIN * 10, 55_296, 10, N_ITEMS
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
            log(f"[kernels] CE backward {name} (bias={with_bias}): max_abs_err {e:.3e}, "
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
    out["ce_fwd"] = dict(max_abs_err=fwd_err, ms=t_fwd[0], plain_ms=t_fwd[1])
    out["ce_bwd"] = dict(max_abs_err=bwd_err, ms=t_bwd[0], plain_ms=t_bwd[1])
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


def seeded_state_dict(cfg, seed: int) -> dict:
    """Random weights from a numpy seed: N(0, 0.02) matrices and tables,
    zero biases, LayerNorm scale 1 / bias 0."""
    from bert4clickpath_torch.models.encoder import LayerNorm
    from bert4clickpath_torch.models.model import ClickstreamModel

    rng = np.random.default_rng(seed)
    skeleton = ClickstreamModel(cfg, device="meta")
    ln_scales = {f"{n}.weight" for n, m in skeleton.named_modules() if isinstance(m, LayerNorm)}
    sd = {}
    for key, t in skeleton.state_dict().items():
        if key in ln_scales:
            arr = np.ones(t.shape, np.float32)
        elif key.endswith("bias"):
            arr = np.zeros(t.shape, np.float32)
        else:
            arr = rng.standard_normal(t.shape, dtype=np.float32) * np.float32(0.02)
        sd[key] = torch.from_numpy(arr)
    return sd


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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
        expected = {"gather": n_req, "attention": n_req * cfg.num_layers,
                    "attention_bwd": 0, "ce_fwd": 0, "ce_bwd": 0}
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    from bert4clickpath_torch.models.model import ClickstreamModel
    from bert4clickpath_torch.ops.kernels import _build
    from bert4clickpath_torch.training import schedules
    from bert4clickpath_torch.training.train_state import (
        TrainState,
        make_loss_fn,
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
    expected = {k: v * n_steps for k, v in per_step.items()}
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
    worst_errs = {}
    for dtype, (loss_tol, grad_tol) in TRAIN_TOL.items():
        cfg0 = dataclasses.replace(cfg, dropout_rate=0.0, dtype=dtype)
        sd = seeded_state_dict(cfg0, SEED + 2)
        results = []
        for device in ("cuda", "cpu"):
            m = ClickstreamModel(cfg0, device=device)
            m.load_state_dict(sd)
            names = [n for n, _ in m.named_parameters()]
            loss = make_loss_fn(m, fused_ce_num_valid=num_valid)(to_device(small, device))
            grads = torch.autograd.grad(loss, [p for _, p in m.named_parameters()])
            results.append((loss.item(), {n: g.float().cpu() for n, g in zip(names, grads)}))
        (gpu_loss, gpu_g), (cpu_loss, cpu_g) = results
        errs = {n: ((gpu_g[n] - cpu_g[n]).norm() / cpu_g[n].norm().clamp(min=1e-30)).item() for n in cpu_g}
        worst = max(errs, key=lambda n: (not np.isfinite(errs[n]), errs[n]))
        log(f"[train] B={B_CHECK} dropout 0 {dtype}, card vs CPU: loss {gpu_loss:.6f} vs {cpu_loss:.6f} "
            f"(|diff| {abs(gpu_loss - cpu_loss):.2e}, tol {loss_tol:.0e}); relative gradient norm error "
            f"median {statistics.median(errs.values()):.2e}, worst {errs[worst]:.3e} at {worst} (tol {grad_tol:.0e})")
        if not abs(gpu_loss - cpu_loss) <= loss_tol or not errs[worst] <= grad_tol:
            raise AssertionError(
                f"card and CPU train steps differ ({dtype}): loss {gpu_loss} vs {cpu_loss}, {worst} {errs[worst]}"
            )
        worst_errs[dtype] = errs[worst]
    log(f"[train] card vs CPU checks in {time.perf_counter() - t0:.2f} s")
    return dict(counts=counts, examples_per_s=ex_s, ms_per_step=secs[-1] / K_TRAIN * 1e3, peak_bytes=peak,
                profile=prof, stages_ms=stages, first10=first, last10=last, worst_grad_err=worst_errs)


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
    kernels = timed("kernels", phase_kernels)
    timed("serve", phase_serve, card)
    train = timed("train", phase_train, card)
    rows = [
        ("fused_gather_scale_pos", "gather.cu", "gather.py:37", "gather", "gather"),
        ("fused_mha_fwd", "attention.cu", "attention.py:54", "attention", "attention"),
        ("fused_mha_bwd", "attention.cu", "attention.py:76", "attention_bwd", "attention_bwd"),
        ("fused_ce_fwd", "fused_ce.cu", "fused_ce.py:134", "ce_fwd", "ce_fwd"),
        ("fused_ce_bwd", "fused_ce.cu", "fused_ce.py:761", "ce_bwd", "ce_bwd"),
    ]
    summary = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"bert4clickpath_torch/csrc/{src}",
            "replaces": f"bert4clickpath_tpu/ops/pallas/{tpu}",
            # launches in the train step's timed window (the slice's main path)
            "launches": train["counts"][counter],
            **{k: kernels[key][k] for k in ("max_abs_err", "ms", "plain_ms")},
        }
        for name, src, tpu, counter, key in rows
    ]}
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
