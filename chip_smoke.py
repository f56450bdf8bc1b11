"""Drive the PyTorch port's serving path once on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  — requires a CUDA card; prints its name and power limit
   (nvidia-smi) and the TF32 flags (left off: the catalog scan is f32).
2. build   — builds the port's CUDA kernels from ``bert4clickpath_torch/csrc``
   with nvcc for sm_90a and prints the build time and ptxas' report.
3. kernels — holds each kernel against its plain PyTorch version on the card
   at the serving shapes, with the tolerance stated, and times both
   (CUDA events; median device time of warm calls).
4. serve   — exports the flagship configuration (4 layers, d_model 256,
   4 heads, FFN 1024, L=53, qkv_fused, bf16 compute, tied softmax over a
   54,542-item catalog) with seeded random weights, loads it with
   ``ServingModel(device="cuda")``, answers requests of batch 1, 8 and 64,
   checks that both kernels were launched by those requests, and checks the
   answers against the same bundle served on the CPU (the plain path).

The line before the last is the card's name and power limit; the line
before that is the kernels' JSON summary; the last line is the device JSON.
Imports nothing of JAX.
"""

from __future__ import annotations

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
        for b in (1, 64):
            for dtype in (torch.bfloat16, torch.float32):
                qkv, bias = _qkv_bias(b, seq, d, rng, full_pad_row=(b == 64))
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
        out["attention"] = dict(max_abs_err=max(errs), ms=times[64][0], plain_ms=times[64][1],
                                ms_b1=times[1][0], plain_ms_b1=times[1][1])

        # gather: the padded Beauty-sized table, ids including 0 and V-1
        v_rows, b = 55_296, 64
        table = torch.from_numpy(rng.standard_normal((v_rows, d), dtype=np.float32) * 0.02).cuda()
        ids_np = rng.integers(0, v_rows, size=(b, seq)).astype(np.int32)
        ids_np[0, 0], ids_np[0, 1] = 0, v_rows - 1
        ids = torch.from_numpy(ids_np).cuda()
        pos = torch.from_numpy(rng.standard_normal((seq, d), dtype=np.float32)).cuda()
        scale = 16.0  # sqrt(d_model)
        errs, times = [], None
        for dtype in (torch.bfloat16, torch.float32):
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
        out["gather"] = dict(max_abs_err=max(errs), ms=times[0], plain_ms=times[1])
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
        expected = {"gather": n_req, "attention": n_req * cfg.num_layers}
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


def main() -> None:
    card = phase_device()
    phase_build()
    kernels = phase_kernels()
    serve = phase_serve(card)
    summary = {"kernels": [
        {
            "name": "fused_gather_scale_pos",
            "route": "cuda",
            "source": "bert4clickpath_torch/csrc/gather.cu",
            "replaces": "bert4clickpath_tpu/ops/pallas/gather.py:37",
            "launches": serve["counts"]["gather"],
            **{k: kernels["gather"][k] for k in ("max_abs_err", "ms", "plain_ms")},
        },
        {
            "name": "fused_mha_fwd",
            "route": "cuda",
            "source": "bert4clickpath_torch/csrc/attention.cu",
            "replaces": "bert4clickpath_tpu/ops/pallas/attention.py:54",
            "launches": serve["counts"]["attention"],
            **{k: kernels["attention"][k] for k in ("max_abs_err", "ms", "plain_ms")},
        },
    ]}
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
