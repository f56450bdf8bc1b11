"""Time the CE kernels and the bf16 blockwise attention kernels of two (or
more) checkouts of the port in turns, on one card, and hold their outputs
across the checkouts.

    python3 examples/long_context/ce_kernel_turns.py --checkouts OLD,NEW \
        --order 0,1,1,0

Each entry of ``--order`` runs in a fresh process that imports
``bert4clickpath_torch`` from that checkout (and builds its kernels there,
into its own ``build/``), times the CE entries at the training shapes and
prints one JSON line: the forward and the merged backward at N = 2,560,
V = 55,296, D = 256, the forward, the dx pass and the dW pass at D = 384,
and the forward and the merged backward at the large catalog's shape (N =
2,560, V = 10,000,384, D = 128: ``examples/large_catalog/stress_torch.py``;
a fifth of the rows LABEL_PAD, logz the log of the window's size), f32 x,
no bias (median device time of 20 warm calls, 5 at the large catalog, CUDA
events; the large table is drawn on the card from a seeded generator),
the host's cost of one merged backward call at a shape whose kernels take
a few microseconds (wall time of 500 calls, ``bwd_merged_host_us``),
then the bf16 blockwise attention forward (``blockwise_mha_forward``) at
the long-session train shape (B, L, D, H) = (16, 1024, 256, 4) and its
serving batch (8, 1024, 256, 4), q, k and v strided slices of one seeded
projection, ragged padding and one fully padded row, with
``F.scaled_dot_product_attention`` on the same inputs beside each (the
padding bias as its mask; a yardstick, used nowhere in the port), and the
host's cost of one forward call at a shape whose kernel takes a few
microseconds (wall time of 500 calls, ``bmha_fwd_host_us``); then the
backward's dq and dk/dv kernels (``blockwise_mha_dq``,
``blockwise_mha_dkv``) at the same two shapes, on the plain forward's out
and lse and a seeded output gradient, their sum beside SDPA's backward on
the same inputs (dq, dk and dv from one call), and the host's cost of one
backward call (``blockwise_mha_backward``: delta and both kernels) at the
small shape (``bmha_bwd_host_us``). Every CE
entry is called without ``row_start``, so a checkout from before the
argument existed takes the same calls. The first process of each checkout
pays its build; the parent prints the table of runs in order, and each
kernel's spread over the runs of one checkout beside the gap between the
checkouts.

Outputs: the same process then calls each entry once more on the same
inputs without and with a bias (seeded, the same in every checkout) and
keeps every output: the forward's (m, l), the merged backward's dx, dW and
db (at the large catalog dW's first 4,096 rows and the labelled ones, and
a checksum of its bits on the card), the dx pass's dx, the dW pass's dW
and db. Each is written to a
scratch directory; the parent compares every run's outputs with the first
run's. Every output must be bit-equal across all runs, with these
exceptions. The merged backward's dx sums across blocks with atomic adds
in an order that varies run to run: its largest gap between two runs of
one checkout is held to the repeat bound of ``ce_backward_merged`` (1e-5
of the largest |dx|); its dW and db are bit-equal between runs of one
checkout; across checkouts dW and db (and dW's checksum) are held
bit-equal and dx to the same repeat bound, unless ``--merged-redesigned``
says the checkouts' merged kernels sum in other orders (one of them
redesigned): then all three are held across checkouts within 1e-4 of their
largest magnitude (``chip_smoke.py``'s CE_GRAD_REL). The
forward's (m, l) must be bit-equal between runs of one checkout (nothing
in it is atomic); two checkouts whose forwards sum in different orders (a
redesigned kernel) are held to each other on logz = m + log(l) within
1e-4, the forward's tolerance. The blockwise forward's (out, lse) must be
bit-equal between runs of one checkout and, in every run, within the bound
``chip_smoke.py`` holds the kernel to against its plain version (computed
in the run: abs 2e-3 + 2^-6 of the plain value, lse 1e-5 relative); across
checkouts whose kernels step through the keys differently (a redesigned
forward) they are not bit-equal, and the gap, printed in units of that
bound taken about run 1's output, is held to 2 (each side within 1 of the
plain version). The backward's dq, dk and dv likewise: bit-equal between
runs of one checkout, within ``chip_smoke.py``'s BLOCKWISE_BWD_TOL of the
plain version in every run (2e-3 of the largest gradient, floored at
1e-2, + 2^-6 of the plain value; the fully padded batch row 0 against its
own largest magnitude), and across checkouts (sums in other orders) within
that bound taken about run 1's output. The script exits non-zero
otherwise. A card is required.

``--pair`` times the two-pass CE backward instead (the wide model's route,
``ce_backward_dx`` and ``ce_backward_dw``) and nothing else: each pass at
N = 2,560, V = 55,296, D = 384 with f32 and with bf16 x, and at D = 1,024
with f32 x (median of 10 warm calls, CUDA events), then the wide model's
train step from the checkout (``examples/bert4rec/train_torch.py --preset
tpu --d_model 384 --heads 6 --layers 4 --qkv_fused``, B = 256, built by the
checkout's ``main`` for one short epoch): wall ms/step over 20 steps on
batches already on the card and the device's busy ms/step under the
profiler over 10 (``pair_wide_wall_ms``, ``pair_wide_busy_ms``). Its
outputs (dx, dW and db with and without a bias) are held bit-equal within a
checkout and, with ``--pair-redesigned`` (checkouts whose pairs sum in
other orders), within 1e-4 of the largest magnitude across checkouts (2e-2
for bf16 x; bit-equal otherwise). ``--parts`` (with ``--pair``) builds
copies of the last checkout's ``fused_ce_two_pass.cu`` with one part of the
kernel removed (the score products, the gradient products, the loads of the
score stages or of the gradient stages, the exponentials) and times each
pass in turns with the source as it is at the wide shape, f32: what each
part costs (those copies compute wrong results; they are timed only). Every
run prints ptxas' registers and spills of each CE kernel instance and the
attention kernels' from its build.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

N, V, NUM_VALID, OFF = 2560, 55_296, 54_542, 10
V_LARGE = 10_000_384  # examples/large_catalog/stress_torch.py: BASELINE configs[4], padded
# two runs of the merged backward's dx may differ by this much of its
# largest |value| (atomic adds; ops/kernels/fused_ce.py:ce_backward_merged)
DX_REPEAT = 1e-5
LOGZ_TOL = 1e-4  # the forward's tolerance, between checkouts whose sums run in other orders
GRAD_REL = 1e-4  # the merged backward's, between redesigned checkouts (chip_smoke.py CE_GRAD_REL)
# entry at (table rows, D)
SHAPES = {"fwd_256": (V, 256), "bwd_merged_256": (V, 256), "fwd_384": (V, 384), "dx_384": (V, 384),
          "dw_384": (V, 384), "fwd_large_128": (V_LARGE, 128), "bwd_merged_large_128": (V_LARGE, 128)}
# the host's cost of one merged backward call: (N, V, D) at which its kernels take a few microseconds
HOST_CE_SHAPE = (16, 128, 256)
LARGE_DW_ROWS = 4096  # dW rows kept at the large catalog (and the labelled ones): 5.12 GB in all
# the blockwise forward at (B, L, D, H), and the library's forward beside it
ATTN = {"bmha_fwd_16": (16, 1024, 256, 4), "bmha_fwd_8": (8, 1024, 256, 4)}
# the host's cost of one forward call (the wrapper and its C entry, whose
# kernel is a few microseconds here): wall time of HOST_CALLS calls
HOST_SHAPE, HOST_CALLS = (1, 128, 256, 4), 500
# the backward pair at the same shapes (dq, dk/dv, their sum), SDPA's backward beside
BWD = {name.replace("fwd", "bwd"): shape for name, shape in ATTN.items()}
TIMED = [*SHAPES, "bwd_merged_host_us", *ATTN, *(name.replace("bmha", "sdpa") for name in ATTN), "bmha_fwd_host_us",
         *(f"{name.replace('bwd', kind)}" for name in BWD for kind in ("dq", "dkv", "pair")),
         *(name.replace("bmha", "sdpa") for name in BWD), "bmha_bwd_host_us"]
ATTN_TOL, LSE_REL = (2e-3, 2.0**-6), 1e-5  # chip_smoke.py BLOCKWISE_TOL (bf16) and its lse bound
ATTN_ACROSS = 2.0  # the gap between two checkouts' forwards, in units of that bound
# chip_smoke.py BLOCKWISE_BWD_TOL (bf16): share of the largest gradient, its floor, rtol
BWD_SHARE, BWD_FLOOR, BWD_RTOL = 2e-3, 1e-2, 2.0**-6


def bwd_used(got, want) -> float:
    """The largest share of BLOCKWISE_BWD_TOL that ``got`` uses about
    ``want`` (numpy or torch, (B, L, D)); batch row 0 (fully padded) held
    against its own largest magnitude."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    used = 0.0
    for part in (slice(0, 1), slice(1, None)):
        w = np.abs(want[part])
        atol = BWD_SHARE * max(float(w.max()), BWD_FLOOR)
        used = max(used, float((np.abs(got[part] - want[part]) / (atol + BWD_RTOL * w)).max()))
    return used


def _ce_registers(build_log: str) -> list:
    """ptxas' registers and spills of each CE kernel instance and of the
    blockwise attention kernels', from a build made in this process (empty
    when the library was already built)."""
    out, entry = [], None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            entry = next((k for k in ("ce_fwd_wgmma", "ce_fwd_mma", "ce_bwd_dx_mma", "ce_bwd_dw_mma",
                                      "ce_bwd_merged_wgmma", "ce_bwd_two_pass", "bmha_fwd_wgmma",
                                      "bmha_fwd_mma", "bmha_dq_wgmma", "bmha_dkv_wgmma", "bmha_dq_mma",
                                      "bmha_dkv_mma") if k in name), None)
            entry = entry and f"{entry}:{name[-40:]}"
        elif entry and ("registers" in line or "spill" in line):
            out.append(f"{entry} {line.split(':', 1)[-1].strip()}")
    return out


def _time_in(checkout: str, out_dir: str) -> dict:
    sys.path.insert(0, os.path.abspath(checkout))
    import numpy as np
    import torch

    from bert4clickpath_torch.ops.kernels import _build
    from bert4clickpath_torch.ops.kernels import fused_ce as k

    if not os.path.abspath(k.__file__).startswith(os.path.abspath(checkout)):
        raise RuntimeError(f"imported {k.__file__}, not the checkout {checkout}")
    if not torch.cuda.is_available():
        raise SystemExit("a CUDA card is required")
    _build.library()
    rng = np.random.default_rng(0)

    def median_ms(fn, reps=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(1_000_000)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)

    out = {"build_seconds": _build.build_seconds, "ptxas": _ce_registers(_build.build_log)}
    inputs = {}
    for d in (256, 384):
        x = torch.from_numpy(rng.standard_normal((N, d), dtype=np.float32)).cuda()
        table = torch.from_numpy(rng.standard_normal((V, d), dtype=np.float32) * 0.02).cuda()
        labels = rng.integers(0, NUM_VALID, size=N).astype(np.int32) + OFF
        labels[rng.random(N) < 0.2] = -1
        lab = torch.from_numpy(labels).cuda()
        dnll = (lab >= 0).float() / (lab >= 0).float().sum()
        m, l = k.ce_stats_reference(x, table, None, OFF, NUM_VALID)
        inputs[(V, d)] = (x, table, None, lab, m + torch.log(l), dnll, OFF, NUM_VALID)
    # the large catalog's forward: x and a 5.12 GB table drawn on the card
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn((N, 128), generator=gen, device="cuda")
    table = torch.randn((V_LARGE, 128), generator=gen, device="cuda").mul_(0.02)
    nv = V_LARGE - OFF - 1
    lab = torch.randint(OFF, OFF + nv, (N,), generator=gen, device="cuda", dtype=torch.int32)
    lab[torch.rand(N, generator=gen, device="cuda") < 0.2] = -1
    dnll = (lab >= 0).float() / (lab >= 0).float().sum()
    logz = torch.full((N,), float(np.log(nv)), device="cuda")
    inputs[(V_LARGE, 128)] = (x, table, None, lab, logz, dnll, OFF, nv)
    keep_rows = torch.unique(torch.cat([torch.arange(LARGE_DW_ROWS, device="cuda"), lab[lab >= 0].long()]))

    def entry(name, a):
        return {
            "fwd": lambda: k.ce_stats(a[0], a[1], a[2], OFF, a[7]),
            "bwd": lambda: k.ce_backward_merged(*a),
            "dx": lambda: k.ce_backward_dx(*a),
            "dw": lambda: k.ce_backward_dw(*a),
        }[name.split("_")[0]]

    for name, shape in SHAPES.items():
        out[name] = median_ms(entry(name, inputs[shape]), reps=5 if shape[0] == V_LARGE else 20)
    # the outputs, without and with a bias, for the comparison across runs
    outputs = {}
    for shape in dict.fromkeys(SHAPES.values()):
        bias = torch.randn(shape[0], generator=gen, device="cuda")
        with_bias = list(inputs[shape])
        with_bias[2] = bias
        for name in (n for n, s in SHAPES.items() if s == shape):
            for tag, a in (("", inputs[shape]), ("+bias", tuple(with_bias))):
                got = entry(name, a)()
                got = got if isinstance(got, tuple) else (got,)
                if name == "bwd_merged_large_128":  # dW: its rows kept and a checksum of all its bits
                    bits = got[1].view(torch.int32).long()
                    weight = torch.arange(bits.numel(), device="cuda").view(bits.shape) % 65_521 + 1
                    outputs[f"{name}{tag}.sum"] = np.array([int(bits.sum()), int((bits * weight).sum())])
                    got = (got[0], got[1][keep_rows], *got[2:])
                for i, t in enumerate(got):
                    if t is not None:
                        outputs[f"{name}{tag}.{i}"] = t.detach().cpu().numpy()
                del got
    del inputs[(V_LARGE, 128)], table
    torch.cuda.empty_cache()
    # the host's cost of one merged backward call
    import time

    n, v, d = HOST_CE_SHAPE
    hx = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).cuda()
    htable = torch.from_numpy(rng.standard_normal((v, d), dtype=np.float32) * 0.02).cuda()
    hlab = torch.arange(OFF, OFF + n, device="cuda", dtype=torch.int32)
    hargs = (hx, htable, None, hlab, torch.zeros(n, device="cuda"), torch.full((n,), 1.0 / n, device="cuda"),
             OFF, v - OFF)
    for _ in range(20):
        k.ce_backward_merged(*hargs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        k.ce_backward_merged(*hargs)
    torch.cuda.synchronize()
    out["bwd_merged_host_us"] = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    # the blockwise forward and the library's beside it
    import torch.nn.functional as F

    from bert4clickpath_torch.ops.kernels import attention as attn

    arng = np.random.default_rng(1)
    for name, (b, l, d, h) in ATTN.items():
        qkv = torch.from_numpy(arng.standard_normal((b, l, 3 * d), dtype=np.float32)).cuda().bfloat16()
        q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
        bias = torch.zeros(b, 1, 1, l, device="cuda")
        for i, n in enumerate(arng.integers(1, l + 1, size=b)):  # ragged padding, row 0 all padding
            bias[i, ..., 0 if i == 0 else n :] = -1e9
        out[name] = median_ms(lambda: attn.blockwise_mha_forward(q, k, v, bias, h))
        heads = lambda t: t.unflatten(-1, (h, d // h)).transpose(1, 2)  # noqa: E731
        mask = bias.bfloat16()
        out[name.replace("bmha", "sdpa")] = median_ms(
            lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v), attn_mask=mask))
        got, lse = attn.blockwise_mha_forward(q, k, v, bias, h)
        want, want_lse = attn.blockwise_mha_reference(q, k, v, bias, h)
        diff = (got.float() - want.float()).abs()
        out[f"{name}_used"] = float((diff / (ATTN_TOL[0] + ATTN_TOL[1] * want.float().abs())).max())
        out[f"{name}_lse"] = float(((lse - want_lse).abs() / want_lse.abs().clamp(min=1.0)).max())
        outputs[f"{name}.0"] = got.float().cpu().numpy()
        outputs[f"{name}.1"] = lse.cpu().numpy()
    b, l, d, h = HOST_SHAPE
    qkv = torch.from_numpy(arng.standard_normal((b, l, 3 * d), dtype=np.float32)).cuda().bfloat16()
    q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
    bias = torch.zeros(b, 1, 1, l, device="cuda")
    for _ in range(20):
        attn.blockwise_mha_forward(q, k, v, bias, h)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        attn.blockwise_mha_forward(q, k, v, bias, h)
    torch.cuda.synchronize()
    out["bmha_fwd_host_us"] = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    # the backward pair on the plain forward's out and lse
    for name, (b, l, d, h) in BWD.items():
        qkv = torch.from_numpy(arng.standard_normal((b, l, 3 * d), dtype=np.float32)).cuda().bfloat16()
        q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
        bias = torch.zeros(b, 1, 1, l, device="cuda")
        for i, n in enumerate(arng.integers(1, l + 1, size=b)):  # ragged padding, row 0 all padding
            bias[i, ..., 0 if i == 0 else n :] = -1e9
        do = torch.from_numpy(arng.standard_normal((b, l, d), dtype=np.float32)).cuda().bfloat16()
        fwd_out, lse = attn.blockwise_mha_reference(q, k, v, bias, h)
        args = (q, k, v, bias, lse, do, attn.attention_delta(do, fwd_out, h), h)
        out[name.replace("bwd", "dq")] = median_ms(lambda: attn.blockwise_mha_dq(*args))
        out[name.replace("bwd", "dkv")] = median_ms(lambda: attn.blockwise_mha_dkv(*args))
        out[name.replace("bwd", "pair")] = out[name.replace("bwd", "dq")] + out[name.replace("bwd", "dkv")]
        heads = lambda t: t.detach().unflatten(-1, (h, d // h)).transpose(1, 2)  # noqa: E731
        qh, kh, vh = (heads(t).requires_grad_() for t in (q, k, v))
        with torch.enable_grad():
            o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias.bfloat16())
        out[name.replace("bmha", "sdpa")] = median_ms(
            lambda: torch.autograd.grad(o, (qh, kh, vh), heads(do), retain_graph=True))
        got = (attn.blockwise_mha_dq(*args), *attn.blockwise_mha_dkv(*args))
        want = (attn.blockwise_dq_reference(*args), *attn.blockwise_dkv_reference(*args))
        for i, (g, w) in enumerate(zip(got, want)):
            key = f"attn{name}.{i}"
            outputs[key] = g.float().cpu().numpy()
            out[f"{key}_used"] = bwd_used(outputs[key], w.float().cpu().numpy())
    b, l, d, h = HOST_SHAPE
    qkv = torch.from_numpy(arng.standard_normal((b, l, 3 * d), dtype=np.float32)).cuda().bfloat16()
    q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
    bias = torch.zeros(b, 1, 1, l, device="cuda")
    do = torch.from_numpy(arng.standard_normal((b, l, d), dtype=np.float32)).cuda().bfloat16()
    fwd_out, lse = attn.blockwise_mha_reference(q, k, v, bias, h)
    for _ in range(20):
        attn.blockwise_mha_backward(q, k, v, bias, fwd_out, lse, do, h)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        attn.blockwise_mha_backward(q, k, v, bias, fwd_out, lse, do, h)
    torch.cuda.synchronize()
    out["bmha_bwd_host_us"] = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    np.savez(os.path.join(out_dir, "outputs.npz"), **outputs)
    out["card"] = torch.cuda.get_device_name(0)
    return out


# the pair's entries at (name, D, x's type); the wide train step's argv
PAIR = {"dx_384": (384, "float32"), "dw_384": (384, "float32"), "dx_384_bf16": (384, "bfloat16"),
        "dw_384_bf16": (384, "bfloat16"), "dx_1024": (1024, "float32"), "dw_1024": (1024, "float32")}
PAIR_TIMED = [*PAIR, "pair_wide_wall_ms", "pair_wide_busy_ms"]
WIDE_ARGV = ["--preset", "tpu", "--d_model", "384", "--heads", "6", "--layers", "4", "--qkv_fused", "--simulated",
             "--n_items", "54542", "--n_sessions", "4000", "--batch", "256", "--steps_per_epoch", "2",
             "--eval_batches", "1", "--eval_batch", "256", "--ckpt_keep", "1", "--mu_dtype", "bfloat16", "--epochs", "1"]


def _pair_inputs(rng, d: int, dtype):
    import numpy as np
    import torch

    from bert4clickpath_torch.ops.kernels import fused_ce as k

    x = torch.from_numpy(rng.standard_normal((N, d), dtype=np.float32)).cuda()
    table = torch.from_numpy(rng.standard_normal((V, d), dtype=np.float32) * 0.02).cuda()
    labels = rng.integers(0, NUM_VALID, size=N).astype(np.int32) + OFF
    labels[rng.random(N) < 0.2] = -1
    lab = torch.from_numpy(labels).cuda()
    dnll = (lab >= 0).float() / (lab >= 0).float().sum()
    m, l = k.ce_stats_reference(x, table, None, OFF, NUM_VALID)
    return (x.to(getattr(torch, dtype)), table, None, lab, m + torch.log(l), dnll, OFF, NUM_VALID)


def _wide_step(checkout: str) -> dict:
    """The wide model's train step from the checkout's training script: wall
    ms/step of 20 steps on batches already on the card, device busy ms/step
    under the profiler over 10."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bert4clickpath_torch.data.pipeline import to_device

    sys.path.insert(0, os.path.join(os.path.abspath(checkout), "examples", "bert4rec"))
    import train_torch

    work = tempfile.mkdtemp(prefix="ce_turns_wide_")
    try:
        run = train_torch.main(WIDE_ARGV + ["--model_dir", work])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    state, trainer, ds = run.state, run.trainer, run.dataset
    it = ds.train_batches(256, seed=7)
    gen = torch.Generator("cuda").manual_seed(7)
    batches = [to_device(next(it), "cuda") for _ in range(4)]
    for i in range(3):
        state, loss = trainer.train_step(state, batches[i % 4], gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(20):
        state, loss = trainer.train_step(state, batches[i % 4], gen)
    loss.item()
    wall = (time.perf_counter() - t0) / 20 * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(10):
            state, loss = trainer.train_step(state, batches[i % 4], gen)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 10 / 1e3
    return {"pair_wide_wall_ms": wall, "pair_wide_busy_ms": busy,
            "pair_wide_kernels": sum(e.count for e in kernels) / 10}


def _time_pair(checkout: str, out_dir: str) -> dict:
    sys.path.insert(0, os.path.abspath(checkout))
    import numpy as np
    import torch

    from bert4clickpath_torch.ops.kernels import _build
    from bert4clickpath_torch.ops.kernels import fused_ce as k

    if not os.path.abspath(k.__file__).startswith(os.path.abspath(checkout)):
        raise RuntimeError(f"imported {k.__file__}, not the checkout {checkout}")
    if not torch.cuda.is_available():
        raise SystemExit("a CUDA card is required")
    _build.library()
    out = {"build_seconds": _build.build_seconds, "ptxas": _ce_registers(_build.build_log)}
    outputs = {}
    rng = np.random.default_rng(0)
    for name, (d, dtype) in PAIR.items():
        if name.startswith("dw"):
            continue  # with its dx
        args = _pair_inputs(rng, d, dtype)
        for pass_name in (name, name.replace("dx", "dw")):
            fn = k.ce_backward_dx if pass_name.startswith("dx") else k.ce_backward_dw
            for _ in range(3):
                fn(*args)
            torch.cuda.synchronize()
            pairs = []
            for _ in range(10):
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                fn(*args)
                e.record()
                pairs.append((s, e))
            torch.cuda.synchronize()
            out[pass_name] = statistics.median(a.elapsed_time(b) for a, b in pairs)
        for tag, bias in (("", None), ("+bias", torch.from_numpy(rng.standard_normal(V, dtype=np.float32)).cuda())):
            a = (*args[:2], bias, *args[3:])
            got = (k.ce_backward_dx(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7]), *k.ce_backward_dw(*a))
            for i, t in enumerate(got):
                if t is not None:
                    outputs[f"pair_{name}{tag}.{i}"] = t.float().cpu().numpy()
        del args
        torch.cuda.empty_cache()
    out.update(_wide_step(checkout))
    np.savez(os.path.join(out_dir, "outputs.npz"), **outputs)
    out["card"] = torch.cuda.get_device_name(0)
    return out


# parts of the two-pass kernel removed in copies of fused_ce_two_pass.cu: [(text, its replacement)]
PAIR_PARTS = {
    "no_score_products": [("box_product<32, false>(ks, hi, lo, slot + L::kSW",
                           "if (false) box_product<32, false>(ks, hi, lo, slot + L::kSW")],
    "no_grad_products": [("box_product<32, kBf16>(gk,", "if (false) box_product<32, kBf16>(gk,")],
    "no_score_loads": [("      if (c.step < nk) {  // x's box and the table's\n",
                        "      if (c.step < nk) {  // x's box and the table's\n"
                        "        if (true) { hopper::mbar_arrive_expect_tx(full + st, 0); continue; }\n")],
    "no_grad_loads": [("        const int col = c.unit.d0 + (c.step - nk) * 64;\n",
                       "        if (true) { hopper::mbar_arrive_expect_tx(full + st, 0); continue; }\n"
                       "        const int col = c.unit.d0 + (c.step - nk) * 64;\n")],
    "no_exp": [("(expf(sv - ri[h].x) -", "((sv - ri[h].x) -")],
}


def _parts(checkout: str) -> None:
    """Copies of the checkout's fused_ce_two_pass.cu with one part cut, each
    pass timed in turns with the source as it is (f32 x, the wide shape)."""
    import ctypes

    import numpy as np
    import torch

    sys.path.insert(0, os.path.abspath(checkout))
    from bert4clickpath_torch.ops.kernels import _build
    from bert4clickpath_torch.ops.kernels import fused_ce as k

    src = (_build.CSRC / "fused_ce_two_pass.cu").read_text()
    work = tempfile.mkdtemp(prefix="ce_turns_parts_")
    procs = {}
    for name, cuts in PAIR_PARTS.items():
        text = src
        for old, new in cuts:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        d = os.path.join(work, name)
        shutil.copytree(_build.CSRC, d)
        with open(os.path.join(d, "fused_ce_two_pass.cu"), "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", os.path.join(d, "lib.so"),
                                        os.path.join(d, "fused_ce_two_pass.cu")], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    real = _build.library()
    entry = "b4cp_ce_bwd_two_pass"

    class Swapped:
        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, attr):
            return getattr(self.lib if attr == entry else real, attr)

    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        lib = ctypes.CDLL(os.path.join(work, name, "lib.so"))
        getattr(lib, entry).restype, getattr(lib, entry).argtypes = _build.SIGNATURES[entry]
        libs[name] = Swapped(lib)
    args = _pair_inputs(np.random.default_rng(0), 384, "float32")
    card = torch.cuda.get_device_name(0)
    times = {name: {"dx": [], "dw": []} for name in ["as_it_is", *libs]}
    try:
        for _ in range(2):
            for name in times:
                _build._lib = real if name == "as_it_is" else libs[name]
                for pass_name, fn in (("dx", k.ce_backward_dx), ("dw", k.ce_backward_dw)):
                    for _ in range(2):
                        fn(*args)
                    torch.cuda.synchronize()
                    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    s.record()
                    for _ in range(5):
                        fn(*args)
                    e.record()
                    torch.cuda.synchronize()
                    times[name][pass_name].append(s.elapsed_time(e) / 5)
    finally:
        _build._lib = real
        shutil.rmtree(work, ignore_errors=True)
    for name, t in times.items():
        print(f"parts {name} at N={N} V={V:,} D=384 f32: dx {min(t['dx']):.4f} ms, dW {min(t['dw']):.4f} ms "
              f"(runs dx {', '.join(f'{v:.4f}' for v in t['dx'])}; dW {', '.join(f'{v:.4f}' for v in t['dw'])}) "
              f"[{card}]", flush=True)


def _compare_pair(dirs: list, runs: list, redesigned: bool) -> bool:
    """The pair's outputs: bit-equal between runs of one checkout; across
    checkouts bit-equal, or with ``redesigned`` within 1e-4 (bf16 x: 2e-2)
    of the largest magnitude."""
    import numpy as np

    loaded = [np.load(os.path.join(d, "outputs.npz")) for d in dirs]
    ok = True
    pairs = [(i, j) for i in range(len(runs)) for j in range(i + 1, len(runs))]
    for key in loaded[0].files:
        arrays = [f[key] for f in loaded]
        within = all(np.array_equal(arrays[i], arrays[j]) for i, j in pairs if runs[i][0] == runs[j][0])
        scale = max(float(np.abs(arrays[0]).max()), 1e-30)
        across = max((float(np.abs(arrays[i].astype(np.float64) - arrays[j]).max()) / scale
                      for i, j in pairs if runs[i][0] != runs[j][0]), default=0.0)
        limit = (2e-2 if "bf16" in key else GRAD_REL) if redesigned else 0.0
        print(f"output {key}: bit-equal between runs of one checkout: {within}; across checkouts apart by "
              f"{across:.3e} of the largest |value| (held to {limit:.0e})", flush=True)
        ok &= within and across <= limit
    return ok


def _compare_outputs(dirs: list, runs: list, merged_redesigned: bool = False) -> bool:
    """Every run's outputs against the first run's: bit-equal, except the
    merged backward's dx (atomic adds), whose gap is held to its repeat
    bound, DX_REPEAT of its largest |value| (across redesigned merged
    kernels dx, dW and db to GRAD_REL of theirs), the forward's
    logz across checkouts (LOGZ_TOL) and the blockwise forward's (out, lse)
    across checkouts (ATTN_ACROSS of its bound, LSE_REL). Prints one line
    an output."""
    import numpy as np

    loaded = [np.load(os.path.join(d, "outputs.npz")) for d in dirs]
    ok = True
    for key in loaded[0].files:
        arrays = [f[key] for f in loaded]
        if key.startswith("fwd") and key.endswith(".0"):
            # (m, l): bit-equal within a checkout, logz within LOGZ_TOL across
            logz = [f[key] + np.log(f[key[:-1] + "1"]) for f in loaded]
            pairs = [(i, j) for i in range(len(runs)) for j in range(i + 1, len(runs))]
            within = all(np.array_equal(arrays[i], arrays[j])
                         and np.array_equal(loaded[i][key[:-1] + "1"], loaded[j][key[:-1] + "1"])
                         for i, j in pairs if runs[i][0] == runs[j][0])
            across = max((float(np.abs(logz[i] - logz[j]).max()) for i, j in pairs if runs[i][0] != runs[j][0]),
                         default=0.0)
            print(f"output {key[:-2]} (m, l): bit-equal between runs of one checkout: {within}; logz across "
                  f"checkouts apart by {across:.3e} at most (held to {LOGZ_TOL:.0e})", flush=True)
            ok &= within and across <= LOGZ_TOL
        elif key.startswith("fwd"):
            continue  # l: with m above
        elif key.startswith("bmha"):
            pairs = [(i, j) for i in range(len(runs)) for j in range(i + 1, len(runs))]
            within = all(np.array_equal(arrays[i], arrays[j]) for i, j in pairs if runs[i][0] == runs[j][0])
            if key.endswith(".0"):
                bound = ATTN_TOL[0] + ATTN_TOL[1] * np.abs(arrays[0])
                across = max((float((np.abs(arrays[i] - arrays[j]) / bound).max())
                              for i, j in pairs if runs[i][0] != runs[j][0]), default=0.0)
                limit, unit = ATTN_ACROSS, "of the bound"
            else:
                across = max((float((np.abs(arrays[i] - arrays[j]) / np.maximum(np.abs(arrays[0]), 1.0)).max())
                              for i, j in pairs if runs[i][0] != runs[j][0]), default=0.0)
                limit, unit = LSE_REL, "relative"
            print(f"output {key}: bit-equal between runs of one checkout: {within}; across checkouts apart by "
                  f"{across:.3e} {unit} at most (held to {limit})", flush=True)
            ok &= within and across <= limit
        elif key.startswith("attnbmha_bwd"):
            pairs = [(i, j) for i in range(len(runs)) for j in range(i + 1, len(runs))]
            within = all(np.array_equal(arrays[i], arrays[j]) for i, j in pairs if runs[i][0] == runs[j][0])
            across = max((bwd_used(arrays[j], arrays[i]) for i, j in pairs if runs[i][0] != runs[j][0]), default=0.0)
            print(f"output {key} (backward {'dq dk dv'.split()[int(key[-1])]}): bit-equal between runs of one "
                  f"checkout: {within}; across checkouts apart by {across:.3f} of BLOCKWISE_BWD_TOL at most "
                  "(held to 1)", flush=True)
            ok &= within and across <= 1.0
        elif key.startswith("bwd_merged") and key.endswith(".sum"):
            pairs = [(i, j) for i in range(len(runs)) for j in range(i + 1, len(runs))]
            within = all(np.array_equal(arrays[i], arrays[j]) for i, j in pairs if runs[i][0] == runs[j][0])
            across = all(np.array_equal(arrays[i], arrays[j]) for i, j in pairs if runs[i][0] != runs[j][0])
            print(f"output {key} (dW's bits, summed on the card): equal between runs of one checkout: {within}; "
                  f"across checkouts: {across}{' (not held: redesigned)' if merged_redesigned else ''}", flush=True)
            ok &= within and (across or merged_redesigned)
        elif key.startswith("bwd_merged"):
            # dx (.0): within a checkout to its repeat bound (atomic adds);
            # dW (.1) and db (.2): bit-equal within a checkout; across
            # checkouts held the same way, or all three within GRAD_REL of
            # the largest where the merged kernels were redesigned
            gap = lambda i, j: float(np.abs(arrays[i].astype(np.float64) - arrays[j]).max())  # noqa: E731
            pairs = [(i, j) for i in range(len(runs)) for j in range(i + 1, len(runs))]
            within = max((gap(i, j) for i, j in pairs if runs[i][0] == runs[j][0]), default=0.0)
            across = max((gap(i, j) for i, j in pairs if runs[i][0] != runs[j][0]), default=0.0)
            scale = float(np.abs(arrays[0]).max())
            repeat = DX_REPEAT * scale if key.endswith(".0") else 0.0
            limit = GRAD_REL * scale if merged_redesigned else repeat
            print(f"output {key}: largest gap between runs of one checkout {within:.3e} (held to {repeat:.3e}"
                  f"{': atomic adds' if key.endswith('.0') else ': bit-equal'}), across checkouts {across:.3e} "
                  f"({across / max(scale, 1e-30):.2e} of the largest |value|, held to {limit:.3e})", flush=True)
            ok &= within <= repeat and across <= limit
        else:
            same = [bool(np.array_equal(arrays[0], a)) for a in arrays[1:]]
            print(f"output {key} {arrays[0].shape}: bit-equal to run 1 in runs 2-{len(runs)}: {same}", flush=True)
            ok &= all(same)
    return ok


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--checkouts", help="comma-separated checkout roots")
    p.add_argument("--order", default="0,1,1,0", help="indices into --checkouts, run in this order")
    p.add_argument("--time", help="(internal) time the checkout at this root and print JSON")
    p.add_argument("--out", help="(internal) the directory the --time run writes its outputs to")
    p.add_argument("--pair", action="store_true",
                   help="time the two-pass CE backward and the wide train step only, and hold the pair's outputs")
    p.add_argument("--pair-redesigned", action="store_true",
                   help="the checkouts' pairs sum in other orders: hold their outputs across checkouts to 1e-4 "
                        "(bf16 x: 2e-2) of the largest instead of bit-equal")
    p.add_argument("--parts", action="store_true",
                   help="with --pair: time copies of the last checkout's two-pass kernel with one part removed")
    p.add_argument("--merged-redesigned", action="store_true",
                   help="the checkouts' merged backwards sum in other orders: hold their outputs across "
                        "checkouts to GRAD_REL of the largest instead of bit-equal (dx: DX_REPEAT)")
    args = p.parse_args(argv)
    if args.time:
        timed = _time_pair(args.time, args.out) if args.pair else _time_in(args.time, args.out)
        print(json.dumps(timed), flush=True)
        return
    if args.parts and not args.pair:
        raise SystemExit("--parts times the two-pass kernel: give --pair too")
    roots = args.checkouts.split(",")
    runs, dirs = [], []
    scratch = tempfile.mkdtemp(prefix="ce_turns_")
    try:
        for i in (int(j) for j in args.order.split(",")):
            dirs.append(os.path.join(scratch, str(len(dirs))))
            os.makedirs(dirs[-1])
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "--time", roots[i], "--out", dirs[-1],
                                  *(["--pair"] if args.pair else [])], capture_output=True, text=True, timeout=900)
            if res.returncode != 0:
                raise SystemExit(f"checkout {roots[i]} failed:\n{res.stderr[-3000:]}")
            runs.append((i, json.loads(res.stdout.strip().splitlines()[-1])))
            _print_run(len(runs), i, roots[i], runs[-1][1], PAIR_TIMED if args.pair else TIMED)
        if args.pair:
            same = _compare_pair(dirs, runs, args.pair_redesigned)
        else:
            same = _compare_outputs(dirs, runs, args.merged_redesigned)
        for n, (i, row) in enumerate([] if args.pair else runs, 1):
            for name in ATTN:
                fine = row[f"{name}_used"] <= 1.0 and row[f"{name}_lse"] <= LSE_REL
                print(f"run {n} checkout {i}: {name} against its plain version: {row[f'{name}_used']:.3f} of the "
                      f"bound, lse {row[f'{name}_lse']:.2e} relative", flush=True)
                same &= fine
            for name in BWD:
                used = [row[f"attn{name}.{j}_used"] for j in range(3)]
                print(f"run {n} checkout {i}: {name} dq / dk / dv against their plain versions: "
                      + " / ".join(f"{u:.3f}" for u in used) + " of BLOCKWISE_BWD_TOL", flush=True)
                same &= max(used) <= 1.0
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    for name in PAIR_TIMED if args.pair else TIMED:
        per = {i: [row[name] for j, row in runs if j == i] for i in range(len(roots))}
        spread = {i: (max(v) - min(v)) / min(v) for i, v in per.items() if len(v) > 1}
        means = {i: statistics.mean(v) for i, v in per.items()}
        unit = "us" if name.endswith("_us") else "ms"
        print(f"{name}: " + ", ".join(f"checkout {i} {means[i]:.4f} {unit} (spread {spread.get(i, 0):.2%})"
                                      for i in means)
              + "".join(f"; checkout {i} / checkout 0 = {means[i] / means[0]:.4f}" for i in means if i), flush=True)
    if args.parts:
        res = subprocess.run([sys.executable, "-c", f"import sys; sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r}); "
                              f"import ce_kernel_turns as t; t._parts({roots[-1]!r})"], text=True, timeout=900)
        if res.returncode != 0:
            raise SystemExit("the parts run failed")
    print(json.dumps({"runs": runs, "outputs_equal": same}), flush=True)
    if not same:
        raise SystemExit("the checkouts' outputs differ, or a forward misses its plain version's bound")


def _print_run(n: int, i: int, root: str, row: dict, timed: list) -> None:
    print(f"run {n} checkout {i} ({root}): " + ", ".join(f"{name} {row[name]:.4f}" for name in timed)
          + f" ms; build {row['build_seconds']} s", flush=True)
    for line in row["ptxas"]:
        print(f"  ptxas checkout {i}: {line}", flush=True)


if __name__ == "__main__":
    main()
