"""Each metric's arithmetic, on hand-built windows and traces."""

from __future__ import annotations

import pytest

from conftest import ROOT
from portbench.harness import manifest, work
from portbench.harness import trace as trace_lib
from portbench.runners.train import Context, Window

CFG = {"num_layers": 2, "d_model": 128, "num_heads": 4, "ffn_dim": 512, "n_items": 1000, "dtype": "bfloat16",
       "table_rows": 1024, "qkv_fused": False, "optimizer": {"mu_dtype": "float32"}}
STATS = {"labelled": 40, "tokens": 300, "tokens_sq": 9000, "batch": 8, "length": 53}


def read(name, ctx):
    return manifest.metric_reader(name, ROOT)(ctx)


def ctx_of(trace=None, steps=10, seconds=2.0, wait=0.5, host=1.0):
    cell = manifest.Cell("x", 1, CFG, {}, {}, [], [])
    window = Window(0.0, seconds, steps, 8, wait, host, [STATS] * steps, 1.0)
    return Context(cell, 12.5, window, trace, trace)


def test_window_metrics():
    ctx = ctx_of()
    assert read("train_examples_per_s", ctx) == pytest.approx(10 * 8 / 2.0)
    assert read("setup_s", ctx) == 12.5
    assert read("input_wait_ms", ctx) == pytest.approx(50.0)
    assert read("host_ms_per_step", ctx) == pytest.approx(100.0)


def test_step_mfu_counts_no_recompute():
    # per step: encoder 2 layers x (2 x 300 x (4 x 128^2 + 2 x 128 x 512) + 4 x 9000 x 128),
    # head 2 x 40 x 1000 x 128; forward and backward = 3x
    encoder = 2 * (2 * 300 * (4 * 128**2 + 2 * 128 * 512) + 4 * 9000 * 128)
    head = 2 * 40 * 1000 * 128
    per_step = 3 * (encoder + head)
    assert work.model_flops(CFG, STATS) == per_step
    assert read("step_mfu", ctx_of()) == pytest.approx(100 * 10 * per_step / (2.0 * work.PEAK_FLOPS))


def op(name, start, dur, *frames):
    return trace_lib.DeviceOp(name, start, dur, tuple(frames))


CE_FWD = "bert4clickpath_torch/ops/kernels/fused_ce.py(261): ce_stats"
CE_BWD = "bert4clickpath_torch/ops/kernels/fused_ce.py(489): ce_backward"
ADAM = "bert4clickpath_torch/training/train_state.py(322): apply_gradients"


def hand_trace(with_frames=True):
    f = (lambda *x: x) if with_frames else (lambda *x: ())
    ops = [
        op("void ce_fwd_wgmma_kernel<1>(...)", 0.000, 0.010, *f(CE_FWD)),
        op("void ce_bwd_merged_wgmma_kernel<128>(...)", 0.020, 0.030, *f(CE_BWD)),
        op("ce_pack_rows_kernel", 0.050, 0.001, *f(CE_BWD)),
        op("void at::native::vectorized_elementwise_kernel<...>", 0.060, 0.010, *f(ADAM)),
        op("mha_fwd_kernel", 0.080, 0.005, *f("bert4clickpath_torch/ops/kernels/attention.py(156): _launch_fwd")),
        op("mha_bwd_kernel", 0.090, 0.005, *f("bert4clickpath_torch/ops/kernels/attention.py(194): _launch_bwd")),
    ]
    spans = [("portbench.feed", 0.0, 0.015), ("portbench.dispatch", 0.015, 0.095), ("portbench.sync", 0.095, 0.1)]
    t = trace_lib.Trace(ops, (0.0, 0.1), 1, spans)
    t.batch_stats = [STATS]
    return t


def test_idle_share_of_a_known_timeline():
    t = hand_trace()
    busy = 0.010 + 0.030 + 0.001 + 0.010 + 0.005 + 0.005
    assert t.busy_s() == pytest.approx(busy)
    # busy per profiled step over the untraced window's wall time per step (2 s / 10 steps)
    assert read("device_idle_share", ctx_of(t)) == pytest.approx(100 * (1 - busy / 0.2))
    assert read("device_idle_share", ctx_of(t, steps=20, seconds=1.22)) == pytest.approx(0.0, abs=1e-9)
    assert read("kernels_per_step", ctx_of(t)) == 6


def test_overlapping_operations_count_once():
    t = trace_lib.Trace([op("a", 0.0, 0.5), op("b", 0.25, 0.5), op("c", 0.9, 0.5)], (0.0, 1.0), 1)
    assert t.busy_s() == pytest.approx(0.75 + 0.1)


@pytest.mark.parametrize("frames", [True, False], ids=["by-frame", "by-kernel-name"])
def test_ce_rooflines(frames):
    t = hand_trace(frames)
    fwd = work.bound_s(*work.ce_forward(40, 1000, 128, work.F32))
    bwd = work.bound_s(*work.ce_backward(40, 1000, 128, work.F32))
    assert read("ce_fwd_roofline", ctx_of(t)) == pytest.approx(100 * fwd / 0.010)
    assert read("ce_bwd_roofline", ctx_of(t)) == pytest.approx(100 * bwd / 0.031)


def test_attention_and_optimizer_rooflines():
    t = hand_trace()
    a = sum(work.bound_s(*f(8, 53, 128, 2)) for f in (work.attention_forward, work.attention_backward))
    assert read("attention_roofline", ctx_of(t)) == pytest.approx(100 * 2 * a / 0.010)
    from portbench.reference.model import param_specs
    import math

    numel = sum(math.prod(s) for _, s, _ in param_specs(CFG))
    assert read("optimizer_roofline", ctx_of(t)) == pytest.approx(
        100 * work.adam_bytes(numel, 4) / work.PEAK_BYTES / 0.010)


def test_optimizer_needs_frames_and_readers_without_trace_are_silent():
    assert read("optimizer_roofline", ctx_of(hand_trace(False))) is None
    for name in ("ce_fwd_roofline", "ce_bwd_roofline", "attention_roofline", "device_idle_share",
                 "kernels_per_step", "optimizer_roofline"):
        assert read(name, ctx_of(None)) is None


def test_a_roofline_share_stays_at_or_under_100_at_the_bound():
    # a kernel that takes exactly its bound reads 100%; any real one reads less
    fwd = work.bound_s(*work.ce_forward(40, 1000, 128, work.F32))
    t = trace_lib.Trace([op("ce_fwd_x", 0.0, fwd, CE_FWD)], (0.0, 1.0), 1)
    t.batch_stats = [STATS]
    assert read("ce_fwd_roofline", ctx_of(t)) == pytest.approx(100.0)


def test_bounds_take_the_larger_of_operations_and_bytes():
    assert work.bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert work.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    flops, nbytes = work.ce_backward(2100, 10_000_000, 128, work.F32)
    assert flops == 6 * 2100 * 10_000_000 * 128
    assert nbytes > 2 * 10_000_000 * 128 * 4  # the table read and dW written


def test_trace_parse_attributes_launches_to_the_frames_around_them():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.profiled", "ts": 0, "dur": 1000, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.dispatch", "ts": 10, "dur": 900, "tid": 1},
        {"ph": "X", "cat": "python_function", "name": CE_FWD, "ts": 20, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 50, "dur": 5, "tid": 1,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 500, "dur": 5, "tid": 2,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "ce_fwd_k", "ts": 60, "dur": 30, "tid": 7, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 510, "dur": 30, "tid": 7, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 2000, "dur": 30, "tid": 7, "args": {"correlation": 9}},
    ]
    t = trace_lib.parse(events, 1)
    assert [o.name for o in t.ops] == ["ce_fwd_k", "other"]
    assert t.ops[0].stack == ("portbench.profiled", "portbench.dispatch", CE_FWD)
    assert t.ops[1].stack == ()
    assert t.window_s == pytest.approx(1e-3)
    gaps = trace_lib.breakdown(t)["idle_gaps"]
    assert [g[0] for g in gaps] == ["dispatch", "dispatch", "dispatch"]
    assert [g[1] for g in gaps] == pytest.approx([460e-6, 420e-6, 60e-6])
