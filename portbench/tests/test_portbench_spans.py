"""The readers of the program's spans and counters (``harness/spans.py``,
``embed_device_ms``, ``encoder_device_ms``, ``feed_batch_ms``,
``feed_copy_ms``) on hand-built traces and counter snapshots."""

from __future__ import annotations

import pytest

from conftest import ROOT
from portbench.harness import manifest, spans
from portbench.harness import trace as trace_lib
from portbench.runners.train import Context, Window

CFG = {"num_layers": 2, "d_model": 128, "num_heads": 4, "ffn_dim": 512, "n_items": 1000, "dtype": "bfloat16",
       "table_rows": 1024, "qkv_fused": False, "optimizer": {"mu_dtype": "float32"}}
OUTER = ("portbench.profiled", "portbench.dispatch")


def read(name, ctx):
    return manifest.metric_reader(name, ROOT)(ctx)


def ctx_of(trace=None, steps=10):
    cell = manifest.Cell("x", 1, CFG, {}, {}, [], [])
    return Context(cell, 12.5, Window(0.0, 2.0, steps, 8, 0.5, 1.0, [], 1.0), trace, trace)


def op(name, start, dur, *stack):
    return trace_lib.DeviceOp(name, start, dur, tuple(stack))


def spanned_trace(steps=2):
    """Two steps' worth of operations: the attention kernels inside the
    encoder's range, a backward launched on the engine's thread (no
    ``b4cp.step`` there), one operation under the step alone, one under no
    program span."""
    ops = [
        op("gather_scale_pos", 0.000, 0.002, *OUTER, "b4cp.step", "b4cp.embed"),
        op("layer_norm", 0.002, 0.003, *OUTER, "b4cp.step", "b4cp.encoder", "aten::layer_norm"),
        op("mha_fwd_mma_kernel", 0.005, 0.001, *OUTER, "b4cp.step", "b4cp.encoder", "b4cp.attention"),
        op("mha_bwd_mma_kernel", 0.010, 0.002,
           "autograd::engine::evaluate_function: _MHABackward", "b4cp.encoder", "b4cp.attention"),
        op("layer_norm_grad", 0.012, 0.004, "b4cp.encoder", "autograd::engine::evaluate_function: X"),
        op("indexFuncLargeIndex", 0.020, 0.006, "b4cp.embed", "aten::index_add_"),
        op("div", 0.030, 0.001, *OUTER, "b4cp.step", "aten::div"),
        op("Memcpy HtoD", 0.040, 0.001, "portbench.feed"),
    ]
    t = trace_lib.Trace(ops, (0.0, 0.05), steps)
    return t


def test_innermost_span_owns_an_operation():
    t = spanned_trace()
    assert [spans.innermost(o) for o in t.ops] == [
        "b4cp.embed", "b4cp.encoder", "b4cp.attention", "b4cp.attention", "b4cp.encoder", "b4cp.embed",
        "b4cp.step", None]
    assert spans.device_ms_per_step(t, "b4cp.attention") == pytest.approx(1e3 * 0.003 / 2)


@pytest.mark.parametrize("steps", [1, 2, 4])
def test_device_ms_per_profiled_step(steps):
    t = spanned_trace(steps)
    # the attention kernels count to b4cp.attention, not to the encoder around them
    assert read("encoder_device_ms", ctx_of(t)) == pytest.approx(1e3 * (0.003 + 0.004) / steps)
    assert read("embed_device_ms", ctx_of(t)) == pytest.approx(1e3 * (0.002 + 0.006) / steps)


def test_improperly_nested_ranges_from_the_chrome_trace():
    """A block's backward range opens inside one engine range and closes
    inside another (on the engine's thread): the launches between belong to
    the block, those after it closed do not."""
    def x(cat, name, ts, dur, tid, **args):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
        if args:
            e["args"] = args
        return e

    engine = "autograd::engine::evaluate_function: "
    events = [
        x("user_annotation", "portbench.profiled", 0, 1000, 1),
        x("user_annotation", "b4cp.step", 10, 900, 1),
        # the engine's thread: the output marker's range opens b4cp.encoder ...
        x("cpu_op", engine + "_OutputMarkBackward", 100, 20, 2),
        x("user_annotation", "b4cp.encoder", 110, 300, 2),
        x("cpu_op", engine + "NativeLayerNormBackward0", 150, 50, 2),
        x("cuda_runtime", "cudaLaunchKernel", 160, 5, 2, correlation=1),
        # ... and the input marker's closes it, inside another engine range
        x("cpu_op", engine + "_InputMarkBackward", 400, 40, 2),
        x("cuda_runtime", "cudaLaunchKernel", 405, 5, 2, correlation=2),
        x("cuda_runtime", "cudaLaunchKernel", 430, 5, 2, correlation=3),
        x("user_annotation", "b4cp.embed", 500, 100, 2),
        x("cuda_runtime", "cudaLaunchKernel", 550, 5, 2, correlation=4),
        x("kernel", "layer_norm_grad", 170, 30, 9, correlation=1),
        x("kernel", "in_block", 420, 5, 9, correlation=2),
        x("kernel", "after_block", 440, 5, 9, correlation=3),
        x("kernel", "index_add", 560, 20, 9, correlation=4),
    ]
    t = trace_lib.parse(events, 1)
    assert [spans.innermost(o) for o in t.ops] == ["b4cp.encoder", "b4cp.encoder", None, "b4cp.embed"]
    assert read("encoder_device_ms", ctx_of(t)) == pytest.approx(1e3 * 35e-6)
    assert read("embed_device_ms", ctx_of(t)) == pytest.approx(1e3 * 20e-6)


def test_a_trace_without_program_spans_reads_none():
    """The parent's program names no span: None, never 0."""
    t = trace_lib.Trace([op("k", 0.0, 0.01, *OUTER, "aten::mm"), op("m", 0.02, 0.01)], (0.0, 0.05), 1)
    for name in ("embed_device_ms", "encoder_device_ms"):
        assert read(name, ctx_of(t)) is None
        assert read(name, ctx_of(None)) is None
        assert read(name, ctx_of(trace_lib.Trace([], (0.0, 0.05), 1))) is None
    # spans present, none of the encoder: a real 0
    only_embed = trace_lib.Trace([op("g", 0.0, 0.01, "b4cp.embed")], (0.0, 0.05), 1)
    assert read("encoder_device_ms", ctx_of(only_embed)) == 0.0


@pytest.mark.parametrize("steps", [1, 5, 20])
def test_feed_counters_over_the_window_steps(monkeypatch, steps):
    snapshot = {"b4cp.feed.batch": (steps, 0.040), "b4cp.feed.copy": (steps, 0.300),
                "kernels.gather": (steps, 0.0)}
    monkeypatch.setattr(spans, "counters", lambda: snapshot)
    assert read("feed_batch_ms", ctx_of(steps=steps)) == pytest.approx(40.0 / steps)
    assert read("feed_copy_ms", ctx_of(steps=steps)) == pytest.approx(300.0 / steps)


@pytest.mark.parametrize("snapshot", [None, {}, {"kernels.gather": (3, 0.0)}], ids=["no-registry", "empty", "kernels"])
def test_feed_counters_without_the_span_read_none(monkeypatch, snapshot):
    monkeypatch.setattr(spans, "counters", lambda: snapshot)
    assert read("feed_batch_ms", ctx_of()) is None
    assert read("feed_copy_ms", ctx_of()) is None


def test_counters_come_from_the_program_registry():
    from bert4clickpath_torch.utils import profiling

    profiling.reset()
    profiling.add("b4cp.feed.copy", 0.25, calls=5)
    assert spans.counters() == {"b4cp.feed.copy": (5, 0.25)}
    assert read("feed_copy_ms", ctx_of(steps=5)) == pytest.approx(50.0)
    profiling.reset()
