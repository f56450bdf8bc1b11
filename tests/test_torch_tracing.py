"""The port's spans and counter registry (``utils/profiling.py``), on the CPU.

Both train steps (``make_train_step`` with the fused CE, and
``make_spmd_train_step`` on a mesh of one), post-LN and pre-LN, with remat
off and on, from the same weights, batch and dropout seed, once off the
profiler and once under it:

* the loss and every gradient are bit-equal (f32);
* every span of the program appears in the exported trace, each block's
  backward in a range of its name: every encoder layer's backward
  (``autograd::engine::evaluate_function`` ranges; the remat recompute
  too) inside a ``b4cp.encoder`` range, the lookup's inside ``b4cp.embed``;
* every range a block's backward opens is closed, also where a backward
  skips a block's input (a gradient of some parameters only) or runs again
  over a kept graph;
* off the profiler no ``record_function`` is entered and no marker put in,
  and the counters advance; under it they do not.

Also: ``reset_launch_counts`` empties the registry but for the copy
counters, and ``launch_counts`` keeps its keys; ``span`` as a decorator; ``block`` off the profiler; no
count lost across threads.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from bert4clickpath_torch.config import FeatureConfig, HeadConfig, MeshConfig, ModelConfig
from bert4clickpath_torch.data.pipeline import ClozeDataset, to_device
from bert4clickpath_torch.models.model import ClickstreamModel, init_state_dict
from bert4clickpath_torch.ops.fused_ce import padded_rows
from bert4clickpath_torch.ops.kernels import _build
from bert4clickpath_torch.parallel import spmd
from bert4clickpath_torch.parallel.mesh import Mesh
from bert4clickpath_torch.training import schedules
from bert4clickpath_torch.training import train_state as tts
from bert4clickpath_torch.utils import profiling
from bert4clickpath_torch.vocab import Vocabulary

torch.set_num_threads(1)

N_ITEMS, D, LAYERS, B, MAX_ITEMS, P = 150, 16, 2, 8, 12, 4
SPANS = ("b4cp.feed.batch", "b4cp.feed.copy", "b4cp.step", "b4cp.embed", "b4cp.encoder", "b4cp.attention",
         "b4cp.head", "b4cp.ce_fwd", "b4cp.ce_bwd", "b4cp.optimizer")
VARIANTS = [(step, norm, remat) for step in ("single", "spmd") for norm in ("post", "pre") for remat in (False, True)]
IDS = [f"{s}-{n}LN-remat{int(r)}" for s, n, r in VARIANTS]


def _config(norm: str) -> ModelConfig:
    vocab = Vocabulary([f"item_{i}" for i in range(N_ITEMS)])
    return ModelConfig(
        features={"items": FeatureConfig(padded_rows(vocab.model_vocab_size), D)}, num_layers=LAYERS,
        num_heads=2, ffn_dim=32, dropout_rate=0.1, max_len=MAX_ITEMS + 3,
        head=HeadConfig("tied_softmax", output_size=N_ITEMS), max_masked=P, dtype="float32", norm_style=norm,
    )


def _dataset() -> ClozeDataset:
    rng = np.random.default_rng(0)
    sessions = [rng.integers(0, N_ITEMS, size=rng.integers(3, MAX_ITEMS)).astype(np.int32) for _ in range(64)]
    vocab = Vocabulary([f"item_{i}" for i in range(N_ITEMS)])
    return ClozeDataset(sessions, vocab, max_items=MAX_ITEMS, max_masked=P, backend="numpy")


def _build_step(kind: str, norm: str, remat: bool):
    """(step, state) of a fresh model from seeded weights."""
    cfg = _config(norm)
    tx = tts.Adam(0.9, 0.999, 1e-9)
    weights = init_state_dict(cfg, 0)
    if kind == "single":
        model = ClickstreamModel(cfg, device="cpu", remat=remat)
        model.load_state_dict(weights)
        state = tts.TrainState.create(dict(model.named_parameters()), tx)
        return tts.make_train_step(model, tx, schedules.constant(1e-3), fused_ce_num_valid=N_ITEMS), state
    mesh = Mesh(MeshConfig(data=1, model=1), 0, 0, 0, None, None, torch.device("cpu"))
    model, state = spmd.init_sharded_state(cfg, mesh, tx, weights={k: v.numpy() for k, v in weights.items()})
    model.encoder.remat = remat
    return spmd.make_spmd_train_step(model, mesh, tx, schedules.constant(1e-3), N_ITEMS), state


def _one_step(kind: str, norm: str, remat: bool, monkeypatch) -> tuple:
    """(loss, gradients) of one step, the batch made and moved inside it."""
    step, state = _build_step(kind, norm, remat)
    grads = {}
    apply = tts.apply_gradients

    def keep(state, g, *args, **kwargs):
        grads.update({k: v.detach().clone() for k, v in g.items()})
        return apply(state, g, *args, **kwargs)

    monkeypatch.setattr(tts, "apply_gradients", keep)
    monkeypatch.setattr(spmd, "apply_gradients", keep)
    batch = to_device(next(_dataset().train_batches(B, seed=0)), "cpu")
    _, loss = step(state, batch, torch.Generator().manual_seed(7))
    return loss, grads


@functools.lru_cache(maxsize=None)
def _runs(kind: str, norm: str, remat: bool, tmp: str) -> dict:
    """The step off the profiler and under it (the Chrome trace's events,
    the counters each left, the ranges the blocks opened and closed)."""
    monkeypatch = pytest.MonkeyPatch()
    out = {"opened": 0, "closed": 0}
    real_open, real_close = profiling._open_range, profiling._close_range

    def opened(name):
        out["opened"] += 1
        return real_open(name)

    def closed(handle):
        out["closed"] += 1
        real_close(handle)

    try:
        profiling.reset()
        out["off"] = _one_step(kind, norm, remat, monkeypatch)
        out["counters_off"] = profiling.counters()
        profiling.reset()
        monkeypatch.setattr(profiling, "_open_range", opened)
        monkeypatch.setattr(profiling, "_close_range", closed)
        logdir = os.path.join(tmp, f"{kind}-{norm}-{int(remat)}")
        with profiling.trace(logdir):
            out["on"] = _one_step(kind, norm, remat, monkeypatch)
        out["counters_on"] = profiling.counters()
        (name,) = os.listdir(logdir)
        with open(os.path.join(logdir, name)) as f:
            out["events"] = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    finally:
        monkeypatch.undo()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("traces"))
    return lambda variant: _runs(*variant, tmp)


def _ranges(events, name):
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("tid")) for e in events
            if e["name"] == name]


def _inside(event_range, ranges) -> bool:
    a, b, tid = event_range
    return any(s <= a and b <= e and t == tid for s, e, t in ranges)


def _engine(events, node):
    return _ranges(events, f"autograd::engine::evaluate_function: {node}")


@pytest.mark.parametrize("variant", VARIANTS, ids=IDS)
def test_profiled_step_is_bit_equal(variant, runs):
    """The loss and every gradient, under the profiler and off it."""
    r = runs(variant)
    (loss_off, grads_off), (loss_on, grads_on) = r["off"], r["on"]
    assert torch.isfinite(loss_off) and torch.equal(loss_off, loss_on)
    assert set(grads_off) == set(grads_on) and len(grads_off) > 10
    for k in grads_off:
        assert torch.equal(grads_off[k], grads_on[k]), k


@pytest.mark.parametrize("variant", VARIANTS, ids=IDS)
def test_every_span_is_in_the_trace(variant, runs):
    """Each span of the program is a user range of the exported trace, as
    often as the step runs it: a block once forward and once backward."""
    kind, norm, remat = variant
    events = runs(variant)["events"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert {n for n in names if n.startswith("b4cp.")} == set(SPANS)
    encoder_blocks = 1 + LAYERS + (norm == "pre")  # the input dropout, the layers, pre-LN's final LN
    want = {"b4cp.feed.batch": 1, "b4cp.feed.copy": 1, "b4cp.step": 1, "b4cp.embed": 2, "b4cp.head": 2,
            "b4cp.encoder": 2 * encoder_blocks, "b4cp.attention": LAYERS * (3 if remat else 2),
            "b4cp.ce_fwd": 1, "b4cp.ce_bwd": 1, "b4cp.optimizer": 1}
    assert {n: names.count(n) for n in SPANS} == want


@pytest.mark.parametrize("variant", VARIANTS, ids=IDS)
def test_each_block_backward_lies_in_its_range(variant, runs):
    """Every encoder layer's backward (its LayerNorms' and attention's
    engine ranges, the remat recompute's attention too) inside a
    ``b4cp.encoder`` range; the lookup's backward inside ``b4cp.embed``;
    the CE backward inside no block, its kernels' span inside it."""
    kind, norm, remat = variant
    events = runs(variant)["events"]
    encoder = _ranges(events, "b4cp.encoder")
    norms = _engine(events, "NativeLayerNormBackward0")
    assert len(norms) == 2 * LAYERS + (norm == "pre")
    attention_bwd = _engine(events, "_MHABackward")
    assert len(attention_bwd) == LAYERS
    for r in norms + attention_bwd + _ranges(events, "b4cp.attention"):
        assert _inside(r, encoder), r
    # the embedding's range closes in a hook after the lookup's node, inside
    # the engine's range around it: the node's own range lies inside
    lookup = _ranges(events, "_GatherScalePosBackward" if kind == "single" else "_ShardedLookupBackward")
    assert len(lookup) == 1 and _inside(lookup[0], _ranges(events, "b4cp.embed"))
    (ce,) = _engine(events, "_FusedCEBackward" if kind == "single" else "_ShardedFusedCEBackward")
    blocks = [r for n in ("b4cp.embed", "b4cp.encoder", "b4cp.head") for r in _ranges(events, n)]
    assert not _inside(ce, blocks) and _inside(_ranges(events, "b4cp.ce_bwd")[0], [ce])


@pytest.mark.parametrize("variant", VARIANTS, ids=IDS)
def test_every_range_opened_is_closed(variant, runs):
    """The blocks' backward ranges: one opened and one closed a block."""
    r = runs(variant)
    blocks = 1 + 1 + LAYERS + (variant[1] == "pre") + 1  # embed, the encoder blocks, head
    assert r["opened"] == r["closed"] == blocks


@pytest.mark.parametrize("variant", VARIANTS, ids=IDS)
def test_counters_advance_off_the_profiler_only(variant, runs):
    """Off the profiler each span adds its calls and seconds (the attention
    launchers' a remat recompute too); under it the registry is left as it
    was."""
    kind, norm, remat = variant
    r = runs(variant)
    calls = {k: c for k, (c, s) in r["counters_off"].items() if k.startswith("b4cp.")}
    assert calls == {"b4cp.feed.batch": 1, "b4cp.feed.copy": 1, "b4cp.step": 1, "b4cp.embed": 1,
                     "b4cp.encoder": 1 + LAYERS + (norm == "pre"), "b4cp.attention": LAYERS * (3 if remat else 2),
                     "b4cp.head": 1,
                     "b4cp.ce_fwd": 1, "b4cp.ce_bwd": 1, "b4cp.optimizer": 1}
    seconds = {k: s for k, (c, s) in r["counters_off"].items() if k.startswith("b4cp.")}
    assert all(s > 0 for s in seconds.values())
    assert seconds["b4cp.step"] >= seconds["b4cp.optimizer"] + seconds["b4cp.embed"]
    assert not any(k.startswith("b4cp.") for k in r["counters_on"])


@pytest.mark.parametrize("kind", ["single", "spmd"])
def test_off_the_profiler_nothing_is_entered_or_marked(kind, monkeypatch):
    """No ``record_function``, no range and no marker off the profiler."""

    def refuse(*args, **kwargs):
        raise AssertionError("entered off the profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_open_range", refuse)
    monkeypatch.setattr(profiling._InputMark, "apply", refuse)
    monkeypatch.setattr(profiling._OutputMark, "apply", refuse)
    profiling.reset()
    loss, grads = _one_step(kind, "post", False, monkeypatch)
    assert torch.isfinite(loss) and grads
    assert profiling.counters()["b4cp.step"][0] == 1


def test_reset_empties_the_registry_and_launch_counts_keep_their_keys():
    profiling.reset()
    assert profiling.counters() == {}
    assert set(_build.launch_counts()) == set(_build.KERNELS) and not any(_build.launch_counts().values())
    assert _build.copy_counts() == {"blockwise_fwd": 0, "blockwise_bwd": 0}
    _build.count("gather")
    _build.count("gather")
    _build.count_copy("blockwise_bwd")
    profiling.add("b4cp.step", 0.5)
    assert _build.launch_counts()["gather"] == 2 and sum(_build.launch_counts().values()) == 2
    assert _build.copy_counts() == {"blockwise_fwd": 0, "blockwise_bwd": 1}
    assert profiling.counters() == {"kernels.gather": (2, 0.0), "copies.blockwise_bwd": (1, 0.0),
                                    "b4cp.step": (1, 0.5)}
    with pytest.raises(KeyError):
        _build.count("no_such_kernel")
    _build.reset_launch_counts()
    assert profiling.counters() == {"copies.blockwise_bwd": (1, 0.0)} and not any(_build.launch_counts().values())
    profiling.reset()
    assert profiling.counters() == {}


@pytest.mark.parametrize("resets", [1, 3])
def test_reset_launch_counts_keeps_the_copy_counters(resets):
    """A copy counted before ``reset_launch_counts`` is still counted after
    it, however often the counters are reset, and new copies add to it."""
    profiling.reset()
    _build.count_copy("blockwise_fwd")
    _build.count("blockwise_fwd")
    for _ in range(resets):
        _build.reset_launch_counts()
    assert _build.copy_counts() == {"blockwise_fwd": 1, "blockwise_bwd": 0}
    assert _build.launch_counts()["blockwise_fwd"] == 0
    _build.count_copy("blockwise_fwd")
    assert _build.copy_counts()["blockwise_fwd"] == 2
    profiling.reset()


def _counted_ranges(monkeypatch) -> dict:
    """Counts of the blocks' backward ranges opened and closed from now on."""
    out = {"opened": 0, "closed": 0}
    real_open, real_close = profiling._open_range, profiling._close_range

    def opened(name):
        out["opened"] += 1
        return real_open(name)

    def closed(handle):
        out["closed"] += 1
        real_close(handle)

    monkeypatch.setattr(profiling, "_open_range", opened)
    monkeypatch.setattr(profiling, "_close_range", closed)
    return out


@pytest.mark.parametrize("backwards", [1, 2], ids=["once", "twice-over-a-kept-graph"])
def test_a_range_closes_where_the_backward_skips_the_input(backwards, monkeypatch):
    """A gradient of the block's parameter alone never runs its input's
    marker: the range closes when the backward ends, each time it runs."""
    ranges = _counted_ranges(monkeypatch)
    x = torch.arange(3.0, requires_grad=True)
    w = torch.full((3,), 2.0, requires_grad=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.block("test.block") as blk:
            y = blk.output(blk.input(x) * w)
        for _ in range(backwards):
            (g,) = torch.autograd.grad(y.sum(), [w], retain_graph=True)
    assert ranges == {"opened": backwards, "closed": backwards}
    assert torch.equal(g, x.detach())
    assert sum(e.count for e in prof.key_averages() if e.key == "test.block") == 1 + backwards


@pytest.mark.parametrize("norm", ["post", "pre"])
def test_a_gradient_of_the_last_layer_alone_closes_every_range(norm, monkeypatch):
    """The model's encoder under the profiler, differentiated for the last
    layer's parameters only: the backward reaches no block's input below
    that layer's, and every range it opened is closed all the same; the
    gradients equal those off the profiler."""
    cfg = _config(norm)
    model = ClickstreamModel(cfg, device="cpu")
    model.load_state_dict(init_state_dict(cfg, 0))
    features = to_device(next(_dataset().train_batches(B, seed=0)), "cpu")["features"]
    last = list(getattr(model.encoder, f"layer_{LAYERS - 1}").parameters())

    def grads():
        h = model.encode(features, torch.Generator().manual_seed(7))
        return torch.autograd.grad(h.float().square().sum(), last)

    off = grads()
    ranges = _counted_ranges(monkeypatch)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = grads()
    assert ranges["opened"] == ranges["closed"] == 1 + (norm == "pre")  # the last layer, pre-LN's final LN
    assert all(torch.equal(a, b) for a, b in zip(off, on))


def test_span_as_decorator_and_context_manager():
    """A decorated function counts each call, recursion included, and a
    raising one still counts; a span under the profiler is a user range."""
    profiling.reset()

    @profiling.span("test.fact")
    def fact(n):
        return 1 if n <= 1 else n * fact(n - 1)

    assert fact(4) == 24
    with pytest.raises(ValueError):
        with profiling.span("test.raise"):
            raise ValueError("out")
    now = profiling.counters()
    assert now["test.fact"][0] == 4 and now["test.raise"][0] == 1
    assert now["test.fact"][1] >= 0.0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling.recording()
        with profiling.span("test.inside"):
            torch.ones(2) + 1
    assert not profiling.recording()
    assert "test.inside" not in profiling.counters()
    assert any(e.key == "test.inside" for e in prof.key_averages())


def test_block_leaves_tensors_alone_off_the_profiler_and_under_no_grad():
    x = torch.ones(3, requires_grad=True)
    with profiling.block("test.block") as blk:
        assert blk.input(x) is x and blk.output(x * 2).grad_fn is not None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad(), profiling.block("test.block") as blk:
            assert blk.input(x) is x
        with profiling.block("test.block") as blk:
            y = blk.input(x)
            assert y is not x and torch.equal(y, x)
            z = blk.output(y * 2)
            assert type(z.grad_fn).__name__ == "_OutputMarkBackward"
        (g,) = torch.autograd.grad(z.sum(), [x])
    assert torch.equal(g, torch.full((3,), 2.0))


def test_counters_lose_no_update_across_threads():
    """Spans count from the caller's and the autograd engine's threads: many
    threads adding at once, with a short switch interval, lose nothing."""
    profiling.reset()
    threads, per = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [profiling.add("test.shared", 0.5) for _ in range(per)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert profiling.counters()["test.shared"] == (threads * per, 0.5 * threads * per)
    profiling.reset()


# the forward's blocks of each span in a step of 1 dense + 2 MoE layers
DEEPSEEK_SPANS = {"b4cp.mla": 2 * 3, "b4cp.moe.route": 2 * 2, "b4cp.moe.experts": 2, "b4cp.moe.shared": 2}


def test_deepseek_block_spans_nest_in_the_encoder(tmp_path, monkeypatch):
    """A train step of the DeepSeek-V2 block under the profiler: the four
    new spans are user ranges, forward and backward, each forward range
    inside a ``b4cp.encoder`` range of its thread; the forward of each MoE
    layer calls the grouped products twice (the fused gate-up and the down
    product: two launches of ``kernels.grouped_gemm`` on the card, which
    ``test_torch_deepseek_v2_cuda.py`` counts there), the backward each
    one's input and weight gradient; the loss and every gradient
    bit-equal to the same step off the profiler."""
    from bert4clickpath_torch.config import DeepSeekV2Config
    from bert4clickpath_torch.ops.kernels import grouped_gemm as gg

    block = DeepSeekV2Config(kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8,
                             n_routed_experts=4, num_experts_per_tok=2, moe_intermediate_size=8)
    cfg = ModelConfig(features={"items": FeatureConfig(160, D)}, num_layers=3, num_heads=2, ffn_dim=32,
                      dropout_rate=0.0, max_len=MAX_ITEMS + 3, positional="rope", norm_style="pre",
                      head=HeadConfig("tied_softmax", output_size=N_ITEMS), max_masked=P, dtype="float32",
                      block=block)
    calls = []
    for name in ("grouped_mm", "grouped_mm_w", "grouped_mm_dw"):
        real = getattr(gg, name)
        monkeypatch.setattr(gg, name, lambda *a, real=real, name=name: calls.append(name) or real(*a))

    def step():
        model = ClickstreamModel(cfg, device="cpu")
        g = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for _, p in model.named_parameters():
                p.copy_(torch.ones_like(p) if p.dim() == 1 else torch.randn(p.shape, generator=g) / p.shape[-1] ** 0.5)
        batch = to_device(next(_dataset().train_batches(B, seed=0)), "cpu")
        loss = tts.make_loss_fn(model, fused_ce_num_valid=N_ITEMS)(batch)
        forward = len(calls)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return loss, grads, forward

    loss_off, grads_off, forward = step()
    assert calls[:forward] == ["grouped_mm"] * 2 * 2  # 2 MoE layers
    assert sorted(calls[forward:]) == ["grouped_mm_dw"] * 2 * 2 + ["grouped_mm_w"] * 2 * 2
    calls.clear()
    with profiling.trace(str(tmp_path)) as _:
        loss_on, grads_on, _ = step()
    assert torch.equal(loss_off, loss_on) and all(torch.equal(a, b) for a, b in zip(grads_off, grads_on))
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    encoder = _ranges(events, "b4cp.encoder")
    for span, blocks in DEEPSEEK_SPANS.items():
        ranges = _ranges(events, span)
        assert len(ranges) >= 2 * blocks, span  # forward and backward
        assert all(_inside(r, encoder) for r in ranges), span
