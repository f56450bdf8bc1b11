"""The DeepSeek-V2 block of the port (``models/deepseek_v2.py``) on the
CPU, against the plain float32 reference ``tests/plain_deepseek_v2.py``.

At a small size with seeded weights (d 64, 4 heads of q/k 24 + 8 and v 16,
KV latent 32, 8 experts of width 16 top-2 with 1 shared, 1 dense + 2 MoE
layers), in f32:

* the port's training loss (``make_loss_fn`` with the fused CE: the Cloze
  CE plus the balance losses) and every gradient against the plain
  reference: loss rel 1e-5, each gradient within 2e-5 of its largest
  element. Both sum the same f32 products in other orders (the grouped
  products per padded expert buffer against per-expert index lists, the
  fused CE's plain version in vocabulary blocks against dense logits, RoPE
  de-interleaved against complex products): f32 rounding, ~1e-7 relative
  per operation through three layers;
* the benchmark's copy (``portbench/reference/deepseek_v2.py``) against the
  plain reference on the same weights and batch: loss and gradients to the
  same tolerance, so that the two cannot drift apart;
* YaRN at the published widths: low 10, high 23, scale 0.114721;
* padding: no routed row and no balance-loss count comes from a padding
  position; changing the padding's embedding changes nothing at the real
  tokens;
* the grouped GEMM's plain version against a dense per-row product, with an
  expert without rows; the routing's sort is a permutation;
* a BERT4Rec configuration builds the same modules and parameters as
  before the block was added;
* the uneven attention (v narrower than q and k, the block's scale) in f32:
  its output and its three gradients (the plain versions of the card's
  kernels, backward by formula from the log-sum-exp) against autograd
  through a dense softmax, within 1e-5 of each one's largest element (f32
  sums in another order), bf16 inputs within 2e-2 (the roundings of p and
  ds); the RoPE model's lookup adds no position;
* ``mla_attention_roofline``'s count of the attention core's work against
  the products written out.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import plain_deepseek_v2 as plain  # noqa: E402

from bert4clickpath_torch.config import DeepSeekV2Config, FeatureConfig, HeadConfig, ModelConfig  # noqa: E402
from bert4clickpath_torch.models import deepseek_v2 as ds  # noqa: E402
from bert4clickpath_torch.models.encoder import EncoderLayer, LayerNorm  # noqa: E402
from bert4clickpath_torch.models.model import ClickstreamModel  # noqa: E402
from bert4clickpath_torch.ops.kernels import grouped_gemm as gg  # noqa: E402
from bert4clickpath_torch.training import train_state as tts  # noqa: E402
from portbench.reference import common as ref_common  # noqa: E402
from portbench.reference import deepseek_v2 as bench_ref  # noqa: E402

torch.set_num_threads(2)

N_ITEMS, D, HEADS, L = 50, 64, 4, 20
PUBLISHED_YARN = dict(factor=40, original_max_position_embeddings=4096, beta_fast=32, beta_slow=1, mscale=0.707,
                      mscale_all_dim=0.707, type="yarn")
CFG = dict(hidden_size=D, d_model=D, num_attention_heads=HEADS, kv_lora_rank=32, qk_nope_head_dim=24,
           qk_rope_head_dim=8, v_head_dim=16, intermediate_size=48, moe_intermediate_size=16, n_routed_experts=8,
           num_experts_per_tok=2, n_shared_experts=1, first_k_dense_replace=1, num_hidden_layers=3,
           rms_norm_eps=1e-6, rope_theta=10000.0, rope_scaling=PUBLISHED_YARN, aux_loss_alpha=0.001, n_items=N_ITEMS,
           table_rows=64)


def _block() -> DeepSeekV2Config:
    return DeepSeekV2Config(kv_lora_rank=32, qk_nope_head_dim=24, qk_rope_head_dim=8, v_head_dim=16,
                            first_k_dense_replace=1, n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
                            moe_intermediate_size=16)


def _model() -> ClickstreamModel:
    cfg = ModelConfig(features={"items": FeatureConfig(CFG["table_rows"], D)}, num_layers=3, num_heads=HEADS,
                      ffn_dim=48, dropout_rate=0.0, max_len=L, positional="rope",
                      head=HeadConfig("tied_softmax", output_size=N_ITEMS), max_masked=4, dtype="float32",
                      norm_style="pre", block=_block())
    model = ClickstreamModel(cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for _, p in model.named_parameters():
            p.copy_(1 + 0.1 * torch.randn(p.shape, generator=g) if p.dim() == 1
                    else torch.randn(p.shape, generator=g) / math.sqrt(p.shape[-1]))
    return model


def _batch():
    g = torch.Generator().manual_seed(2)
    tokens = torch.zeros(3, L, dtype=torch.int32)
    for i, n in enumerate((20, 11, 6)):
        tokens[i, :n] = torch.randint(10, 10 + N_ITEMS, (n,), generator=g)
    positions = torch.tensor([[1, 3, 5, 7], [2, 4, 0, 0], [1, 2, 0, 0]], dtype=torch.int32)
    labels = torch.tensor([[1, 2, 3, 4], [5, 6, -1, -1], [7, 8, -1, -1]], dtype=torch.int32)
    return tokens, positions, labels


def _port_loss_and_grads(model):
    tokens, positions, labels = _batch()
    batch = {"features": {"items": tokens}, "head_positions": positions, "labels": labels}
    loss = tts.make_loss_fn(model, fused_ce_num_valid=N_ITEMS)(batch)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return loss.detach(), dict(zip(names, grads))


def _leaves(model):
    return {n: p.detach().clone().requires_grad_(True) for n, p in model.named_parameters()}


def _assert_grads_close(got: dict, want: dict):
    assert set(got) == set(want)
    for name in want:
        err = (got[name] - want[name]).abs().max().item()
        assert err <= 2e-5 * want[name].abs().max().item() + 1e-9, (name, err)


def test_port_loss_and_every_gradient_match_the_plain_reference():
    model = _model()
    loss, grads = _port_loss_and_grads(model)
    params = _leaves(model)
    with plain.exact_float32():
        want, ce, aux = plain.loss(params, CFG, *_batch())
    assert float(aux.detach()) > 0
    torch.testing.assert_close(loss, want.detach(), rtol=1e-5, atol=0)
    port_aux = sum(m.aux for m in model.modules() if isinstance(m, ds.MoE))
    torch.testing.assert_close(port_aux.detach(), aux.detach(), rtol=1e-5, atol=0)
    ref_grads = dict(zip(params, torch.autograd.grad(want, list(params.values()))))
    _assert_grads_close(grads, ref_grads)


def test_benchmark_reference_matches_the_plain_reference():
    model = _model()
    params = _leaves(model)
    names = {n for n, _, _ in bench_ref.param_specs(CFG)}
    assert names == set(params)
    assert {n: tuple(s) for n, s, _ in bench_ref.param_specs(CFG)} == {n: tuple(p.shape) for n, p in params.items()}
    tokens, positions, labels = _batch()
    batch = {"tokens": tokens, "positions": positions, "labels": labels}
    cfg = dict(CFG, head="tied_softmax", q_lora_rank=None, hidden_act="silu", scoring_func="softmax",
               topk_method="greedy", norm_topk_prob=False, routed_scaling_factor=1, moe_layer_freq=1,
               attention_bias=False, seq_aux=True, dropout_rate=0.0)
    bench_ref.check_supported(cfg)
    got = bench_ref.loss_fn(params, cfg, batch, None, ref_common.Numerics("float32"), 16)
    got_grads = dict(zip(params, torch.autograd.grad(got, list(params.values()))))
    params2 = _leaves(model)
    want = plain.loss(params2, CFG, tokens, positions, labels)[0]
    torch.testing.assert_close(got.detach(), want.detach(), rtol=1e-5, atol=0)
    _assert_grads_close(got_grads, dict(zip(params2, torch.autograd.grad(want, list(params2.values())))))


def test_benchmark_reference_counts_the_step_flops():
    """model_flops at the cell's widths over ~15.1k real tokens: every part
    counted over the real tokens only (the padded slots' dense work is not
    model work), so the routed experts make ~45% of ~41 TFLOP a step."""
    cfg = dict(CFG, hidden_size=2048, num_attention_heads=16, kv_lora_rank=512, qk_nope_head_dim=128,
               qk_rope_head_dim=64, v_head_dim=128, intermediate_size=10944, moe_intermediate_size=1408,
               n_routed_experts=64, num_experts_per_tok=6, n_shared_experts=2, num_hidden_layers=5,
               n_items=102_389)
    stats = {"tokens": 15_100, "tokens_sq": 15_100 * 118, "labelled": 2_900}
    total = bench_ref.model_flops(cfg, stats)
    routed = 3 * 2.0 * 15_100 * 6 * 3 * 2048 * 1408 * 4
    assert 0.4 < routed / total < 0.5 and 38e12 < total < 45e12


def test_yarn_at_the_published_widths():
    cfg = DeepSeekV2Config()
    assert ds.yarn_correction_range(cfg) == (10, 23)
    assert ds.yarn_scale(cfg) == pytest.approx(0.114721, abs=5e-7)
    inv, scale = plain.yarn(dict(CFG, qk_nope_head_dim=128, qk_rope_head_dim=64))
    torch.testing.assert_close(ds.yarn_inv_freq(cfg), inv, rtol=1e-12, atol=0)
    assert scale == pytest.approx(ds.yarn_scale(cfg), rel=1e-12)
    assert bench_ref.yarn(dict(CFG, qk_nope_head_dim=128, qk_rope_head_dim=64))[1] == pytest.approx(scale, rel=1e-12)


def test_rope_layout_leaves_the_scores_of_the_interleaved_rotation():
    """The port's de-interleaved layout and the reference's interleaved
    complex products give the same q_pe . k_pe at every pair of slots."""
    cos, sin = ds.rope_tables(DeepSeekV2Config(), 12, "cpu")
    angles = torch.atan2(sin, cos)
    g = torch.Generator().manual_seed(3)
    q, k = torch.randn(2, 12, 3, 64, generator=g), torch.randn(2, 12, 64, generator=g)
    ours = torch.einsum("bqhd,bkd->bhqk", ds.rope(q, cos, sin), ds.rope(k, cos, sin))
    theirs = torch.einsum("bqhd,bkd->bhqk", plain.rotate(q, angles), plain.rotate(k, angles))
    torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-5)


def test_padding_gets_no_routed_work_and_no_balance_count():
    valid = torch.tensor([True, True, False, True, False])
    g = torch.Generator().manual_seed(4)
    scores = torch.softmax(torch.randn(5, 8, generator=g), -1)
    weights, experts, dest, slot, offsets = ds.route(scores, valid, 2, group_rows=4)
    rows = slot.shape[0]
    assert rows % 4 == 0 and offsets[-1] <= rows
    assert (dest[~valid] == rows).all() and (dest[valid] < rows).all()
    # each routed pair has its own row, inside its expert's segment, and no
    # row takes a padding token
    pairs = torch.arange(10).view(5, 2)
    assert (slot[dest[valid]] == pairs[valid]).all()
    assert sorted(slot[slot < 10].tolist()) == sorted(pairs[valid].reshape(-1).tolist())
    off = offsets.tolist()
    for e, row in zip(experts[valid].reshape(-1).tolist(), dest[valid].reshape(-1).tolist()):
        assert off[e] <= row < off[e + 1]
    # the balance loss: padding's scores and picks do not count
    b_scores = scores.view(1, 5, 8)
    a = ds.balance_loss(b_scores, experts.view(1, 5, 2), valid.view(1, 5), 1.0)
    b = ds.balance_loss(b_scores[:, valid], experts.view(1, 5, 2)[:, valid], valid[valid].view(1, 3), 1.0)
    torch.testing.assert_close(a, b)
    # the port's whole model: the padding's embedding changes nothing at the real tokens
    model = _model()
    tokens, _, _ = _batch()
    with torch.no_grad():
        before = model.encode({"items": tokens})
        model.embed_items.weight[0].mul_(-3.0).add_(1.0)
        after = model.encode({"items": tokens})
    real = tokens != 0
    torch.testing.assert_close(before[real], after[real], rtol=1e-5, atol=1e-6)


def test_plain_grouped_gemm_against_a_dense_per_row_product():
    g = torch.Generator().manual_seed(5)
    counts = [3, 0, 5, 1]
    padded = [-(-c // 4) * 4 for c in counts]
    off = torch.tensor(np.concatenate([[0], np.cumsum(padded)]), dtype=torch.int32)
    rows = int(off[-1]) + 8
    x = torch.zeros(rows, 6)
    expert_of = torch.full((rows,), -1)
    o = off.tolist()
    for e, c in enumerate(counts):
        x[o[e] : o[e] + c] = torch.randn(c, 6, generator=g)
        expert_of[o[e] : o[e + 1]] = e
    w = torch.randn(4, 5, 6, generator=g)
    y = gg.grouped_mm(x, w, off)
    want = torch.stack([w[e] @ x[r] if e >= 0 else torch.zeros(5) for r, e in enumerate(expert_of.tolist())])
    torch.testing.assert_close(y, want)
    dy = torch.randn(rows, 5, generator=g) * (expert_of >= 0)[:, None]
    dw = gg.grouped_mm_dw(dy, x, off)
    assert not dw[1].any()
    for e in range(4):
        rows_e = expert_of == e
        torch.testing.assert_close(dw[e], dy[rows_e].t() @ x[rows_e])


def test_bert4rec_configurations_build_the_same_modules():
    """No block: the encoder's layers are BERT4Rec's, pre-LN's final norm a
    LayerNorm, the parameters the JAX tree's names, and the model has no
    balance loss."""
    for norm, final in (("post", None), ("pre", LayerNorm)):
        cfg = ModelConfig(features={"items": FeatureConfig(64, 16)}, num_layers=2, num_heads=2, ffn_dim=32,
                          head=HeadConfig("tied_softmax", output_size=50), norm_style=norm)
        model = ClickstreamModel(cfg, device="meta")
        assert all(isinstance(getattr(model.encoder, f"layer_{i}"), EncoderLayer) for i in range(2))
        assert (type(model.encoder.ln_final) if final else model.encoder.ln_final) == final
        per_layer = ["mha.wq.weight", "mha.wq.bias", "mha.wk.weight", "mha.wk.bias", "mha.wv.weight", "mha.wv.bias",
                     "mha.wo.weight", "mha.wo.bias", "ln1.weight", "ln1.bias", "ln2.weight", "ln2.bias",
                     "ffn1.weight", "ffn1.bias", "ffn2.weight", "ffn2.bias"]
        want = ["embed_items.weight"] + [f"encoder.layer_{i}.{n}" for i in range(2) for n in per_layer]
        want += ["encoder.ln_final.weight", "encoder.ln_final.bias"] if final else []
        assert [n for n, _ in model.named_parameters()] == want
        assert "sinusoid" in dict(model.named_buffers())
        assert not any(isinstance(m, (ds.MoE, ds.MLAttention, ds.RMSNorm)) for m in model.modules())


def test_native_batcher_at_the_cell_length_matches_the_reference_batches():
    """The native batcher past its old 64-item scratch (the cell's 200
    items) makes the batches that the benchmark's reference works out from
    the sessions and the seed (``portbench/reference/cloze.py``); ``auto``
    still takes it only up to 64 items, as the JAX package does."""
    from bert4clickpath_torch.data import native
    from bert4clickpath_torch.data.pipeline import ClozeDataset
    from bert4clickpath_torch.vocab import Vocabulary
    from portbench.reference import cloze as ref_cloze

    if not native.available():
        pytest.skip("g++ could not build the native batcher")
    rng = np.random.default_rng(9)
    sessions = [rng.integers(0, 300, size=n).astype(np.int32) for n in rng.integers(20, 260, size=40)]
    vocab = Vocabulary([f"item_{i}" for i in range(300)])
    ds_native = ClozeDataset(sessions, vocab, max_items=200, max_masked=40, masked_percentage=0.2, backend="native")
    assert ClozeDataset(sessions, vocab, max_items=200, backend="auto").backend == "numpy"
    want = ref_cloze.train_batches(sessions, 8, 11, 6, 200, 40, 0.2)
    for got, w in zip(ds_native.train_batches(8, seed=11), want):
        np.testing.assert_array_equal(got.features["items"], w["tokens"])
        np.testing.assert_array_equal(got.head_positions, w["positions"])
        np.testing.assert_array_equal(got.labels, w["labels"])


def test_config_round_trips_and_a_bert4rec_artifact_has_no_block():
    """A DeepSeek-V2 configuration survives to_json / from_json; a BERT4Rec
    one writes no ``block`` key (its artifact is the JAX package's, byte for
    byte); the block takes RoPE and pre-norm only, and no dropout."""
    import json

    cfg = ModelConfig(features={"items": FeatureConfig(64, D)}, num_layers=3, num_heads=HEADS, ffn_dim=48,
                      dropout_rate=0.0, positional="rope", norm_style="pre", block=_block())
    assert ModelConfig.from_json(cfg.to_json()) == cfg
    assert "block" not in json.loads(ModelConfig(features={"items": FeatureConfig(64, D)}).to_json())
    with pytest.raises(ValueError, match="rope"):
        ModelConfig(features={"items": FeatureConfig(64, D)}, norm_style="pre", block=_block())
    with pytest.raises(ValueError, match="pre-norm"):
        ModelConfig(features={"items": FeatureConfig(64, D)}, positional="rope", block=_block())
    with pytest.raises(ValueError, match="no dropout"):
        ClickstreamModel(ModelConfig(features={"items": FeatureConfig(64, D)}, positional="rope", norm_style="pre",
                                     dropout_rate=0.1, block=_block()), device="meta")


def test_plain_gathers_against_a_loop_over_tokens():
    """moe_gather's plain versions: the weighted sum of each token's rows
    and the dots with its gradient, an index past the rows naming none."""
    from bert4clickpath_torch.ops.kernels import moe_gather

    g = torch.Generator().manual_seed(6)
    rows = torch.randn(9, 8, generator=g)
    idx = torch.tensor([[0, 3], [9, 2], [8, 12]])
    w = torch.rand(3, 2, generator=g)
    grad = torch.randn(3, 8, generator=g)
    out = moe_gather.gather_sum(rows, idx, w)
    dots = moe_gather.gather_dot(rows, idx, grad)
    for t in range(3):
        want = sum(w[t, j] * rows[i] for j, i in enumerate(idx[t].tolist()) if i < 9)
        torch.testing.assert_close(out[t], want)
        for j, i in enumerate(idx[t].tolist()):
            torch.testing.assert_close(dots[t, j], rows[i] @ grad[t] if i < 9 else torch.tensor(0.0))


def _dense_uneven(q, k, v, bias, heads, scale):
    split = lambda t: t.unflatten(-1, (heads, -1))  # noqa: E731
    s = torch.einsum("bqhd,bkhd->bhqk", split(q), split(k)) * scale + bias
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), split(v))
    return o.flatten(2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)], ids=["f32", "bf16"])
def test_uneven_attention_matches_a_dense_softmax(dtype, tol):
    from bert4clickpath_torch.ops.kernels.attention import mha

    g = torch.Generator().manual_seed(9)
    b, l, h, dqk, dv, scale = 3, 11, 2, 12, 8, 0.31
    q, k = (torch.randn(b, l, h * dqk, generator=g).to(dtype).requires_grad_() for _ in range(2))
    v = torch.randn(b, l, h * dv, generator=g).to(dtype).requires_grad_()
    do = torch.randn(b, l, h * dv, generator=g).to(dtype)
    bias = torch.where(torch.arange(l)[None, :] < torch.tensor([[11], [7], [3]]), 0.0, -1e9)[:, None, None, :]
    out = mha(q, k, v, bias, h, scale=scale)
    got = torch.autograd.grad(out, (q, k, v), do)
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want_out = _dense_uneven(*leaves, bias, h, scale)
    want = torch.autograd.grad(want_out, leaves, do.float())
    assert out.dtype == dtype and out.shape == (b, l, h * dv)
    for name, a, w in zip(("out", "dq", "dk", "dv"), (out, *got), (want_out, *want)):
        err = (a.float() - w).abs().max().item()
        assert err <= tol * w.abs().max().item(), (name, err)


def test_rope_lookup_adds_no_position():
    model = _model()
    tokens, _, _ = _batch()
    captured = {}
    handle = model.encoder.register_forward_pre_hook(lambda _, args: captured.update(x=args[0]))
    with torch.no_grad():
        model.encode({"items": tokens})
    handle.remove()
    want = model.embed_items.weight[tokens.long()] * math.sqrt(D)
    assert "sinusoid" not in dict(model.named_buffers()) and not list(model.named_buffers())
    torch.testing.assert_close(captured["x"], want, rtol=0, atol=0)


def test_mla_attention_roofline_counts_the_products():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench.metrics import mla_attention_roofline as metric

    cfg = {"num_attention_heads": 16, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
           "num_hidden_layers": 5}
    lengths = [203, 20, 150]
    stats = {"batch": 3, "length": 203, "tokens_sq": sum(n * n for n in lengths)}
    flops, nbytes = metric.work(cfg, stats)
    pairs, h, dqk, dv = sum(n * n for n in lengths), 16, 192, 128
    per_pair = 2 * (dqk + dv) + 2 * (dqk + dv + dv + dqk + dqk)  # s, pv; s, dp, dv, dq, dk
    assert flops == 5 * pairs * h * per_pair
    row_bytes = 3 * 203 * h * 2
    assert nbytes == 5 * (row_bytes * (6 * dqk + 5 * dv) + 3 * 203 * 4 * (2 + 3 * h))
