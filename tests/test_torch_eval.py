"""The port's metrics, chunked eval stats and eval step against the JAX
package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; weights
are seeded numpy values in the flax tree, moved across with
``state_dict_from_flax``. Sums are f32 in both: rtol 1e-5 for the metric
functions (elementwise work and one sum), 1e-4 for an eval step (a model
forward and sums in another order). ``torch.topk`` and ``lax.top_k`` order
exact ties differently: the tie cases put the tie inside or outside every
cut-off, where both orders give the same sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert4clickpath_tpu.config import FeatureConfig as JFeature
from bert4clickpath_tpu.config import HeadConfig as JHead
from bert4clickpath_tpu.config import ModelConfig as JModelConfig
from bert4clickpath_tpu.data.generator import ClickStreamGenerator as JGenerator
from bert4clickpath_tpu.data.pipeline import ClozeDataset as JDataset
from bert4clickpath_tpu.models.model import ClickstreamModel as JModel
from bert4clickpath_tpu.ops import chunked_eval as jce
from bert4clickpath_tpu.ops import metrics as jm
from bert4clickpath_tpu.training import train_state as jts
from bert4clickpath_torch.config import ModelConfig
from bert4clickpath_torch.constants import LABEL_PAD
from bert4clickpath_torch.convert import state_dict_from_flax
from bert4clickpath_torch.data.cloze import stack_batches
from bert4clickpath_torch.data.pipeline import to_device
from bert4clickpath_torch.models.model import ClickstreamModel
from bert4clickpath_torch.ops import chunked_eval as tce
from bert4clickpath_torch.ops import metrics as tm
from bert4clickpath_torch.ops.fused_ce import padded_rows
from bert4clickpath_torch.training import train_state as tts

torch.set_num_threads(1)


def _assert_stats_close(got: dict, want: dict, rtol=1e-5, atol=1e-6):
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(w), rtol=rtol, atol=atol, err_msg=key)


def _ranking_case(seed=0, b=4, p=3, v=40):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, p, v)).astype(np.float32)
    labels = rng.integers(0, v, size=(b, p)).astype(np.int32)
    labels[0, 1] = LABEL_PAD
    labels[2, :] = LABEL_PAD
    # make some labels rank high so the sums are not all zero
    for i, j in ((0, 0), (1, 1), (3, 2)):
        logits[i, j, labels[i, j]] = 5.0 - j
    return logits, labels


# -- ops/metrics.py, function by function -----------------------------------


@pytest.mark.parametrize("ks", [(5, 10), (1, 3), (10, 100)])  # 100 > V: clamped
def test_ranking_stats_matches_jax(ks):
    logits, labels = _ranking_case()
    _assert_stats_close(tm.ranking_stats(torch.from_numpy(logits), torch.from_numpy(labels), ks),
                        jm.ranking_stats(jnp.asarray(logits), jnp.asarray(labels), ks))


def test_ranking_stats_with_ties():
    """Exact ties that no cut-off separates: a tie among the top 3 with the
    label in it (inside k=5 and k=10 whichever order), and a tie far below
    the top 10."""
    logits, labels = _ranking_case(seed=1)
    logits[0, 0, :] = np.linspace(-3, -1, logits.shape[-1])
    logits[0, 0, [4, 9, labels[0, 0]]] = 2.0  # three-way tie at the top
    logits[1, 0, :] = np.linspace(1, 3, logits.shape[-1])
    logits[1, 0, [0, 1, 2]] = -7.0  # a tie at the bottom; label 0 there
    labels[1, 0] = 0
    got = tm.ranking_stats(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jm.ranking_stats(jnp.asarray(logits), jnp.asarray(labels))
    for key in ("n", "recall@5_sum", "recall@10_sum"):
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]), rtol=1e-6, err_msg=key)
    # NDCG depends on the label's rank inside the tie (1, 2 or 3): bounded
    # by the gap between ranks 1 and 3 for that one position
    gap = 1.0 - 1.0 / np.log2(4.0)
    for key in ("ndcg@5_sum", "ndcg@10_sum"):
        assert abs(float(got[key]) - float(want[key])) <= gap + 1e-6


def test_accuracy_and_binary_stats_match_jax():
    logits, labels = _ranking_case(seed=2)
    _assert_stats_close(tm.masked_accuracy_stats(torch.from_numpy(logits), torch.from_numpy(labels)),
                        jm.masked_accuracy_stats(jnp.asarray(logits), jnp.asarray(labels)))
    rng = np.random.default_rng(3)
    blogits = rng.normal(size=(6, 5)).astype(np.float32)
    blabels = rng.integers(-1, 2, size=(6, 5)).astype(np.int32)  # {-1, 0, 1}
    for threshold in (0.5, 0.3):
        _assert_stats_close(tm.binary_stats(torch.from_numpy(blogits), torch.from_numpy(blabels), threshold),
                            jm.binary_stats(jnp.asarray(blogits), jnp.asarray(blabels), threshold))


def test_masked_metric_wrappers_match_jax():
    logits, labels = _ranking_case(seed=4)
    top3_t = tm.masked_metric(
        lambda lg, lb: (torch.argsort(-lg, dim=-1)[..., :3] == lb[..., None]).any(-1), "top3_acc")
    top3_j = jm.masked_metric(
        lambda lg, lb: (jnp.argsort(-lg, -1)[..., :3] == lb[..., None]).any(-1), "top3_acc")
    _assert_stats_close(top3_t(torch.from_numpy(logits), torch.from_numpy(labels)),
                        top3_j(jnp.asarray(logits), jnp.asarray(labels)))
    with pytest.raises(ValueError, match="per-position values"):
        tm.masked_metric(lambda lg, lb: lg, "bad")(torch.from_numpy(logits), torch.from_numpy(labels))
    hist_t = tm.masked_stateful_metric(lambda lg, lb, m: {"maxes": (lg.max(-1).values * m).sum(0)})
    hist_j = jm.masked_stateful_metric(lambda lg, lb, m: {"maxes": (lg.max(-1) * m).sum(0)})
    _assert_stats_close(hist_t(torch.from_numpy(logits), torch.from_numpy(labels)),
                        hist_j(jnp.asarray(logits), jnp.asarray(labels)))


def test_auc_merge_finalize_match_jax():
    rng = np.random.default_rng(5)
    parts_t, parts_j = [], []
    for _ in range(3):
        logits = (rng.normal(size=(8, 4)) * 2).astype(np.float32)
        labels = rng.integers(-1, 2, size=(8, 4)).astype(np.int32)
        logits += labels.clip(0, 1) * 1.5  # separable enough for AUC > 0.5
        t = (torch.from_numpy(logits), torch.from_numpy(labels))
        j = (jnp.asarray(logits), jnp.asarray(labels))
        _assert_stats_close(tm.auc_stats(*t, num_thresholds=50), jm.auc_stats(*j, num_thresholds=50))
        parts_t.append(tm.merge(tm.auc_stats(*t), tm.binary_stats(*t)))
        parts_j.append(jm.merge(jm.auc_stats(*j), jm.binary_stats(*j)))
    merged_t, merged_j = tm.merge(*parts_t), jm.merge(*parts_j)
    _assert_stats_close(merged_t, merged_j)
    got, want = tm.finalize(merged_t), jm.finalize(jax.device_get(merged_j))
    assert set(got) == set(want) and {"auc", "f1", "positives", "tp", "n"} <= set(got)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-5, atol=1e-7, err_msg=key)
    assert 0.5 < got["auc"] <= 1.0
    # empty accumulators: rates over max(n, 1)
    empty = {"n": torch.zeros(()), "loss_sum": torch.zeros(())}
    assert tm.finalize(empty) == {"n": 0.0, "loss": 0.0}


# -- ops/chunked_eval.py:chunked_eval_stats ---------------------------------


@pytest.mark.parametrize("with_bias", [False, True])
def test_chunked_eval_stats_matches_jax_and_dense(with_bias):
    """Against the JAX scan (rtol 1e-5) and against the dense route over
    the same logits (ranking_stats + logsumexp; 1e-5)."""
    rng = np.random.default_rng(6)
    b, p, d, v, off, nv = 4, 3, 16, 256, 10, 200
    x = rng.normal(size=(b, p, d)).astype(np.float32)
    table = rng.normal(size=(v, d)).astype(np.float32)
    bias = rng.normal(size=(v,)).astype(np.float32) if with_bias else None
    labels = rng.integers(0, nv, size=(b, p)).astype(np.int32)
    labels[1, 2] = LABEL_PAD
    table[labels[0, 0] + off] = x[0, 0] * 2  # some hits
    table[labels[3, 1] + off] = x[3, 1] * 2
    tb = None if bias is None else torch.from_numpy(bias)
    got = tce.chunked_eval_stats(torch.from_numpy(x), torch.from_numpy(table), torch.from_numpy(labels),
                                 ks=(5, 10), row_offset=off, num_valid=nv, chunk=64, bias=tb)
    want = jce.chunked_eval_stats(jnp.asarray(x), jnp.asarray(table), jnp.asarray(labels), ks=(5, 10),
                                  row_offset=off, num_valid=nv, chunk=64,
                                  bias=None if bias is None else jnp.asarray(bias))
    _assert_stats_close(got, want, rtol=1e-5, atol=1e-5)
    assert float(got["recall@5_sum"]) >= 2.0
    logits = torch.from_numpy(x) @ torch.from_numpy(table[off : off + nv]).T
    if with_bias:
        logits = logits + tb[off : off + nv]
    dense = tm.ranking_stats(logits, torch.from_numpy(labels))
    mask = torch.from_numpy(labels != LABEL_PAD)
    picked = logits.gather(-1, torch.from_numpy(labels).clamp(min=0).long()[..., None])[..., 0]
    dense["loss_sum"] = ((torch.logsumexp(logits, -1) - picked) * mask).sum()
    _assert_stats_close(got, dense, rtol=1e-5, atol=1e-5)


# -- training/train_state.py:make_eval_step ----------------------------------

N_ITEMS, D, B, MAX_ITEMS = 117, 16, 8, 13


def _jcfg(head_kind):
    v = N_ITEMS
    if head_kind == "tied_softmax":
        rows, head = padded_rows(N_ITEMS + 11), JHead("tied_softmax", output_size=v, tied_bias=True)
    else:
        rows, head = N_ITEMS + 11, JHead("softmax", (24,), v)
    return JModelConfig(
        features={"items": JFeature(rows, D)}, num_layers=1, num_heads=2, ffn_dim=32, dropout_rate=0.0,
        max_len=MAX_ITEMS + 3, head=head, qkv_fused=True,
    )


def _eval_batches(k=3):
    gen = JGenerator(n_items=N_ITEMS, session_cohesiveness=200, seed=0)
    items, _ = gen.generate_sessions(B * k - 3)  # a ragged last batch, padded
    ds = JDataset(items, gen.item_vocab(), max_items=MAX_ITEMS, backend="numpy")
    return list(ds.eval_batches(B))


def _jax_batch(b):
    return {
        "features": {k: jnp.asarray(v) for k, v in b.features.items()},
        "head_positions": jnp.asarray(b.head_positions),
        "labels": jnp.asarray(b.labels),
    }


def _models(head_kind):
    jcfg = _jcfg(head_kind)
    jmodel = JModel(jcfg)
    b0 = _jax_batch(_eval_batches(1)[0])
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), b0["features"], b0["head_positions"])
    rng = np.random.default_rng(11)

    def fill(path, s):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + rng.normal(scale=0.3, size=s.shape)).astype(s.dtype)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    cfg = ModelConfig.from_json(jcfg.to_json())
    model = ClickstreamModel(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(cfg, params))
    return jmodel, params, model


@pytest.mark.parametrize("head_kind", ["tied_softmax", "softmax"])
@pytest.mark.parametrize("chunked", [True, False])
def test_eval_step_matches_jax(head_kind, chunked):
    """The eval step's sums against the JAX step from transplanted weights,
    rtol 1e-4, chunked and dense routes, tied (with a bias) and MLP head;
    the two routes of the port agree too."""
    jmodel, params, model = _models(head_kind)
    nv = N_ITEMS if chunked else None
    jstep = jts.make_eval_step(jmodel, chunked_num_valid=nv)
    tstep = tts.make_eval_step(model, chunked_num_valid=nv)
    tparams = dict(model.named_parameters())
    acc_t = acc_j = None
    for b in _eval_batches():
        got = tstep(tparams, to_device(b, "cpu"))
        want = jstep(params, _jax_batch(b))
        assert all(not v.requires_grad for v in got.values())
        _assert_stats_close(got, want, rtol=1e-4, atol=1e-4)
        acc_t = got if acc_t is None else tm.merge(acc_t, got)
        acc_j = want if acc_j is None else jm.merge(acc_j, want)
    got, want = tm.finalize(acc_t), jm.finalize(jax.device_get(acc_j))
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-4, atol=1e-5, err_msg=key)
    other = tts.make_eval_step(model, chunked_num_valid=None if chunked else N_ITEMS)
    b = _eval_batches()[0]
    _assert_stats_close(tstep(tparams, to_device(b, "cpu")), other(tparams, to_device(b, "cpu")), 1e-4, 1e-4)


def test_stacked_eval_step_equals_per_batch_and_ema_params_stand_in():
    """steps_per_call > 1 over a stacked batch gives the merged per-batch
    sums exactly; params other than the model's own (an EMA shadow) are
    evaluated without touching the model."""
    _, _, model = _models("tied_softmax")
    params = dict(model.named_parameters())
    batches = _eval_batches()
    one = tts.make_eval_step(model, chunked_num_valid=N_ITEMS)
    many = tts.make_eval_step(model, chunked_num_valid=N_ITEMS, steps_per_call=3)
    want = tm.merge(*(one(params, to_device(b, "cpu")) for b in batches))
    got = many(params, to_device(stack_batches(batches), "cpu"))
    for key in want:
        assert torch.equal(got[key], want[key]), key
    before = {k: p.detach().clone() for k, p in params.items()}
    shadow = {k: p.detach() * 0.5 for k, p in params.items()}
    scaled = one(shadow, to_device(batches[0], "cpu"))
    assert not torch.equal(scaled["loss_sum"], one(params, to_device(batches[0], "cpu"))["loss_sum"])
    for k, p in model.named_parameters():
        assert torch.equal(p, before[k]) and p is params[k]
    with pytest.raises(KeyError, match="do not match"):
        one({"nope": torch.zeros(1)}, to_device(batches[0], "cpu"))
