"""The port's binary and multilabel heads, their model, eval step and train
step, and the chaining module, against the JAX package on the CPU.

Small sizes (2 layers, d_model 32, 4 heads, a 131-row table, B=8); inputs
made with numpy from a seed; the JAX weights (N(0, 0.1), LayerNorm scales
near 1) move across with ``state_dict_from_flax``. The chained layout
``[CLS][SEP] history [SEP] basket [SEP]`` puts pads inside the sequence,
before each [SEP]; there the JAX model runs its Pallas attention and
gather kernels in interpret mode, the port its kernels' plain versions.
Each test states its tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert4clickpath_tpu.config import FeatureConfig as JFeature
from bert4clickpath_tpu.config import HeadConfig as JHead
from bert4clickpath_tpu.config import ModelConfig as JModelConfig
from bert4clickpath_tpu.config import TrainConfig as JTrainConfig
from bert4clickpath_tpu.data import chaining as jchaining
from bert4clickpath_tpu.models import heads as jheads
from bert4clickpath_tpu.models.model import ClickstreamModel as JModel
from bert4clickpath_tpu.ops import losses as jlosses
from bert4clickpath_tpu.training import schedules as jsched
from bert4clickpath_tpu.training import train_state as jts
from bert4clickpath_torch.config import ModelConfig, TrainConfig
from bert4clickpath_torch.constants import CLS_ID, LABEL_PAD, PAD_ID, SEP_ID
from bert4clickpath_torch.convert import _flatten, _torch_key, flax_from_state_dict, state_dict_from_flax
from bert4clickpath_torch.data import chaining
from bert4clickpath_torch.models import heads
from bert4clickpath_torch.models.encoder import Dense
from bert4clickpath_torch.models.model import ClickstreamModel, init_state_dict
from bert4clickpath_torch.ops import losses
from bert4clickpath_torch.training import schedules
from bert4clickpath_torch.training import train_state as tts

torch.set_num_threads(1)

V_ROWS, D, B, C = 131, 32, 8, 5
HIST, BASKET = 9, 4  # chained_length = 17: B * L = 136 tiles by 8, so the JAX gather kernel runs
SEGS = (HIST, BASKET)
L = 13  # the CLS-routed models' sequences
POS_WEIGHT = 2.0
LR = 1e-3


def _jcfg(kind: str, **kw) -> JModelConfig:
    """binary_cls / multilabel_cls: the [CLS] summary (segment (0, 1));
    chained: the basket segment of a chained history + basket, with
    segment embeddings."""
    base = dict(features={"items": JFeature(V_ROWS, D)}, num_layers=2, num_heads=4, ffn_dim=64, dropout_rate=0.0,
                max_len=L, routing="segment", segment_bounds=(0, 1), qkv_fused=True)
    if kind == "binary_cls":
        base.update(head=JHead("binary", (24,)))
    elif kind == "multilabel_cls":
        base.update(head=JHead("multilabel", (24,), C))
    elif kind == "chained":
        base.update(head=JHead("binary", (24, 16)), max_len=jchaining.chained_length(SEGS),
                    segment_bounds=jchaining.segment_bounds(SEGS, 2), use_segment_embeddings=True, max_segments=4)
    else:
        raise ValueError(kind)
    base.update(kw)
    return JModelConfig(**base)


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig.from_json(jcfg.to_json())


def _batch(kind: str, seed: int = 0) -> dict:
    """Host batch of numpy arrays: ragged sessions (one empty), labels with
    pads (a multilabel row of pads, basket slots past the basket)."""
    rng = np.random.default_rng(seed)
    if kind == "chained":
        hist = np.full((B, HIST), PAD_ID, np.int32)
        basket = np.full((B, BASKET), PAD_ID, np.int32)
        labels = np.full((B, BASKET), LABEL_PAD, np.int32)
        for i in range(B):
            n, k = int(rng.integers(0, HIST + 1)), int(rng.integers(1, BASKET + 1))
            hist[i, :n] = rng.integers(10, V_ROWS, size=n)
            basket[i, :k] = rng.integers(10, V_ROWS, size=k)
            labels[i, :k] = rng.integers(0, 2, size=k)
        tokens = chaining.chain_sequences([hist, basket])
    else:
        tokens = np.full((B, L), PAD_ID, np.int32)
        tokens[:, 0], tokens[:, 1], tokens[:, -1] = CLS_ID, SEP_ID, SEP_ID
        for i in range(1, B):
            n = int(rng.integers(1, L - 2))
            tokens[i, 2 : 2 + n] = rng.integers(10, V_ROWS, size=n)
        if kind == "multilabel_cls":
            labels = rng.integers(0, 2, size=(B, C)).astype(np.int32)
            labels[3] = LABEL_PAD
        else:
            labels = rng.integers(0, 2, size=(B, 1)).astype(np.int32)
            labels[3] = LABEL_PAD
    return {"features": {"items": tokens}, "head_positions": None, "labels": labels}


def _jax(batch: dict) -> dict:
    return {"features": {k: jnp.asarray(v) for k, v in batch["features"].items()}, "labels": jnp.asarray(batch["labels"])}


def _torch(batch: dict) -> dict:
    return {"features": {k: torch.from_numpy(v) for k, v in batch["features"].items()}, "head_positions": None,
            "labels": torch.from_numpy(batch["labels"])}


def _fill(shapes, seed=1):
    """Seeded numpy weights in a flax tree of shapes: LayerNorm scales near
    1, every other leaf N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + rng.normal(scale=0.1, size=s.shape)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _models(kind: str, jax_impl: dict, **cfg_kw):
    jcfg = _jcfg(kind, **cfg_kw)
    jmodel = JModel(jcfg, **jax_impl)
    jb = _jax(_batch(kind))
    params = _fill(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jb["features"]))
    cfg = _port_cfg(jcfg)
    model = ClickstreamModel(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(cfg, params))
    return jmodel, params, model


# the chained layout through the JAX Pallas kernels (interpret mode)
PALLAS = dict(attn_impl="pallas", embed_impl="pallas")
KINDS = ["binary_cls", "chained", "multilabel_cls"]


# -- the heads alone -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "kind,shape,want_shape",
    [
        ("binary", (4, 1, D), (4, 1)),
        ("binary", (4, 3, D), (4, 3)),
        ("multilabel", (4, 1, D), (4, C)),  # one routed position: squeezed
        ("multilabel", (4, 3, D), (4, 3, C)),  # P > 1: kept
        ("multilabel", (4, D), (4, C)),
    ],
)
def test_heads_match_flax(kind, shape, want_shape, dtype):
    """BinaryHead squeezes the last axis; MultiLabelHead squeezes axis 1 only
    for 3-D logits with one position. Logits come out in the compute dtype.
    f32 within 1e-5; bf16 within 2e-2 (one bf16 ulp of an O(1) logit: the
    two frameworks round the MLP's output at other places)."""
    jdtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdtype = torch.float32 if dtype == "float32" else torch.bfloat16
    dims = (24, 16)
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    if kind == "binary":
        jhead = jheads.BinaryHead(dims, jdtype)
        thead = heads.BinaryHead(D, dims, tdtype, device="cpu")
    else:
        jhead = jheads.MultiLabelHead(dims, C, jdtype)
        thead = heads.MultiLabelHead(D, dims, C, tdtype, device="cpu")
    params = _fill(jax.eval_shape(jhead.init, jax.random.PRNGKey(0), jnp.asarray(x)))
    sd = {}
    for path, leaf in _flatten(params["params"]):
        key, transpose = _torch_key(path)
        sd[key] = torch.from_numpy(np.ascontiguousarray(np.asarray(leaf).T if transpose else np.asarray(leaf)))
    thead.load_state_dict(sd)  # strict: the flax names are the port's (mlp.dense_i, out)
    want = jhead.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = thead(torch.from_numpy(x))
    assert tuple(got.shape) == tuple(want.shape) == want_shape
    assert got.dtype == tdtype and want.dtype == jdtype
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


# -- the model -------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_jax(kind, dtype):
    """ClickstreamModel.forward against the JAX model's __call__: (B, 1)
    binary logits on [CLS], (B, BASKET) on the chained basket segment
    (segment embeddings, pads inside the sequence), (B, C) multilabel on
    [CLS]. f32 rtol / atol 1e-5; bf16 atol 6e-2 (O(1) logits after two
    post-LN layers; the frameworks round at other places)."""
    jmodel, params, model = _models(kind, PALLAS, dtype=dtype)
    batch = _batch(kind)
    want = np.asarray(jmodel.apply(params, _jax(batch)["features"]), np.float32)
    with torch.no_grad():
        got = model(_torch(batch)["features"])
    assert tuple(got.shape) == want.shape == batch["labels"].shape
    assert got.dtype == model.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=6e-2)


def test_chained_batch_has_interior_pads():
    """The chained layout the forward test feeds: [SEP] at the segment ends,
    pads before them, segment ids 0, 1, 2 over the three spans."""
    tokens = _batch("chained")["features"]["items"]
    assert tokens.shape == (B, chaining.chained_length(SEGS))
    assert (tokens[:, [1, 2 + HIST, 3 + HIST + BASKET]] == SEP_ID).all()
    pads = tokens == PAD_ID
    assert (pads[:, 2 : 2 + HIST] & ~pads[:, -1:]).any()  # a pad with a real token after it


@pytest.mark.parametrize("kind", KINDS)
def test_eval_step_matches_jax(kind):
    """make_eval_step's sums against the JAX eval step with a pos_weight
    loss (both heads: the multilabel's multi-hot labels take the binary
    loss too): loss_sum rtol 1e-5; n, positives, predicted positives and
    true positives equal (pooled over the classes for multilabel)."""
    jmodel, params, model = _models(kind, {})
    batch = _batch(kind)
    jloss = functools.partial(jlosses.masked_binary_cross_entropy, pos_weight=POS_WEIGHT)
    tloss = functools.partial(losses.masked_binary_cross_entropy, pos_weight=POS_WEIGHT)
    want = {k: float(v) for k, v in jts.make_eval_step(jmodel, loss_fn=jloss)(params, _jax(batch)).items()}
    got = {k: float(v) for k, v in tts.make_eval_step(model, loss_fn=tloss)(dict(model.named_parameters()),
                                                                              _torch(batch)).items()}
    assert set(got) == set(want) == {"loss_sum", "n", "positives_sum", "pred_positives_sum", "tp_sum"}
    np.testing.assert_allclose(got["loss_sum"], want["loss_sum"], rtol=1e-5)
    for key in ("n", "positives_sum", "pred_positives_sum", "tp_sum"):
        assert got[key] == want[key], key
    assert got["n"] == (batch["labels"] != LABEL_PAD).sum()


@pytest.mark.parametrize("kind", ["chained", "multilabel_cls"])
def test_train_trajectory_matches_jax(kind):
    """Ten dense train steps (dropout 0, f32, bf16 Adam first moment,
    constant LR 1e-3) against the JAX make_train_step, the binary model with
    the pos_weight loss and the multilabel one with its default loss, on
    ten batches: every step's loss rtol 1e-4."""
    jmodel, params, model = _models(kind, {})
    jloss = tloss = None
    if kind == "chained":
        jloss = functools.partial(jlosses.masked_binary_cross_entropy, pos_weight=POS_WEIGHT)
        tloss = functools.partial(losses.masked_binary_cross_entropy, pos_weight=POS_WEIGHT)
    jtx = jts.make_optimizer(JTrainConfig(), mu_dtype=jnp.bfloat16)
    jstep = jts.make_train_step(jmodel, jtx, jsched.constant(LR), loss_fn=jloss, donate=False)
    jstate = jts.TrainState.create(params, jtx)
    ttx = tts.make_optimizer(TrainConfig(), mu_dtype=torch.bfloat16)
    tstep = tts.make_train_step(model, ttx, schedules.constant(LR), loss_fn=tloss)
    tstate = tts.TrainState.create(dict(model.named_parameters()), ttx)
    jlosses_, tlosses_ = [], []
    for i in range(10):
        batch = _batch(kind, seed=10 + i)
        jstate, jl = jstep(jstate, _jax(batch), jax.random.PRNGKey(0))
        tstate, tl = tstep(tstate, _torch(batch))
        jlosses_.append(float(jl))
        tlosses_.append(tl.item())
    np.testing.assert_allclose(tlosses_, jlosses_, rtol=1e-4)
    assert tstate.step == 10 and tlosses_[-1] != tlosses_[0]


# -- initialisation and conversion ----------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_init_state_dict_matches_flax_init(kind):
    """init_state_dict has flax init's keys and shapes, and gives the heads
    flax's initialisers: Dense biases 0, Dense weights inside the truncation
    at two standard deviations with a std within 5 sigma of 1 / sqrt(fan_in)
    (an estimate from n values has a relative error of about 1 / sqrt(2 n))."""
    jcfg = _jcfg(kind)
    jmodel = JModel(jcfg)
    jparams = jmodel.init({"params": jax.random.PRNGKey(0)}, _jax(_batch(kind))["features"])
    cfg = _port_cfg(jcfg)
    sd = init_state_dict(cfg, 0)

    def flat(tree):
        return {jax.tree_util.keystr(p): np.asarray(v).shape for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    assert flat(flax_from_state_dict(cfg, sd)) == flat(jparams)
    modules = dict(ClickstreamModel(cfg, device="meta").named_modules())
    head_keys = [k for k in sd if k.startswith("head.")]
    assert head_keys and any(k.startswith("head.out.") for k in head_keys)
    for key in head_keys:
        owner, _, leaf = key.rpartition(".")
        assert isinstance(modules[owner], Dense), key
        w = sd[key].numpy()
        if leaf == "bias":
            assert not w.any(), key
            continue
        std = 1.0 / np.sqrt(w.shape[1])
        assert np.abs(w).max() <= 2.0 * std / 0.87962566103423978 + 1e-6, key
        assert abs(w.std() - std) <= 5.0 * std / np.sqrt(2 * w.size), key


def test_state_dict_from_flax_maps_the_heads():
    """convert maps head/mlp/dense_i and head/out by name, both ways."""
    for kind in KINDS:
        _, params, model = _models(kind, {})
        cfg = model.config
        back = flax_from_state_dict(cfg, state_dict_from_flax(cfg, params))
        p = params["params"]["head"]
        np.testing.assert_array_equal(back["params"]["head"]["out"]["kernel"], p["out"]["kernel"])
        np.testing.assert_array_equal(back["params"]["head"]["mlp"]["dense_0"]["bias"], p["mlp"]["dense_0"]["bias"])
        assert dict(model.named_parameters())["head.out.weight"].shape == p["out"]["kernel"].T.shape


# -- chaining ------------------------------------------------------------------------------


@pytest.mark.parametrize("lengths", [(5,), (9, 4), (41, 8), (3, 0, 6)])
def test_chaining_matches_jax(lengths):
    """chained_length, every segment_bounds and chain_sequences equal to the
    JAX module's; an out-of-range segment raises in both."""
    assert chaining.chained_length(lengths) == jchaining.chained_length(lengths)
    for seg in range(len(lengths) + 1):
        assert chaining.segment_bounds(lengths, seg) == jchaining.segment_bounds(lengths, seg)
    for mod in (chaining, jchaining):
        with pytest.raises(ValueError, match="out of range"):
            mod.segment_bounds(lengths, len(lengths) + 1)
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 50, size=(4, n)).astype(np.int32) for n in lengths]
    got, want = chaining.chain_sequences(seqs), jchaining.chain_sequences(seqs)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.shape == (4, chaining.chained_length(lengths))
    assert (got[:, 0] == CLS_ID).all()
