"""The port's ClickstreamModel forward vs the JAX model, with the JAX
weights moved across by ``state_dict_from_flax``.

Small sizes (2 layers, D=32, H=4, L=13, a few hundred catalog rows); inputs
made with numpy from a seed. Tolerances: f32 rtol/atol 1e-4 (sums in another
order through two layers); bf16 atol 6e-2 on the O(1) post-LN head inputs
(bf16 keeps 8 bits, and the two frameworks round at different places: the
JAX xla path rounds the embedding to bf16 before x sqrt(d) and + pos where
the port's kernel rounds once, and XLA fuses casts that torch rounds).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert4clickpath_tpu.config import FeatureConfig as JFeature
from bert4clickpath_tpu.config import HeadConfig as JHead
from bert4clickpath_tpu.config import ModelConfig as JModelConfig
from bert4clickpath_tpu.constants import CLS_ID, PAD_ID, SEP_ID
from bert4clickpath_tpu.models.model import ClickstreamModel as JModel
from bert4clickpath_torch.config import ModelConfig
from bert4clickpath_torch.convert import state_dict_from_flax
from bert4clickpath_torch.models.model import ClickstreamModel, head_catalog

torch.set_num_threads(1)

V_ROWS, D, L, P = 311, 32, 13, 3
N_LABELS = V_ROWS - 11


def _jcfg(**kw):
    base = dict(
        features={"items": JFeature(V_ROWS, D)},
        num_layers=2,
        num_heads=4,
        ffn_dim=64,
        max_len=L,
        head=JHead("tied_softmax", output_size=N_LABELS),
        max_masked=P,
    )
    base.update(kw)
    return JModelConfig(**base)


def _port_cfg(jcfg) -> ModelConfig:
    # one model_config.json serves both packages
    return ModelConfig.from_json(jcfg.to_json())


def _inputs(b, names=("items",), seed=0):
    rng = np.random.default_rng(seed)
    feats = {}
    for n in names:
        tokens = rng.integers(10, V_ROWS, size=(b, L)).astype(np.int32)
        tokens[:, 0], tokens[:, 1], tokens[:, -1] = CLS_ID, SEP_ID, SEP_ID
        # ragged padding: row i keeps 2 + (i % 9) items
        for i in range(b):
            tokens[i, 4 + (i % 9) : -1] = PAD_ID
        feats[n] = tokens
    feats[names[0]][0, 2:-1] = PAD_ID  # an (almost) empty session
    positions = rng.integers(2, L - 1, size=(b, P)).astype(np.int32)
    return feats, positions


def _jax_params(model, jf, positions):
    """Seeded numpy weights in the flax tree's structure (shapes from
    eval_shape, so no init is compiled): LayerNorm scales near 1, every
    other leaf N(0, 0.1)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jf, positions)
    rng = np.random.default_rng(1)

    def fill(path, s):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + rng.normal(scale=0.1, size=s.shape)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_forward(jcfg, feats, positions, method, **impl):
    model = JModel(jcfg, **impl)
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    params = _jax_params(model, jf, jnp.asarray(positions))
    if method is None:
        return params, None
    out = jax.jit(lambda p, f, h: model.apply(p, f, h, method=method))(params, jf, jnp.asarray(positions))
    return params, np.asarray(out)


def _port_forward(jcfg, params, feats, positions, method):
    cfg = _port_cfg(jcfg)
    model = ClickstreamModel(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(cfg, params))
    model.eval()
    with torch.no_grad():
        out = getattr(model, method)(
            {k: torch.from_numpy(v) for k, v in feats.items()}, torch.from_numpy(positions)
        )
    return model, out


CASES = {
    # flagship shape in miniature, JAX through both Pallas kernels (B*L=104
    # tiles by 8, so the JAX gather kernel runs)
    "post_fused_sin_f32_pallas": (dict(qkv_fused=True), dict(attn_impl="pallas", embed_impl="pallas"), 8),
    "post_fused_sin_bf16_pallas": (dict(qkv_fused=True, dtype="bfloat16"), dict(attn_impl="pallas", embed_impl="pallas"), 8),
    "pre_sep_learned_f32": (dict(norm_style="pre", positional="learned"), {}, 5),
    "pre_sep_learned_bf16": (dict(norm_style="pre", positional="learned", dtype="bfloat16"), {}, 5),
    "tied_transform_bias_f32": (
        dict(qkv_fused=True, head=JHead("tied_softmax", dense_dims=(48, 24), output_size=N_LABELS, tied_bias=True)),
        dict(attn_impl="pallas"), 4,
    ),
    "segment_embeddings_f32": (dict(use_segment_embeddings=True, max_segments=3), {}, 4),
    "segment_routing_f32": (dict(routing="segment", segment_bounds=(0, 2)), {}, 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gather_head_inputs_matches_jax(case):
    cfg_kw, impl, b = CASES[case]
    jcfg = _jcfg(**cfg_kw)
    feats, positions = _inputs(b)
    params, want = _jax_forward(jcfg, feats, positions, "gather_head_inputs", **impl)
    _, got = _port_forward(jcfg, params, feats, positions, "gather_head_inputs")
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    if jcfg.dtype == "bfloat16":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=6e-2)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_multi_feature_input_proj_matches_jax():
    """Two features concatenated, factorized input projection: the port's
    non-kernel embed path (x sqrt(width) before input_proj). f32, 1e-4."""
    jcfg = _jcfg(
        features={"items": JFeature(V_ROWS, 16), "actions": JFeature(V_ROWS, 8)},
        encoder_dim=D,
    )
    feats, positions = _inputs(4, names=("items", "actions"))
    params, want = _jax_forward(jcfg, feats, positions, "gather_head_inputs")
    model, got = _port_forward(jcfg, params, feats, positions, "gather_head_inputs")
    assert model.input_proj is not None and model.tied_proj is not None
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_head_trunk_matches_jax(dtype):
    """The parity MLP head's trunk (everything but the catalog Dense)."""
    jcfg = _jcfg(head=JHead("softmax", dense_dims=(64, 48), output_size=N_LABELS), dtype=dtype)
    feats, positions = _inputs(4)
    params, want = _jax_forward(jcfg, feats, positions, "head_trunk_outputs")
    _, got = _port_forward(jcfg, params, feats, positions, "head_trunk_outputs")
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(rtol=0, atol=6e-2)
    np.testing.assert_allclose(got.numpy(), want, **tol)


@pytest.mark.parametrize("kind", ["tied_softmax", "softmax"])
def test_head_catalog_matches_jax(kind):
    """The served catalog (table, bias, row_offset, base_rows), padded: exact."""
    from bert4clickpath_tpu.models.model import head_catalog as jax_head_catalog

    head = (
        JHead("tied_softmax", output_size=N_LABELS, tied_bias=True)
        if kind == "tied_softmax"
        else JHead("softmax", dense_dims=(48,), output_size=N_LABELS)
    )
    jcfg = _jcfg(head=head)
    feats, positions = _inputs(2)
    params, _ = _jax_forward(jcfg, feats, positions, None)
    cfg = _port_cfg(jcfg)
    sd = state_dict_from_flax(cfg, params)
    want = jax_head_catalog(jcfg, params, pad_rows=True)
    got = head_catalog(cfg, sd, pad_rows=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2:] == tuple(want[2:])
    assert got[0].shape[0] % 128 == 0


def test_state_dict_from_flax_round_trip():
    """Every flax leaf lands in the port unchanged (Dense kernels
    transposed), and every port parameter is filled."""
    jcfg = _jcfg(qkv_fused=True, positional="learned", norm_style="pre",
                 head=JHead("tied_softmax", dense_dims=(24,), output_size=N_LABELS, tied_bias=True))
    feats, positions = _inputs(2)
    params, _ = _jax_forward(jcfg, feats, positions, None)
    cfg = _port_cfg(jcfg)
    sd = state_dict_from_flax(cfg, params)
    p = params["params"]
    np.testing.assert_array_equal(sd["encoder.layer_1.mha.wqkv.weight"].numpy(), p["encoder"]["layer_1"]["mha"]["wqkv"]["kernel"].T)
    np.testing.assert_array_equal(sd["encoder.ln_final.weight"].numpy(), p["encoder"]["ln_final"]["scale"])
    np.testing.assert_array_equal(sd["positions.embedding"].numpy(), p["positions"]["embedding"])
    np.testing.assert_array_equal(sd["embed_items.weight"].numpy(), p["embed_items"]["embedding"])
    np.testing.assert_array_equal(sd["tied_out_bias"].numpy(), p["tied_out_bias"])
    n_flax = len(jax.tree.leaves(p))
    assert len(sd) == n_flax
    model = ClickstreamModel(cfg, device="cpu")
    model.load_state_dict(sd)  # strict: no key missing or unexpected


def test_state_dict_from_flax_raises_on_unmapped_and_missing():
    jcfg = _jcfg()
    feats, positions = _inputs(2)
    params, _ = _jax_forward(jcfg, feats, positions, None)
    cfg = _port_cfg(jcfg)
    extra = {"params": {**params["params"], "mystery": {"kernel": np.zeros((2, 2), np.float32)}}}
    with pytest.raises(KeyError, match="mystery"):
        state_dict_from_flax(cfg, extra)
    missing = {"params": {k: v for k, v in params["params"].items() if k != "embed_items"}}
    with pytest.raises(KeyError, match="embed_items.weight"):
        state_dict_from_flax(cfg, missing)
    wrong = _port_cfg(dataclasses.replace(jcfg, ffn_dim=32))
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_flax(wrong, params)


def test_unported_heads_and_logits_path_raise():
    with pytest.raises(ValueError, match="not ported"):
        ClickstreamModel(_port_cfg(_jcfg(head=JHead("binary", (8,)))), device="meta")
    model = ClickstreamModel(_port_cfg(_jcfg()), device="meta")
    with pytest.raises(NotImplementedError):
        model({}, None)
