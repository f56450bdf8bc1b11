"""The port's train step against the JAX package's, on the CPU.

Small sizes (2 layers, d_model 32, 4 heads, a 189-item catalog whose 200
model rows pad to 256 through ``padded_rows``, B=8, L=16 so that B*L is a
multiple of 8 and the JAX model's ``embed_impl="pallas"`` really takes its
gather kernel). Weights are made with numpy from a seed in the flax tree and
moved across with ``state_dict_from_flax``; batches come from the same
synthetic sessions. The JAX step runs with ``attn_impl="pallas"`` and
``embed_impl="pallas"`` (Pallas kernels in interpret mode), the port's
through its kernels' plain versions. Each test states its tolerance.
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
from bert4clickpath_tpu.config import TrainConfig as JTrainConfig
from bert4clickpath_tpu.data.generator import ClickStreamGenerator as JGenerator
from bert4clickpath_tpu.data.pipeline import ClozeDataset as JDataset
from bert4clickpath_tpu.models.model import ClickstreamModel as JModel
from bert4clickpath_tpu.training import schedules as jsched
from bert4clickpath_tpu.training import train_state as jts
from bert4clickpath_torch.config import ModelConfig, TrainConfig
from bert4clickpath_torch.convert import flax_from_state_dict, state_dict_from_flax
from bert4clickpath_torch.data.generator import ClickStreamGenerator
from bert4clickpath_torch.data.pipeline import ClozeDataset, to_device
from bert4clickpath_torch.models.model import ClickstreamModel
from bert4clickpath_torch.ops.fused_ce import padded_rows
from bert4clickpath_torch.training import schedules
from bert4clickpath_torch.training import train_state as tts

torch.set_num_threads(1)

N_ITEMS, D, B, MAX_ITEMS, P = 189, 32, 8, 13, 10
LR = 1e-3


def _jcfg(**kw):
    base = dict(
        features={"items": JFeature(padded_rows(N_ITEMS + 11), D)},
        num_layers=2,
        num_heads=4,
        ffn_dim=64,
        dropout_rate=0.0,
        max_len=MAX_ITEMS + 3,
        head=JHead("tied_softmax", output_size=N_ITEMS),
        max_masked=P,
        qkv_fused=True,
    )
    base.update(kw)
    return JModelConfig(**base)


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig.from_json(jcfg.to_json())


def _sessions(n=64, seed=0):
    items, _ = JGenerator(n_items=N_ITEMS, session_cohesiveness=200, seed=seed).generate_sessions(n)
    return items, JGenerator(n_items=N_ITEMS).item_vocab()


def _host_batches(k, seed=0):
    items, vocab = _sessions()
    it = JDataset(items, vocab, max_items=MAX_ITEMS, backend="numpy").train_batches(B, seed=seed)
    return [next(it) for _ in range(k)]


def _jax_batch(b):
    return {
        "features": {k: jnp.asarray(v) for k, v in b.features.items()},
        "head_positions": jnp.asarray(b.head_positions),
        "labels": jnp.asarray(b.labels),
    }


def _seeded_params(jmodel, batch):
    """Seeded numpy weights in the flax tree (shapes from eval_shape):
    LayerNorm scales near 1, every other leaf N(0, 0.1)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch["features"], batch["head_positions"])
    rng = np.random.default_rng(1)

    def fill(path, s):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + rng.normal(scale=0.1, size=s.shape)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_model(jcfg, params):
    cfg = _port_cfg(jcfg)
    model = ClickstreamModel(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(cfg, params))
    return model


def _assert_tree_close(got: dict, want, rtol, atol, what=""):
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(flat_got) == set(flat_want), what
    for path, w in flat_want.items():
        np.testing.assert_allclose(
            np.asarray(flat_got[path], np.float32), np.asarray(w, np.float32), rtol=rtol, atol=atol,
            err_msg=f"{what} {jax.tree_util.keystr(path)}",
        )


# -- optimizer, schedules, EMA --------------------------------------------------


@pytest.mark.parametrize("decay_tables", [False, True])
def test_adam_update_matches_optax(decay_tables):
    """Two updates of the hand-written Adam (bf16 first moment, decoupled
    weight decay 0.01) against make_optimizer's optax chain: updates and nu
    rtol 1e-5 / atol 1e-8 (f32, the bias correction's pow rounds in numpy
    here and XLA there); mu in bf16 within one bf16 ulp (rtol 2^-7)."""
    jcfg = _jcfg()
    jb = _jax_batch(_host_batches(1)[0])
    params = _seeded_params(JModel(jcfg), jb)
    rng = np.random.default_rng(2)
    grads = [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params) for _ in range(2)]

    jtx = jts.make_optimizer(JTrainConfig(), mu_dtype=jnp.bfloat16, weight_decay=0.01, decay_tables=decay_tables)
    jstate = jtx.init(params)
    cfg = _port_cfg(jcfg)
    tparams = state_dict_from_flax(cfg, params)
    ttx = tts.make_optimizer(TrainConfig(), mu_dtype=torch.bfloat16, weight_decay=0.01, decay_tables=decay_tables)
    tstate = ttx.init(tparams)
    for g in grads:
        jupd, jstate = jtx.update(g, jstate, params)
        tupd, tstate = ttx.update(state_dict_from_flax(cfg, g), tstate, tparams)
        _assert_tree_close(flax_from_state_dict(cfg, tupd), jupd, 1e-5, 1e-8, "updates")
    adam = jstate[0]
    assert tstate.count == int(adam.count) == 2
    assert all(t.dtype == torch.bfloat16 for t in tstate.mu.values())
    _assert_tree_close(flax_from_state_dict(cfg, tstate.nu), adam.nu, 1e-5, 1e-8, "nu")
    _assert_tree_close(flax_from_state_dict(cfg, tstate.mu), adam.mu, 2.0**-7, 0, "mu")
    # the decay mask: matrices only, tables only with decay_tables
    assert ttx.decays("encoder.layer_0.ffn1.weight", tparams["encoder.layer_0.ffn1.weight"])
    assert not ttx.decays("encoder.layer_0.ffn1.bias", tparams["encoder.layer_0.ffn1.bias"])
    assert ttx.decays("embed_items.weight", tparams["embed_items.weight"]) == decay_tables


@pytest.mark.parametrize(
    "name,args",
    [
        ("constant", (1e-3,)),
        ("rsqrt_warmup", (256, 400)),
        ("warmup_constant", (1e-3, 100)),
        ("exponential_decay_to_floor", (1e-3, 1e-5, 50, 0.9)),
    ],
)
def test_schedules_match_jax(name, args):
    """Every schedule at steps 0..1000 against the JAX one (f32, rtol 1e-6)."""
    j, t = getattr(jsched, name)(*args), getattr(schedules, name)(*args)
    for step in (0, 1, 7, 99, 100, 101, 399, 400, 1000):
        np.testing.assert_allclose(t(step), float(j(jnp.int32(step))), rtol=1e-6, err_msg=str(step))
    cfg = TrainConfig(lr_schedule="warmup_constant", warmup_steps=10)
    assert schedules.from_config(cfg, 32)(5) == pytest.approx(float(jsched.from_config(cfg, 32)(5)))


def test_ema_update_matches_jax():
    """The ramped EMA at steps 0 and 500 (f32, rtol 1e-6)."""
    rng = np.random.default_rng(3)
    e, p = ({"a": rng.normal(size=(4, 5)).astype(np.float32)} for _ in range(2))
    for step in (0, 500):
        want = jts.ema_update(e, p, jnp.int32(step), 0.999)
        got = tts.ema_update({"a": torch.from_numpy(e["a"].copy())}, {"a": torch.from_numpy(p["a"])}, step, 0.999)
        np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]), rtol=1e-6)


# -- data --------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_cloze_batches_identical_to_jax(backend):
    """The port's ClozeDataset (copied modules) gives the JAX package's
    train and eval batches bit for bit, from the same sessions and seed."""
    from bert4clickpath_tpu.data import native as jnative
    from bert4clickpath_torch.data import native as tnative

    if backend == "native" and not (jnative.available() and tnative.available()):
        pytest.skip("g++ could not build the native batcher")
    titems, _ = ClickStreamGenerator(n_items=N_ITEMS, session_cohesiveness=200, seed=4).generate_sessions(40)
    jitems, jvocab = _sessions(40, seed=4)
    for a, b in zip(titems, jitems):
        np.testing.assert_array_equal(a, b)
    tvocab = ClickStreamGenerator(n_items=N_ITEMS).item_vocab()
    assert tvocab.tokens == jvocab.tokens
    tds = ClozeDataset(titems, tvocab, max_items=MAX_ITEMS, backend=backend)
    jds = JDataset(jitems, jvocab, max_items=MAX_ITEMS, backend=backend)
    assert tds.backend == jds.backend == backend
    tit, jit_ = tds.train_batches(B, seed=5), jds.train_batches(B, seed=5)
    pairs = [(next(tit), next(jit_)) for _ in range(7)]  # across an epoch boundary
    pairs += list(zip(tds.eval_batches(B), jds.eval_batches(B)))
    for tb, jb in pairs:
        np.testing.assert_array_equal(tb.features["items"], jb.features["items"])
        np.testing.assert_array_equal(tb.head_positions, jb.head_positions)
        np.testing.assert_array_equal(tb.labels, jb.labels)


def test_stacked_batches_move_to_device_unchanged():
    from bert4clickpath_torch.data.cloze import stack_batches

    host = _host_batches(3)
    dev = to_device(stack_batches(host), "cpu")
    assert dev["features"]["items"].shape == (3, B, MAX_ITEMS + 3)
    assert dev["labels"].dtype == torch.int32
    np.testing.assert_array_equal(dev["head_positions"][1].numpy(), host[1].head_positions)


# -- model forward for training ------------------------------------------------


def test_logits_forward_matches_jax():
    """forward's (B, P, V) tied logits vs the JAX model's __call__ (f32,
    rtol 1e-4 / atol 1e-5 through two layers)."""
    jcfg = _jcfg(head=JHead("tied_softmax", output_size=N_ITEMS, tied_bias=True))
    jb = _jax_batch(_host_batches(1)[0])
    jmodel = JModel(jcfg, attn_impl="pallas", embed_impl="pallas")
    params = _seeded_params(jmodel, jb)
    want = np.asarray(jmodel.apply(params, jb["features"], jb["head_positions"]))
    model = _port_model(jcfg, params)
    with torch.no_grad():
        got = model({"items": torch.from_numpy(np.array(jb["features"]["items"]))},
                    torch.from_numpy(np.array(jb["head_positions"])))
    assert got.shape == (B, P, N_ITEMS) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_dropout_draws_from_the_generator():
    """Dropout is live only with a generator; the same seed gives the same
    masks, another seed others; kept values scale by 1 / (1 - rate)."""
    from bert4clickpath_torch.models.encoder import apply_dropout as dropout

    x = torch.ones(200, 50)
    assert dropout(x, 0.1, None) is x
    a = dropout(x, 0.1, torch.Generator().manual_seed(0))
    b = dropout(x, 0.1, torch.Generator().manual_seed(0))
    c = dropout(x, 0.1, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a[a != 0]
    assert torch.allclose(kept, torch.full_like(kept, 1 / 0.9))
    assert 0.87 < kept.numel() / x.numel() < 0.93

    jcfg = _jcfg(dropout_rate=0.1)
    model = _port_model(jcfg, _seeded_params(JModel(jcfg), _jax_batch(_host_batches(1)[0])))
    batch = to_device(_host_batches(1)[0], "cpu")
    with torch.no_grad():
        det = model.gather_head_inputs(batch["features"], batch["head_positions"])
        assert torch.equal(det, model.gather_head_inputs(batch["features"], batch["head_positions"]))
        live = model.gather_head_inputs(batch["features"], batch["head_positions"], torch.Generator().manual_seed(0))
    assert not torch.equal(det, live)


# -- the train step ------------------------------------------------------------


def _jax_grads(jmodel, params, jb, num_valid, fused):
    def loss(p):
        if fused:
            total, count = jts.fused_head_ce_sums(jmodel, p, jb, None, num_valid)
            return total / jnp.maximum(count, 1.0)
        logits = jmodel.apply(p, jb["features"], jb["head_positions"])
        return jts.masked_softmax_cross_entropy(logits, jb["labels"])

    return jax.value_and_grad(loss)(params)


@pytest.mark.parametrize("fused", [True, False])
def test_train_trajectory_matches_jax(fused):
    """5 steps of the port's make_train_step against the JAX one (dropout 0,
    f32 compute, bf16 Adam first moment, constant LR 1e-3), on the fused CE
    path and on the dense-logits path through ``losses``.

    Losses of every step rtol 1e-4, and the step-1 gradients of every
    parameter rtol 1e-3 / atol 1e-6 (f32 sums in another order through two
    layers and the catalog). The params after 5 steps are compared at atol
    2 * lr * steps = 1e-2: Adam with eps 1e-9 turns any gradient that is
    noise on both sides (the key bias's, which the softmax cancels to zero
    in exact arithmetic) into a full +-lr step whose sign is the noise's, so
    only the size of the steps is bounded; every other leaf must agree to
    1e-4."""
    jcfg = _jcfg()
    host = _host_batches(5)
    jbs = [_jax_batch(b) for b in host]
    jmodel = JModel(jcfg, attn_impl="pallas", embed_impl="pallas")
    params = _seeded_params(jmodel, jbs[0])
    num_valid = N_ITEMS if fused else None
    model = _port_model(jcfg, params)

    jloss, jgrads = _jax_grads(jmodel, params, jbs[0], N_ITEMS, fused)
    tloss = tts.make_loss_fn(model, fused_ce_num_valid=num_valid)(to_device(host[0], "cpu"))
    names = [n for n, _ in model.named_parameters()]
    tgrads = torch.autograd.grad(tloss, [p for _, p in model.named_parameters()])
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    _assert_tree_close(flax_from_state_dict(model.config, dict(zip(names, tgrads))), jgrads, 1e-3, 1e-6, "grads")

    jtx = jts.make_optimizer(JTrainConfig(), mu_dtype=jnp.bfloat16)
    jstep = jts.make_train_step(jmodel, jtx, jsched.constant(LR), fused_ce_num_valid=num_valid, donate=False)
    jstate = jts.TrainState.create(params, jtx)
    ttx = tts.make_optimizer(TrainConfig(), mu_dtype=torch.bfloat16)
    tstep = tts.make_train_step(model, ttx, schedules.constant(LR), fused_ce_num_valid=num_valid)
    tstate = tts.TrainState.create(dict(model.named_parameters()), ttx)
    jlosses, tlosses = [], []
    for hb, jb in zip(host, jbs):
        jstate, jl = jstep(jstate, jb, jax.random.PRNGKey(0))
        tstate, tl = tstep(tstate, to_device(hb, "cpu"))
        jlosses.append(float(jl))
        tlosses.append(tl.item())
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tstate.step == 5
    got = flax_from_state_dict(model.config, tstate.params)
    _assert_tree_close(got, jstate.params, 0, 2 * LR * 5, "params")
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in jax.tree_util.tree_flatten_with_path(jstate.params)[0]:
        if "wqkv" in jax.tree_util.keystr(path) and path[-1].key == "bias":
            continue  # the key bias: noise-level gradient, see above
        np.testing.assert_allclose(flat_got[path], np.asarray(w), rtol=0, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize(
    "variant",
    [
        dict(head=JHead("softmax", dense_dims=(48,), output_size=N_ITEMS)),
        dict(positional="learned", head=JHead("tied_softmax", dense_dims=(24,), output_size=N_ITEMS, tied_bias=True)),
        dict(norm_style="pre"),
    ],
    ids=["softmax_head", "tied_bias_transform_learned", "pre_ln"],
)
def test_fused_step_gradients_match_jax_across_heads(variant):
    """The fused-CE loss and every parameter's gradient for the other heads
    and layouts the step takes (the softmax head through
    ``fused_softmax_ce_bias`` over its padded ``Dense(V)`` rows; a tied head
    with a bias, a transform and learned positions, whose gradient reaches
    pos through the gather's VJP; pre-LN), against the JAX step's loss
    (f32, rtol 1e-5; gradients rtol 1e-3 / atol 1e-6)."""
    jcfg = _jcfg(**variant)
    host = _host_batches(1)[0]
    jb = _jax_batch(host)
    jmodel = JModel(jcfg, attn_impl="pallas", embed_impl="pallas")
    params = _seeded_params(jmodel, jb)
    jloss, jgrads = _jax_grads(jmodel, params, jb, N_ITEMS, True)
    model = _port_model(jcfg, params)
    loss = tts.make_loss_fn(model, fused_ce_num_valid=N_ITEMS)(to_device(host, "cpu"))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _assert_tree_close(flax_from_state_dict(model.config, dict(zip(names, grads))), jgrads, 1e-3, 1e-6, "grads")


def test_scan_train_step_equals_k_steps():
    """make_scan_train_step over K=3 stacked batches gives exactly the
    losses and params of 3 calls of make_train_step (dropout 0.1, the same
    generator seed, EMA on): the same operations in the same order."""
    from bert4clickpath_torch.data.cloze import stack_batches

    jcfg = _jcfg(dropout_rate=0.1)
    host = _host_batches(3)
    params = _seeded_params(JModel(jcfg), _jax_batch(host[0]))
    results = []
    for scanned in (False, True):
        model = _port_model(jcfg, params)
        tx = tts.make_optimizer(TrainConfig(), mu_dtype=torch.bfloat16)
        state = tts.TrainState.create(dict(model.named_parameters()), tx, ema=True)
        kw = dict(fused_ce_num_valid=N_ITEMS, ema_decay=0.99)
        gen = torch.Generator().manual_seed(0)
        if scanned:
            multi = tts.make_scan_train_step(model, tx, schedules.constant(LR), **kw)
            state, losses = multi(state, to_device(stack_batches(host), "cpu"), gen)
        else:
            step = tts.make_train_step(model, tx, schedules.constant(LR), **kw)
            losses = []
            for hb in host:
                state, loss = step(state, to_device(hb, "cpu"), gen)
                losses.append(loss)
            losses = torch.stack(losses)
        results.append((losses, state))
    (l1, s1), (l2, s2) = results
    assert l2.shape == (3,) and torch.equal(l1, l2)
    assert s1.step == s2.step == 3
    for name in s1.params:
        assert torch.equal(s1.params[name], s2.params[name]), name
        assert torch.equal(s1.ema_params[name], s2.ema_params[name]), name
        assert torch.equal(s1.opt_state.mu[name], s2.opt_state.mu[name]), name


def test_lr_scale_and_ema_in_the_step():
    """lr_scale 0 freezes the params (the moments still update); the EMA
    shadow moves toward the params with the JAX ramp."""
    jcfg = _jcfg()
    host = _host_batches(1)[0]
    model = _port_model(jcfg, _seeded_params(JModel(jcfg), _jax_batch(host)))
    tx = tts.make_optimizer(TrainConfig())
    state = tts.TrainState.create(dict(model.named_parameters()), tx, ema=True)
    before = {k: p.detach().clone() for k, p in state.params.items()}
    state = state.replace(lr_scale=torch.zeros(()))
    step = tts.make_train_step(model, tx, schedules.constant(LR), fused_ce_num_valid=N_ITEMS, ema_decay=0.999)
    state, _ = step(state, to_device(host, "cpu"))
    for k, p in state.params.items():
        assert torch.equal(p, before[k]), k
    assert state.opt_state.count == 1
    assert any(m.abs().sum() > 0 for m in state.opt_state.mu.values())
    assert tts.eval_params(state) is state.ema_params


def test_flax_round_trip():
    """flax_from_state_dict inverts state_dict_from_flax exactly."""
    jcfg = _jcfg(positional="learned", head=JHead("tied_softmax", dense_dims=(24,), output_size=N_ITEMS, tied_bias=True))
    params = _seeded_params(JModel(jcfg), _jax_batch(_host_batches(1)[0]))
    back = flax_from_state_dict(_port_cfg(jcfg), state_dict_from_flax(_port_cfg(jcfg), params))
    _assert_tree_close(back, params, 0, 0, "round trip")
    with pytest.raises(KeyError, match="not a parameter"):
        flax_from_state_dict(_port_cfg(jcfg), {"mystery.weight": torch.zeros(2)})
    assert dataclasses.is_dataclass(tts.TrainState)
