"""Sampled softmax in the port against the JAX package, on the CPU.

The loss (``ops/losses.py:sampled_softmax_ce``) is held against the JAX
function given the same negatives: the JAX function draws them from its
key with ``jax.random.randint``, and the test draws the same ones from the
same key and hands them to the port (the port's sampler cannot match
``jax.random``'s bits). The train step is held over a 5-step trajectory
against JAX's ``make_train_step(sampled_softmax_samples=)``, whose
negatives at step t come from ``fold_in(fold_in(key, t), 1)``: the test
recomputes them and passes them to the port's step. f32, dropout 0; the
sizes of ``tests/test_torch_train.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert4clickpath_tpu.config import TrainConfig as JTrainConfig
from bert4clickpath_tpu.models.model import ClickstreamModel as JModel
from bert4clickpath_tpu.ops import losses as jlosses
from bert4clickpath_tpu.training import schedules as jsched
from bert4clickpath_tpu.training import train_state as jts
from bert4clickpath_torch.config import TrainConfig
from bert4clickpath_torch.constants import LABEL_PAD
from bert4clickpath_torch.convert import flax_from_state_dict
from bert4clickpath_torch.data.pipeline import to_device
from bert4clickpath_torch.ops import losses as tlosses
from bert4clickpath_torch.training import schedules
from bert4clickpath_torch.training import train_state as tts

from test_torch_cli import _history, _run
from test_torch_train import LR, N_ITEMS, _assert_tree_close, _host_batches, _jax_batch, _jcfg, _port_model, _seeded_params

torch.set_num_threads(1)

S = 16  # negatives a step


def _loss_inputs(seed=0, n=24, v=64, d=8, off=3, nv=50):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    table = rng.normal(scale=0.5, size=(v, d)).astype(np.float32)
    bias = rng.normal(scale=0.3, size=(v,)).astype(np.float32)
    labels = rng.integers(0, nv, size=(n,)).astype(np.int32)
    labels[::5] = LABEL_PAD
    weights = rng.normal(size=(n,)).astype(np.float32)
    return x, table, bias, labels, weights, off, nv


@pytest.mark.parametrize("with_bias", [False, True])
def test_sampled_softmax_matches_jax(with_bias):
    """nll and the gradients of x, table and bias within 1e-5 of the JAX
    function's, with its negatives (some of which hit a row's own label:
    S = 16 of 50 valid rows over 24 rows)."""
    x, table, bias, labels, w, off, nv = _loss_inputs()
    key = jax.random.PRNGKey(3)
    neg = np.array(jax.random.randint(key, (S,), 0, nv))
    assert np.isin(labels, neg).any()  # accidental hits are exercised

    def jloss(x, table, bias):
        nll = jlosses.sampled_softmax_ce(x, table, labels, off, nv, S, key, bias=bias if with_bias else None)
        return jnp.sum(nll * w), nll

    (_, jnll), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(x, table, bias)
    tx, tt, tb = (torch.tensor(a, requires_grad=True) for a in (x, table, bias))
    tnll = tlosses.sampled_softmax_ce(
        tx, tt, torch.from_numpy(labels), off, nv, torch.from_numpy(neg), bias=tb if with_bias else None
    )
    (tnll * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tnll.detach().numpy(), np.asarray(jnll), rtol=1e-5, atol=1e-5)
    assert float(tnll.detach()[labels == LABEL_PAD].abs().max()) == 0.0
    for got, want in zip((tx.grad, tt.grad, tb.grad if with_bias else None), jgrads):
        if got is None:
            continue
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_sample_negatives_draws_from_the_generator():
    """The sampler's draws: in [0, num_valid), from the generator alone
    (the same seed, the same negatives), int64 on the generator's device."""
    a = tlosses.sample_negatives(50, 1000, torch.Generator().manual_seed(4))
    b = tlosses.sample_negatives(50, 1000, torch.Generator().manual_seed(4))
    assert a.dtype == torch.int64 and a.shape == (1000,)
    assert torch.equal(a, b) and int(a.min()) >= 0 and int(a.max()) < 50
    assert len(torch.unique(a)) == 50


def test_sampled_train_trajectory_matches_jax():
    """5 steps of the port's sampled make_train_step against JAX's
    make_train_step(sampled_softmax_samples=16) with the same negatives:
    losses rtol 1e-4, params after 5 steps at the tolerances of
    tests/test_torch_train.py's trajectory (the key bias excepted: its
    gradient is noise on both sides)."""
    jcfg = _jcfg()
    host = _host_batches(5)
    jbs = [_jax_batch(b) for b in host]
    jmodel = JModel(jcfg, attn_impl="pallas", embed_impl="pallas")
    params = _seeded_params(jmodel, jbs[0])
    model = _port_model(jcfg, params)
    jtx = jts.make_optimizer(JTrainConfig(), mu_dtype=jnp.bfloat16)
    jstep = jts.make_train_step(
        jmodel, jtx, jsched.constant(LR), fused_ce_num_valid=N_ITEMS, sampled_softmax_samples=S, donate=False
    )
    jstate = jts.TrainState.create(params, jtx)
    ttx = tts.make_optimizer(TrainConfig(), mu_dtype=torch.bfloat16)
    tstep = tts.make_train_step(
        model, ttx, schedules.constant(LR), fused_ce_num_valid=N_ITEMS, sampled_softmax_samples=S
    )
    tstate = tts.TrainState.create(dict(model.named_parameters()), ttx)
    key = jax.random.PRNGKey(0)
    jlosses_, tlosses_ = [], []
    for t, (hb, jb) in enumerate(zip(host, jbs)):
        # the JAX step's negatives: fold_in(fold_in(key, step), 1)
        neg = jax.random.randint(jax.random.fold_in(jax.random.fold_in(key, t), 1), (S,), 0, N_ITEMS)
        jstate, jl = jstep(jstate, jb, key)
        tstate, tl = tstep(tstate, to_device(hb, "cpu"), None, torch.from_numpy(np.asarray(neg)))
        jlosses_.append(float(jl))
        tlosses_.append(tl.item())
    np.testing.assert_allclose(tlosses_, jlosses_, rtol=1e-4)
    got = flax_from_state_dict(model.config, tstate.params)
    _assert_tree_close(got, jstate.params, 0, 2 * LR * 5, "params")
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in jax.tree_util.tree_flatten_with_path(jstate.params)[0]:
        if "wqkv" in jax.tree_util.keystr(path) and path[-1].key == "bias":
            continue
        np.testing.assert_allclose(flat_got[path], np.asarray(w), rtol=0, atol=1e-4, err_msg=jax.tree_util.keystr(path))


def test_sampled_step_draws_its_negatives_and_touches_few_rows():
    """Without negatives the step draws S from its generator (two steps
    built on equal generators agree, and equal the loss on those negatives
    passed in); the loss's gradient reaches only the labels' and the
    negatives' table rows."""
    jcfg = _jcfg()
    host = _host_batches(1)
    jmodel = JModel(jcfg)
    params = _seeded_params(jmodel, _jax_batch(host[0]))
    batch = to_device(host[0], "cpu")
    losses = []
    for _ in range(2):
        model = _port_model(jcfg, params)
        tx = tts.make_optimizer(TrainConfig())
        step = tts.make_train_step(
            model, tx, schedules.constant(LR), fused_ce_num_valid=N_ITEMS, sampled_softmax_samples=S,
            negatives_generator=torch.Generator().manual_seed(9),
        )
        _, loss = step(tts.TrainState.create(dict(model.named_parameters()), tx), batch)
        losses.append(loss.item())
    assert losses[0] == losses[1]
    model = _port_model(jcfg, params)
    neg = tlosses.sample_negatives(N_ITEMS, S, torch.Generator().manual_seed(9))
    loss = tts.make_loss_fn(model, fused_ce_num_valid=N_ITEMS)(batch, None, neg)
    assert loss.item() == losses[0]
    x, table, _, labels, _, off, nv = _loss_inputs()
    table = torch.tensor(table, requires_grad=True)
    neg = tlosses.sample_negatives(nv, S, torch.Generator().manual_seed(9))
    nll = tlosses.sampled_softmax_ce(torch.from_numpy(x), table, torch.from_numpy(labels), off, nv, neg)
    (g,) = torch.autograd.grad(nll.sum(), [table])
    touched = set(torch.nonzero(g.abs().sum(dim=1)).reshape(-1).tolist())
    allowed = {int(v) + off for v in labels[labels != LABEL_PAD]} | {int(v) + off for v in neg}
    assert touched and touched <= allowed


@pytest.mark.parametrize("kw,message", [
    (dict(sampled_softmax_samples=S), "requires fused_ce_num_valid"),
    (dict(sampled_softmax_samples=0, fused_ce_num_valid=N_ITEMS), "must be positive"),
])
def test_sampled_step_refuses_what_jax_refuses(kw, message):
    model = _port_model(_jcfg(), _seeded_params(JModel(_jcfg()), _jax_batch(_host_batches(1)[0])))
    with pytest.raises(ValueError, match=message):
        tts.make_train_step(model, tts.make_optimizer(TrainConfig()), schedules.constant(LR), **kw)


def test_cli_trains_with_sampled_softmax(tmp_path):
    """``train_torch.py --sampled_softmax 16 --device cpu`` trains the tied
    preset (finite falling loss) and evaluates on the exact catalog scan."""
    out = _run(tmp_path / "run", "--preset", "tpu", "--d_model", "32", "--layers", "1", "--heads", "2",
               "--epochs", "2", "--sampled_softmax", "16", "--lr", "3e-3")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "sampled softmax: 16 negatives a step" in out.stdout
    assert "JAX_SIDE_MODULES []" in out.stdout
    hist = _history(tmp_path / "run")
    assert len(hist) == 2 and all(np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"]) for h in hist)
    assert hist[1]["train_loss"] < hist[0]["train_loss"]
    assert os.path.exists(tmp_path / "run" / "export")
