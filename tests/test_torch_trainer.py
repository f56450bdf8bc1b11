"""The port's trainer, checkpoints and initialisers against the JAX
package's, on the CPU.

The same tiny dataset (the copied generator and Cloze pipeline give the
same batches, numpy backend), the same weights and Adam state
(``train_state_from_flax`` carries the JAX ``TrainState`` across), dropout 0,
f32: ``Trainer.fit`` runs in both packages and the records of
``history.jsonl`` are compared. The JAX fused CE runs its Pallas kernels in
interpret mode, the port its kernels' plain versions. Each test states its
tolerance.
"""

import json
import os

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
from bert4clickpath_tpu.training import train_state as jts
from bert4clickpath_tpu.training.trainer import Trainer as JTrainer
from bert4clickpath_torch.config import ModelConfig, TrainConfig
from bert4clickpath_torch.convert import flax_from_state_dict, train_state_from_flax
from bert4clickpath_torch.data.cloze import stack_batches
from bert4clickpath_torch.data.generator import ClickStreamGenerator
from bert4clickpath_torch.data.pipeline import ClozeDataset, to_device
from bert4clickpath_torch.models.model import ClickstreamModel, init_state_dict
from bert4clickpath_torch.ops.fused_ce import padded_rows
from bert4clickpath_torch.training import checkpoint as tckpt
from bert4clickpath_torch.training import train_state as tts
from bert4clickpath_torch.training.trainer import Trainer

torch.set_num_threads(1)

N_ITEMS, D, B, MAX_ITEMS = 117, 16, 16, 13
LR, LIVE_STEPS = 1e-2, 8  # the schedule is LR for 8 steps (2 epochs), then 0


def _jcfg(head_kind="tied_softmax", **kw):
    if head_kind == "tied_softmax":
        rows, head = padded_rows(N_ITEMS + 11), JHead("tied_softmax", output_size=N_ITEMS)
    else:
        rows, head = N_ITEMS + 11, JHead("softmax", (24,), N_ITEMS)
    base = dict(features={"items": JFeature(rows, D)}, num_layers=1, num_heads=2, ffn_dim=32, dropout_rate=0.0,
                max_len=MAX_ITEMS + 3, head=head, qkv_fused=True)
    base.update(kw)
    return JModelConfig(**base)


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig.from_json(jcfg.to_json())


def _datasets(n=96):
    jgen = JGenerator(n_items=N_ITEMS, session_cohesiveness=200, seed=0)
    tgen = ClickStreamGenerator(n_items=N_ITEMS, session_cohesiveness=200, seed=0)
    jds = JDataset(jgen.generate_sessions(n)[0], jgen.item_vocab(), max_items=MAX_ITEMS, backend="numpy")
    tds = ClozeDataset(tgen.generate_sessions(n)[0], tgen.item_vocab(), max_items=MAX_ITEMS, backend="numpy")
    return jds, tds


def _jax_batch(b):
    return {
        "features": {k: jnp.asarray(v) for k, v in b.features.items()},
        "head_positions": jnp.asarray(b.head_positions),
        "labels": jnp.asarray(b.labels),
    }


def _jax_state(jmodel, jds, tcfg, mu_dtype=None, ema=False):
    b0 = _jax_batch(next(jds.train_batches(B, seed=0)))
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, b0["features"], b0["head_positions"])
    tx = jts.make_optimizer(tcfg, mu_dtype=mu_dtype)
    return tx, jts.TrainState.create(params, tx, ema=ema)


def _read_history(path):
    with open(os.path.join(path, "history.jsonl")) as f:
        return [json.loads(line) for line in f]


# -- Trainer.fit --------------------------------------------------------------


def test_trainer_history_matches_jax(tmp_path):
    """Six epochs of four steps, plateau_patience=1, early stop after two
    epochs without a better val_loss. The schedule is LR for the first two
    epochs and 0 afterwards, so from the third epoch on val_loss stands
    still in both packages: a plateau cut at epochs 2 and 3, an early stop at
    epoch 3. train_loss, val_loss, lr, lr_scale within 1e-4 (f32, sums in
    another order, 8 Adam steps apart); recall and NDCG within one hit of
    the 32 evaluated positions (equal unless a near tie decides)."""
    jcfg = _jcfg()
    jds, tds = _datasets()
    kw = dict(batch_size=B, steps_per_epoch=4, n_epochs=6, plateau_patience=1, plateau_factor=0.5,
              early_stopping_patience=2, monitor="val_loss", monitor_mode="min", ckpt_keep=1)
    jmodel = JModel(jcfg)
    jtx, jstate = _jax_state(jmodel, jds, JTrainConfig(**kw))
    model = ClickstreamModel(_port_cfg(jcfg), device="cpu")
    tstate = train_state_from_flax(model, jax.device_get(jstate))
    ttx = tts.make_optimizer(TrainConfig(**kw))

    jsched = lambda step: jnp.where(step < LIVE_STEPS, LR, 0.0).astype(jnp.float32)  # noqa: E731
    tsched = lambda step: float(np.float32(LR)) if step < LIVE_STEPS else 0.0  # noqa: E731
    jtrainer = JTrainer(
        jts.make_train_step(jmodel, jtx, jsched, fused_ce_num_valid=N_ITEMS, donate=False),
        jts.make_eval_step(jmodel, chunked_num_valid=N_ITEMS),
        JTrainConfig(**kw), model_dir=str(tmp_path / "jax"), to_device=_jax_batch, lr_fn=jsched,
    )
    jtrainer.fit(jstate, jds.train_batches(B, seed=1), lambda: jds.eval_batches(B, limit_batches=2),
                 jax.random.PRNGKey(2))
    exported = []
    ttrainer = Trainer(
        tts.make_train_step(model, ttx, tsched, fused_ce_num_valid=N_ITEMS),
        tts.make_eval_step(model, chunked_num_valid=N_ITEMS),
        TrainConfig(**kw), model_dir=str(tmp_path / "torch"), to_device=lambda b: to_device(b, "cpu"),
        lr_fn=tsched, export_fn=lambda params: exported.append(len(params)),
    )
    tstate = ttrainer.fit(tstate, tds.train_batches(B, seed=1), lambda: tds.eval_batches(B, limit_batches=2), None)

    want, got = _read_history(tmp_path / "jax"), _read_history(tmp_path / "torch")
    assert got == ttrainer.history
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert len(got) == 5 and got[-1] == {"epoch": 3, "early_stop": True}
    assert [r["lr_scale"] for r in got[:4]] == [1.0, 1.0, 1.0, 0.5]
    assert float(tstate.lr_scale) == 0.25 and tstate.step == 16
    for g, w in zip(got[:4], want[:4]):
        assert (g["epoch"], g["step"]) == (w["epoch"], w["step"])
        for key in ("train_loss", "val_loss", "lr", "lr_scale"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=1e-6, err_msg=f"{key} epoch {g['epoch']}")
        for key in ("val_recall@5", "val_recall@10", "val_ndcg@5", "val_ndcg@10"):
            assert abs(g[key] - w[key]) <= 1.0 / 32 + 1e-6, (key, g, w)
        assert g["epoch_seconds"] >= 0 and g["eval_seconds"] >= 0
    assert got[1]["val_loss"] < got[0]["val_loss"]  # it trained while LR was live
    # epochs 0 and 1 improved: two saves, the older one pruned after the newer landed
    assert os.listdir(tmp_path / "torch" / "ckpts") == ["step_00000008"]
    assert exported == [len(tstate.params)] * 2
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(tmp_path / "torch" / "tensorboard"))


def test_trainer_steps_per_call_and_eval_every(tmp_path):
    """A scan step over stacked chunks gives the same train losses as one
    step per call (identical arithmetic: exact), eval_every=2 evaluates
    epochs 0, 2 and the last, and the trainer refuses chunks that do not
    divide an epoch."""
    jds, tds = _datasets()
    cfg = _port_cfg(_jcfg())
    tcfg = TrainConfig(batch_size=B, steps_per_epoch=4, n_epochs=4, eval_every=2, monitor="val_loss",
                       monitor_mode="min")
    histories = []
    for spc in (1, 2):
        model = ClickstreamModel(cfg, device="cpu")
        model.load_state_dict(init_state_dict(cfg, 3))
        tx = tts.make_optimizer(tcfg)
        make = tts.make_scan_train_step if spc > 1 else tts.make_train_step
        trainer = Trainer(
            make(model, tx, lambda step: LR, fused_ce_num_valid=N_ITEMS),
            tts.make_eval_step(model, chunked_num_valid=N_ITEMS, steps_per_call=spc), tcfg,
            to_device=lambda b: to_device(b, "cpu"), steps_per_call=spc, eval_steps_per_call=spc,
            stack_batches=stack_batches if spc > 1 else None, tensorboard=False,
        )
        trainer.fit(tts.TrainState.create(dict(model.named_parameters()), tx), tds.train_batches(B, seed=1),
                    lambda: tds.eval_batches(B, limit_batches=3), None)
        histories.append(trainer.history)
    one, two = histories
    assert [r["train_loss"] for r in one] == [r["train_loss"] for r in two]
    assert ["val_loss" in r for r in one] == [True, False, True, True]
    assert [r.get("val_loss") for r in one] == [r.get("val_loss") for r in two]
    with pytest.raises(ValueError, match="not a multiple"):
        Trainer(None, None, tcfg, steps_per_call=3, stack_batches=stack_batches)
    with pytest.raises(ValueError, match="requires stack_batches"):
        Trainer(None, None, tcfg, steps_per_call=2)


# -- checkpoints ------------------------------------------------------------------


def _port_run(head_kind="tied_softmax", seed=3, ema=False, mu_dtype=None):
    cfg = _port_cfg(_jcfg(head_kind))
    model = ClickstreamModel(cfg, device="cpu")
    model.load_state_dict(init_state_dict(cfg, seed))
    tx = tts.make_optimizer(TrainConfig(), mu_dtype=mu_dtype)
    state = tts.TrainState.create(dict(model.named_parameters()), tx, ema=ema)
    fused = N_ITEMS if head_kind == "tied_softmax" else None
    step = tts.make_train_step(model, tx, lambda s: LR, fused_ce_num_valid=fused, ema_decay=0.9 if ema else 0.0)
    return model, state, step


def test_checkpoint_resume_gives_the_same_next_losses(tmp_path):
    """Save after 3 steps, restore into a fresh run: parameters, both Adam
    moments (the first in bf16), Adam's count, step, lr_scale and the EMA
    come back bit for bit, and the next 2 losses equal the uninterrupted
    run's exactly."""
    _, tds = _datasets()
    it = tds.train_batches(B, seed=1)
    batches = [to_device(next(it), "cpu") for _ in range(5)]
    _, state, step = _port_run(ema=True, mu_dtype=torch.bfloat16)
    for b in batches[:3]:
        state, _ = step(state, b)
    state = state.replace(lr_scale=state.lr_scale * 0.5)
    path = tckpt.save_checkpoint(str(tmp_path / "ckpts"), state, state.step)
    assert path.endswith("step_00000003") and tckpt.latest_checkpoint(str(tmp_path / "ckpts")) == path
    saved = {k: v.clone() for k, v in state.params.items()}
    want = []
    for b in batches[3:]:
        state, loss = step(state, b)
        want.append(loss.item())

    _, fresh, step2 = _port_run(seed=9, ema=True, mu_dtype=torch.bfloat16)
    restored = tckpt.restore_state(path, fresh)
    assert restored.step == 3 and restored.opt_state.count == 3 and float(restored.lr_scale) == 0.5
    assert restored.params is fresh.params  # the model's own tensors, filled in place
    assert all(torch.equal(restored.params[k], saved[k]) for k in saved)
    assert all(m.dtype == torch.bfloat16 for m in restored.opt_state.mu.values())
    got = []
    for b in batches[3:]:
        restored, loss = step2(restored, b)
        got.append(loss.item())
    assert got == want
    for k in state.params:
        assert torch.equal(restored.opt_state.mu[k], state.opt_state.mu[k])
        assert torch.equal(restored.opt_state.nu[k], state.opt_state.nu[k])
        assert torch.equal(restored.ema_params[k], state.ema_params[k])
    _, no_ema, _ = _port_run()
    with pytest.raises(ValueError, match="EMA setting"):
        tckpt.restore_state(path, no_ema)
    assert tckpt.latest_checkpoint(str(tmp_path / "nowhere")) is None


def test_keep_prunes_only_after_the_commit(tmp_path, monkeypatch):
    """keep=2: a save that fails leaves both earlier checkpoints and no
    half-written directory; the next good save prunes the oldest."""
    _, state, _ = _port_run()
    directory = str(tmp_path / "ckpts")
    for s in (1, 2):
        tckpt.save_checkpoint(directory, state, s, keep=2)
    real_save = torch.save

    def failing(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", failing)
    with pytest.raises(OSError, match="disk full"):
        tckpt.save_checkpoint(directory, state, 3, keep=2)
    assert sorted(os.listdir(directory)) == ["step_00000001", "step_00000002"]
    monkeypatch.setattr(torch, "save", real_save)
    tckpt.save_checkpoint(directory, state, 3, keep=2)
    assert sorted(os.listdir(directory)) == ["step_00000002", "step_00000003"]
    tckpt.save_checkpoint(directory, state, 3, keep=2)  # the same step again replaces it
    assert sorted(os.listdir(directory)) == ["step_00000002", "step_00000003"]
    tckpt.save_checkpoint(directory, state, 4)  # keep None: everything stays
    assert len(os.listdir(directory)) == 3
    assert [os.path.basename(p) for p in tckpt.prune_checkpoints(directory, 1)] == ["step_00000002", "step_00000003"]
    tckpt.wait_until_finished()


def test_same_step_saved_again_never_lacks_a_checkpoint(tmp_path, monkeypatch):
    """keep=1 and the same step saved twice: the old checkpoint steps aside
    and is deleted only after the new one is committed, so a commit that
    fails leaves the old one in place and restorable."""
    _, state, _ = _port_run()
    directory = str(tmp_path / "ckpts")
    path = tckpt.save_checkpoint(directory, state, 5, keep=1)
    real_rename, seen = os.rename, []

    def rename(src, dst):
        seen.append((os.path.basename(src), os.path.basename(dst), sorted(os.listdir(directory))))
        if ".tmp-" in src:
            raise OSError("commit failed")
        real_rename(src, dst)

    monkeypatch.setattr(os, "rename", rename)
    with pytest.raises(OSError, match="commit failed"):
        tckpt.save_checkpoint(directory, state, 5, keep=1)
    monkeypatch.setattr(os, "rename", real_rename)
    # the old one moved aside first, with the new one complete beside it
    assert seen[0][0] == "step_00000005" and seen[0][1].startswith("step_00000005.old-")
    assert any(name.startswith("step_00000005.tmp-") for name in seen[0][2])
    assert os.listdir(directory) == ["step_00000005"] and tckpt.latest_checkpoint(directory) == path
    assert int(tckpt.restore_state(path, state).step) == int(state.step)
    tckpt.save_checkpoint(directory, state, 5, keep=1)
    assert os.listdir(directory) == ["step_00000005"]


def test_restore_encoder_keeps_the_new_head(tmp_path):
    """Transfer learning: encoder, embeddings and positions come from the
    file (here a tied-head run's params), the MLP head stays as freshly
    initialised; restore_params insists on the same names."""
    cfg_a = _port_cfg(_jcfg("tied_softmax", features={"items": JFeature(N_ITEMS + 11, D)}, positional="learned"))
    cfg_b = _port_cfg(_jcfg("softmax", positional="learned"))
    a, b = init_state_dict(cfg_a, 1), init_state_dict(cfg_b, 2)
    path = str(tmp_path / "pretrained" / "params.pt")
    tckpt.save_params(path, a)
    out = tckpt.restore_encoder(path, b)
    assert set(out) == set(b)
    for key in b:
        if tckpt.is_transferred(key):
            assert torch.equal(out[key], a[key]), key
        else:
            assert key.startswith("head.") and out[key] is b[key]
    assert any(k.startswith("positions.") for k in b) and any(k.startswith("head.") for k in b)
    back = tckpt.restore_params(path, a)
    assert all(torch.equal(back[k], a[k]) for k in a)
    assert tckpt.restore_params(str(tmp_path / "pretrained"), a).keys() == a.keys()  # a bundle's directory
    with pytest.raises(KeyError, match="do not match"):
        tckpt.restore_params(path, b)


# -- carrying a JAX TrainState across, and fresh weights ---------------------------


def test_train_state_from_flax_carries_everything():
    jcfg = _jcfg()
    jds, _ = _datasets()
    jmodel = JModel(jcfg)
    tcfg = JTrainConfig(batch_size=B)
    jtx, jstate = _jax_state(jmodel, jds, tcfg, mu_dtype=jnp.bfloat16, ema=True)
    step = jts.make_train_step(jmodel, jtx, lambda s: LR, fused_ce_num_valid=N_ITEMS, ema_decay=0.9, donate=False)
    it = jds.train_batches(B, seed=1)
    for _ in range(2):
        jstate, _ = step(jstate, _jax_batch(next(it)), jax.random.PRNGKey(0))
    jstate = jstate.replace(lr_scale=jstate.lr_scale * 0.317)
    host = jax.device_get(jstate)
    model = ClickstreamModel(_port_cfg(jcfg), device="cpu")
    state = train_state_from_flax(model, host)
    assert state.step == 2 and state.opt_state.count == 2
    np.testing.assert_allclose(float(state.lr_scale), 0.317, rtol=1e-6)
    assert all(state.params[k] is p for k, p in model.named_parameters())
    assert all(m.dtype == torch.bfloat16 for m in state.opt_state.mu.values())
    adam = host.opt_state[0]
    for tree, want in ((state.params, host.params), (state.opt_state.mu, adam.mu), (state.opt_state.nu, adam.nu),
                       (state.ema_params, host.ema_params)):
        got = flax_from_state_dict(model.config, tree)
        flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
        for path, g in jax.tree_util.tree_flatten_with_path(got)[0]:
            np.testing.assert_array_equal(g, np.asarray(flat_w[path], np.float32))  # exact, bf16 included


@pytest.mark.parametrize("head_kind", ["tied_softmax", "softmax"])
def test_init_state_dict_draws_like_flax_init(head_kind):
    """A run from scratch starts from the distributions ``ClickstreamModel.
    init`` draws from (the bits differ, so the comparison is statistical).
    Per parameter: biases 0, LayerNorm scales 1, Dense weights inside the
    truncation at two standard deviations, and the standard deviation of
    both packages' draws within 5 sigma of the initialiser's own (1 /
    sqrt(fan_in) for a Dense weight, 1 / sqrt(dim) for a table, 0.02 for
    positions; an estimate from n values has a relative error of about
    1 / sqrt(2 n)). The initial loss, averaged over 4 seeds in each package
    (a single draw's loss has a standard deviation of ~0.09-0.15 here, the
    difference of two 4-seed means ~0.09): within 0.35."""
    jcfg = _jcfg(head_kind, positional="learned", head=JHead("tied_softmax", (24,), N_ITEMS, tied_bias=True)
                 if head_kind == "tied_softmax" else JHead("softmax", (24,), N_ITEMS))
    jds, _ = _datasets()
    jmodel = JModel(jcfg)
    b = next(jds.train_batches(B, seed=0))
    jb = _jax_batch(b)
    cfg = _port_cfg(jcfg)
    sd = init_state_dict(cfg, 0)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in ClickstreamModel(cfg, device="meta").state_dict().items()}
    assert all(torch.equal(sd[k], v) for k, v in init_state_dict(cfg, 0).items())  # seeded

    def flat(tree):
        return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    jlosses, tlosses = [], []
    for seed in range(4):
        jparams = jmodel.init({"params": jax.random.PRNGKey(seed)}, jb["features"], jb["head_positions"])
        sd = init_state_dict(cfg, seed)
        flat_j, flat_t = flat(jparams), flat(flax_from_state_dict(cfg, sd))
        assert set(flat_t) == set(flat_j)
        for key, w in flat_j.items():
            g = flat_t[key]
            if key.endswith("['bias']") or key.endswith("['tied_out_bias']"):
                assert not g.any() and not w.any(), key
            elif key.endswith("['scale']"):
                assert (g == 1).all() and (w == 1).all(), key
            else:
                if "positions" in key:
                    std = 0.02
                elif key.endswith("['kernel']"):
                    std = 1.0 / np.sqrt(g.shape[0])
                    cut = 2.0 * std / 0.87962566103423978
                    assert np.abs(g).max() <= cut + 1e-6 and np.abs(w).max() <= cut + 1e-6, key
                else:
                    std = 1.0 / np.sqrt(g.shape[1])
                tol = 5.0 / np.sqrt(2.0 * g.size)
                assert abs(g.std() / std - 1.0) < tol and abs(w.std() / std - 1.0) < tol, (key, g.std(), w.std(), std)
        model = ClickstreamModel(cfg, device="cpu")
        model.load_state_dict(sd)
        tlosses.append(tts.make_loss_fn(model)(to_device(b, "cpu")).item())
        jlosses.append(float(jts.loss_for_head(head_kind)(
            jmodel.apply(jparams, jb["features"], jb["head_positions"], deterministic=True), jb["labels"])))
    assert abs(np.mean(tlosses) - np.mean(jlosses)) < 0.35, (tlosses, jlosses)
