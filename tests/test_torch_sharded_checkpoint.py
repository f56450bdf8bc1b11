"""Checkpoints of a sharded state (the counterpart of
``tests/test_parallel.py::test_spmd_checkpoint_resume_matches_uninterrupted``).

The route is the JAX package's: the shards gathered to a full state on the
host (``spmd.gather_state`` with the tier's specs), saved by rank 0
(``training/checkpoint.py:save_checkpoint``), restored into a full state on
every rank (``restore_state``) and cut again by the tier's shard function
(``spmd.save_sharded_checkpoint`` / ``spmd.restore_sharded_state``; driven
by ``parallel/drive.py``'s ``resume_after``). A (2, 2) gloo world runs each
tier for 4 steps uninterrupted and with a checkpoint, a restore onto a
freshly built model and a re-shard after 2; the state carries Adam's count,
``step``, ``lr_scale``, a bf16 first moment and the EMA.

Tolerance: the resumed losses within 1e-6 relative of the uninterrupted
run's (the JAX test's bound); on the CPU's plain path every parameter, the
first moment and the EMA are expected bit-equal, and are held so.
"""

import numpy as np
import pytest
import torch

from bert4clickpath_torch.config import FeatureConfig, HeadConfig, ModelConfig
from bert4clickpath_torch.data.generator import ClickStreamGenerator
from bert4clickpath_torch.data.pipeline import ClozeDataset
from bert4clickpath_torch.data.synthetic import seeded_state_dict
from bert4clickpath_torch.parallel.mesh import spawn
from bert4clickpath_torch.parallel.spmd import padded_vocab_rows

import torch_parallel_workers as workers

torch.set_num_threads(1)

STEPS, RESUME_AFTER = 4, 2
TIERS = ("spmd", "tp_spmd")


def _job(tier: str, resume: bool, ckpt_dir: str) -> dict:
    gen = ClickStreamGenerator(n_items=22, session_cohesiveness=200, seed=0)
    items, _ = gen.generate_sessions(64)
    vocab = gen.item_vocab()
    ds = ClozeDataset(items, vocab, max_items=20, backend="numpy")
    it = ds.train_batches(8, seed=0)
    batches = [next(it) for _ in range(STEPS)]
    cfg = ModelConfig(
        features={"items": FeatureConfig(padded_vocab_rows(vocab.model_vocab_size, 2), 16)},
        num_layers=1, num_heads=2, ffn_dim=32, max_len=23, dropout_rate=0.0,
        head=HeadConfig("tied_softmax", tied_bias=True),
    )
    state = {k: v.numpy() for k, v in seeded_state_dict(cfg, 3).items()}
    job = dict(kind="tier", tier=tier, config=cfg.to_json(), state=state, mesh=(2, 2), device="cpu",
               batches=[{"features": dict(b.features), "head_positions": b.head_positions, "labels": b.labels}
                        for b in batches],
               eval_batches=[], num_valid=vocab.label_vocab_size, lr=1e-2, ema_decay=0.9, mu_dtype="bfloat16")
    if resume:
        job.update(resume_after=RESUME_AFTER, checkpoint_dir=ckpt_dir)
    return job


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    ckpts = str(tmp_path_factory.mktemp("ckpts"))
    names = [(tier, resume) for tier in TIERS for resume in (False, True)]
    jobs = [_job(tier, resume, f"{ckpts}/{tier}") for tier, resume in names]
    store = str(tmp_path_factory.mktemp("world") / "store")
    ranks = spawn(workers.run_jobs, 4, store, (jobs,))
    return {name: [r[i] for r in ranks] for i, name in enumerate(names)}, ckpts


@pytest.mark.parametrize("tier", TIERS)
def test_resumed_run_equals_uninterrupted(tier, world):
    """Every rank: the restored, re-sharded state bit-equal to the state
    that was saved (every parameter, moment and EMA tensor, step, count,
    lr_scale); the losses within 1e-6 relative, the gathered parameters,
    Adam's first moment and the EMA after the last step bit-equal, the
    step and Adam's count carried across the restore."""
    runs, _ = world
    for whole, resumed in zip(runs[(tier, False)], runs[(tier, True)]):
        assert resumed["restore_apart"] == [] and whole["restore_apart"] is None
        np.testing.assert_allclose(resumed["losses"], whole["losses"], rtol=1e-6, atol=0)
        for what in ("params", "mu", "ema"):
            for k, t in whole[what].items():
                np.testing.assert_array_equal(resumed[what][k], t, err_msg=f"{tier} {what} {k}")
        assert resumed["step"] == whole["step"] == STEPS
        assert resumed["count"] == whole["count"] == STEPS


@pytest.mark.parametrize("tier", TIERS)
def test_checkpoint_is_a_full_state(tier, world):
    """The checkpoint rank 0 wrote is the full single-device state after
    RESUME_AFTER steps: the whole padded table (not a shard), the unsliced
    TP matrices, the bf16 first moment, the EMA, step and count."""
    from bert4clickpath_torch.training.checkpoint import STATE_FILE, latest_checkpoint

    _, ckpts = world
    path = latest_checkpoint(f"{ckpts}/{tier}")
    assert path is not None and path.endswith(f"{RESUME_AFTER:08d}")
    saved = torch.load(f"{path}/{STATE_FILE}", map_location="cpu", weights_only=True)
    cfg = ModelConfig.from_json(_job(tier, False, "")["config"])
    full = seeded_state_dict(cfg, 3)
    assert {k: tuple(v.shape) for k, v in saved["params"].items()} == {k: tuple(v.shape) for k, v in full.items()}
    assert all(v.dtype == torch.bfloat16 for v in saved["opt_state"]["mu"].values())
    assert saved["ema_params"] is not None and set(saved["ema_params"]) == set(full)
    assert saved["step"] == saved["opt_state"]["count"] == RESUME_AFTER
