"""The single-device train step with the program's input pipeline.

``bert4clickpath_torch/training/train_state.py:make_train_step`` with the
fused CE (``fused_ce_num_valid`` = the catalog), Adam and a constant
learning rate, fed by ``ClozeDataset.train_batches`` (the native batcher)
through ``to_device`` and ``prefetch_to_device(depth=2)``, as
``examples/bert4rec/train_torch.py`` wires one device.
"""

from __future__ import annotations

import torch

from bert4clickpath_torch.data.pipeline import ClozeDataset, prefetch_to_device, to_device
from bert4clickpath_torch.models.model import ClickstreamModel
from bert4clickpath_torch.training import schedules
from bert4clickpath_torch.training.train_state import Adam, TrainState, make_train_step
from bert4clickpath_torch.vocab import Vocabulary

from portbench.harness import manifest
from portbench.harness import traffic as traffic_lib
from portbench.entries.program_config import layout, model_config
from portbench.harness.session import Session, views

PREFETCH_DEPTH = 2


def build(cfg: dict, traffic: traffic_lib.Traffic, fill_weights, seeds: dict, device) -> Session:
    t = traffic.params
    vocab = Vocabulary([f"item_{i}" for i in range(cfg["n_items"])])
    if vocab.label_vocab_size != cfg["n_items"]:
        raise ValueError("vocabulary size differs from the configuration's catalog")
    dataset = ClozeDataset(
        traffic.sessions, vocab, max_items=t["max_items"], max_masked=t["max_masked"],
        masked_percentage=t["masked_percentage"], backend=t["batcher"],
    )
    model = ClickstreamModel(model_config(cfg), device=device)
    opt = cfg["optimizer"]
    tx = Adam(opt["b1"], opt["b2"], opt["eps"], mu_dtype=getattr(torch, opt["mu_dtype"]))
    params = dict(model.named_parameters())
    lay = layout(cfg, [n for n, _, _ in manifest.reference(cfg).param_specs(cfg)])
    fill_weights(views(params, lay))
    state = TrainState.create(params, tx)
    step_fn = make_train_step(model, tx, schedules.constant(opt["lr"]), fused_ce_num_valid=cfg["n_items"])
    host = ((b, traffic_lib.batch_stats(_arrays(b))) for b in dataset.train_batches(t["batch"], seed=seeds["batches"]))
    feed = prefetch_to_device(host, lambda pair: (to_device(pair[0], device), pair[1]), depth=PREFETCH_DEPTH)
    generator = torch.Generator(device).manual_seed(seeds["dropout"])
    return Session(model=model, state=state, step_fn=step_fn, generator=generator, device=device, layout=lay,
                   batch_size=t["batch"], feed=feed)


def _arrays(batch) -> dict:
    return {"tokens": batch.features["items"], "positions": batch.head_positions, "labels": batch.labels}
