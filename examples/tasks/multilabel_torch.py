"""Multi-label multi-class example of the PyTorch port: session -> classes of
the held-out tail.

Counterpart of ``examples/tasks/multilabel.py``: the [CLS] summary
(``routing='segment'`` on segment 0) feeds a C-way independent-sigmoid
head trained with the masked multilabel BCE, evaluated with the streaming
binary counts pooled over the classes.

Synthetic task: items belong to ``n_classes`` interest classes (item mod
C); the model sees the session WITHOUT its last ``held_out`` items and
predicts the multi-hot set of classes those hidden items touch.

Runs on the CUDA card (``--device cuda``, the default, which raises where
there is none) or, when asked, on the CPU (``--device cpu``: the kernels'
plain versions):
  python examples/tasks/multilabel_torch.py --model_dir runs/ml --epochs 10
"""

from __future__ import annotations

import argparse
import os
import sys
import types

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

from bert4clickpath_torch.config import FeatureConfig, HeadConfig, ModelConfig, TrainConfig
from bert4clickpath_torch.constants import NUM_RESERVED_TOKENS, PAD_ID
from bert4clickpath_torch.data.chaining import chain_sequences, chained_length
from bert4clickpath_torch.data.generator import ClickStreamGenerator
from bert4clickpath_torch.data.pipeline import to_device
from bert4clickpath_torch.models.model import ClickstreamModel, init_state_dict
from bert4clickpath_torch.training import schedules
from bert4clickpath_torch.training.train_state import (
    TrainState,
    dropout_generator,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from bert4clickpath_torch.training.trainer import Trainer


def make_batches(sessions, batch, max_items, n_classes, rng, *, held_out=3, train=True):
    """Host batches of (B, max_items + 3) chained tokens and (B, n_classes)
    multi-hot labels, drawn as the JAX script draws them."""
    n = len(sessions)
    order = rng.permutation(n) if train else np.arange(n)
    for start in range(0, n - batch + 1, batch):
        idx = order[start : start + batch]
        hist = np.full((batch, max_items), PAD_ID, np.int32)
        labels = np.zeros((batch, n_classes), np.int32)
        for bi, si in enumerate(idx):
            s = np.asarray(sessions[si], np.int32)
            if len(s) <= held_out:
                continue
            visible, hidden = s[:-held_out][-max_items:], s[-held_out:]
            hist[bi, : len(visible)] = visible + NUM_RESERVED_TOKENS
            labels[bi, np.unique(hidden % n_classes)] = 1
        yield {
            "features": {"items": chain_sequences([hist])},
            "head_positions": None,  # segment routing
            "labels": labels,
        }


def build_model_config(vocab, max_items: int, n_classes: int) -> ModelConfig:
    return ModelConfig(
        features={"items": FeatureConfig(vocab.model_vocab_size, 32)},
        num_layers=2,
        num_heads=2,
        ffn_dim=64,
        max_len=chained_length((max_items,)),
        routing="segment",
        segment_bounds=(0, 1),  # the [CLS] summary slot
        head=HeadConfig("multilabel", (64,), n_classes),
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", required=True)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: the card (raises where there is none); cpu: the kernels' plain versions")
    p.add_argument("--n_items", type=int, default=500)
    p.add_argument("--n_classes", type=int, default=12)
    p.add_argument("--n_sessions", type=int, default=3000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--max_items", type=int, default=24)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card (torch.cuda.is_available() is False); pass --device cpu")
    device = torch.device(args.device)

    gen = ClickStreamGenerator(n_items=args.n_items, session_cohesiveness=200, seed=0)
    sessions, _ = gen.generate_sessions(args.n_sessions)
    cfg = build_model_config(gen.item_vocab(), args.max_items, args.n_classes)
    tcfg = TrainConfig(
        batch_size=args.batch,
        n_epochs=args.epochs,
        steps_per_epoch=max(1, args.n_sessions // args.batch),
    )
    model = ClickstreamModel(cfg, device=device)
    model.load_state_dict(init_state_dict(cfg, 0))
    tx = make_optimizer(tcfg)
    state = TrainState.create(dict(model.named_parameters()), tx)
    trainer = Trainer(
        make_train_step(model, tx, schedules.constant(1e-3)),
        make_eval_step(model),
        tcfg,
        model_dir=args.model_dir,
        to_device=lambda b: to_device(b, device),
    )

    def train_stream():
        r = np.random.default_rng(1)
        while True:
            yield from make_batches(sessions, args.batch, args.max_items, args.n_classes, r)

    state = trainer.fit(
        state,
        train_stream(),
        lambda: make_batches(
            sessions, args.batch, args.max_items, args.n_classes, np.random.default_rng(2), train=False,
        ),
        dropout_generator(device, 2),
    )
    last = trainer.history[-1]
    print("final:", {k: round(v, 4) for k, v in last.items() if isinstance(v, float)}, flush=True)
    print("done", flush=True)
    return types.SimpleNamespace(trainer=trainer, state=state, model=model)


if __name__ == "__main__":
    main()
