"""Multi-sequence chaining end to end with the PyTorch port: history +
basket -> return prediction.

Counterpart of ``examples/chained/train.py``: two chained sequences
(``[CLS][SEP] history [SEP] basket [SEP]``), ``routing='segment'`` mounting
the binary head on segment 2 (the basket), segment embeddings telling the
spans apart, and the binary loss with ``pos_weight`` in the train and the
eval step. Each segment's pads sit before its [SEP], so the attention
kernels see pads inside the sequence.

Synthetic task (learnable only through cross-segment attention): a basket
item is RETURNED (label 1) iff it never appeared in the user's history,
with 10% label noise.

Runs on the CUDA card (``--device cuda``, the default, which raises where
there is none) or, when asked, on the CPU (``--device cpu``: the kernels'
plain versions):
  python examples/chained/train_torch.py --model_dir runs/chained
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import types

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

from bert4clickpath_torch.config import FeatureConfig, HeadConfig, ModelConfig, TrainConfig
from bert4clickpath_torch.constants import LABEL_PAD, NUM_RESERVED_TOKENS, PAD_ID
from bert4clickpath_torch.data.chaining import chain_sequences, chained_length, segment_bounds
from bert4clickpath_torch.data.generator import ClickStreamGenerator
from bert4clickpath_torch.data.pipeline import to_device
from bert4clickpath_torch.models.model import ClickstreamModel, init_state_dict
from bert4clickpath_torch.ops.losses import masked_binary_cross_entropy
from bert4clickpath_torch.training import schedules
from bert4clickpath_torch.training.train_state import (
    TrainState,
    dropout_generator,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from bert4clickpath_torch.training.trainer import Trainer

BASKET_LEN = 8


def make_chained_batches(
    histories, batch, max_hist, rng, *, noise=0.1, return_rate=0.5, train=True,
    n_catalog=10_000,
):
    """Host batches of (B, chained_length) tokens and (B, BASKET_LEN) binary
    labels, drawn as the JAX script draws them. Basket items come half from
    the history (label 0: kept) and half from the rest of the catalog
    (label 1: returned), ``noise`` of them flipped."""
    n = len(histories)
    order = rng.permutation(n) if train else np.arange(n)
    for start in range(0, n - batch + 1, batch):
        idx = order[start : start + batch]
        hist = np.full((batch, max_hist), PAD_ID, np.int32)
        basket = np.full((batch, BASKET_LEN), PAD_ID, np.int32)
        labels = np.full((batch, BASKET_LEN), LABEL_PAD, np.int32)
        for bi, si in enumerate(idx):
            h = np.asarray(histories[si], np.int32)[-max_hist:]
            hist[bi, : len(h)] = h + NUM_RESERVED_TOKENS
            k = int(rng.integers(BASKET_LEN // 2, BASKET_LEN + 1))
            hset = set(int(x) for x in h)
            for j in range(k):
                if rng.random() < 1.0 - return_rate and hset:
                    item = int(rng.choice(sorted(hset)))
                else:
                    item = int(rng.integers(0, n_catalog))
                returned = 0 if item in hset else 1
                if rng.random() < noise:
                    returned = 1 - returned
                basket[bi, j] = item + NUM_RESERVED_TOKENS
                labels[bi, j] = returned
        yield {
            "features": {"items": chain_sequences([hist, basket])},
            "head_positions": None,  # segment routing
            "labels": labels,
        }


def build_model_config(vocab, max_hist: int) -> ModelConfig:
    seg_lens = (max_hist, BASKET_LEN)
    return ModelConfig(
        features={"items": FeatureConfig(vocab.model_vocab_size, 32)},
        num_layers=2,
        num_heads=2,
        ffn_dim=64,
        max_len=chained_length(seg_lens),
        routing="segment",
        # the head mounts on segment 2, the basket span
        segment_bounds=segment_bounds(seg_lens, 2),
        use_segment_embeddings=True,
        head=HeadConfig("binary", (64, 32)),
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", required=True)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: the card (raises where there is none); cpu: the kernels' plain versions")
    p.add_argument("--n_items", type=int, default=300)
    p.add_argument("--n_sessions", type=int, default=4000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--max_hist", type=int, default=24)
    p.add_argument("--pos_weight", type=float, default=2.0,
                   help="returned-class weight (reference MaskedLoss pos_weight)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card (torch.cuda.is_available() is False); pass --device cpu")
    device = torch.device(args.device)

    gen = ClickStreamGenerator(n_items=args.n_items, session_cohesiveness=200, seed=0)
    histories, _ = gen.generate_sessions(args.n_sessions)
    cfg = build_model_config(gen.item_vocab(), args.max_hist)
    tcfg = TrainConfig(
        batch_size=args.batch,
        n_epochs=args.epochs,
        steps_per_epoch=max(1, args.n_sessions // args.batch),
    )
    model = ClickstreamModel(cfg, device=device)
    model.load_state_dict(init_state_dict(cfg, 0))
    tx = make_optimizer(tcfg)
    state = TrainState.create(dict(model.named_parameters()), tx)
    loss_fn = functools.partial(masked_binary_cross_entropy, pos_weight=args.pos_weight)
    trainer = Trainer(
        make_train_step(model, tx, schedules.constant(1e-3), loss_fn=loss_fn),
        make_eval_step(model, loss_fn=loss_fn),
        tcfg,
        model_dir=args.model_dir,
        to_device=lambda b: to_device(b, device),
    )

    def train_stream():
        r = np.random.default_rng(1)
        while True:
            yield from make_chained_batches(histories, args.batch, args.max_hist, r, n_catalog=args.n_items)

    state = trainer.fit(
        state,
        train_stream(),
        lambda: make_chained_batches(
            histories, args.batch, args.max_hist, np.random.default_rng(2), train=False, n_catalog=args.n_items,
        ),
        dropout_generator(device, 2),
    )
    # headline: masked accuracy via the streaming binary counts
    last = trainer.history[-1]
    print("final:", {k: round(v, 4) for k, v in last.items() if isinstance(v, float)}, flush=True)
    print("done", flush=True)
    return types.SimpleNamespace(trainer=trainer, state=state, model=model)


if __name__ == "__main__":
    main()
