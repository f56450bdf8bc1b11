"""Multi-variable clickstream with the PyTorch port: (action, item) pairs ->
next-item retrieval.

Counterpart of ``examples/bert4rec/multivariable.py`` (BASELINE.json
configs[2]): each event is a pair of features embedded separately and
concatenated on the embedding axis, with the next-item softmax MLP head
gathering [MASK] positions. The head's final ``Dense(V)`` trains through
the fused CE with its bias and evaluates through the chunked catalog scan,
so the (B, P, V) logits never exist; the model is then exported and served
with dict sessions by ``ServingModel``.

Runs on the CUDA card (``--device cuda``, the default, which raises where
there is none) or, when asked, on the CPU (``--device cpu``: the kernels'
plain versions):
  python examples/bert4rec/multivariable_torch.py --model_dir runs/mv --epochs 5
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
from bert4clickpath_torch.constants import (
    CLS_ID,
    LABEL_PAD,
    MASK_ID,
    MASKED_PERCENTAGE,
    MAX_MASKED_ITEMS,
    NA_ID,
    NUM_RESERVED_TOKENS,
    PAD_ID,
    SEP_ID,
)
from bert4clickpath_torch.data.cloze import ITEM_OFFSET, token_length
from bert4clickpath_torch.data.generator import ClickStreamGenerator
from bert4clickpath_torch.data.pipeline import to_device
from bert4clickpath_torch.models.model import ClickstreamModel, init_state_dict
from bert4clickpath_torch.training import checkpoint as ckpt_lib
from bert4clickpath_torch.training import schedules
from bert4clickpath_torch.training.serving import ServingModel
from bert4clickpath_torch.training.train_state import (
    TrainState,
    dropout_generator,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from bert4clickpath_torch.training.trainer import Trainer


def make_pair_batches(items_seqs, events_seqs, batch, max_items, rng, train=True):
    """Host batches with BOTH features masked at the same positions, drawn
    as the JAX script draws them. A masked item's event becomes [NA], so
    the model cannot read the event at a masked slot."""
    n = len(items_seqs)
    length = token_length(max_items)
    order = rng.permutation(n) if train else np.arange(n)
    for start in range(0, n - batch + 1, batch):
        idx = order[start : start + batch]
        tokens_i = np.full((batch, length), PAD_ID, np.int32)
        tokens_e = np.full((batch, length), PAD_ID, np.int32)
        for t in (tokens_i, tokens_e):
            t[:, 0] = CLS_ID
            t[:, 1] = SEP_ID
            t[:, -1] = SEP_ID
        positions = np.zeros((batch, MAX_MASKED_ITEMS), np.int32)
        labels = np.full((batch, MAX_MASKED_ITEMS), LABEL_PAD, np.int32)
        for bi, si in enumerate(idx):
            items = items_seqs[si][:-1] if train else items_seqs[si]
            events = events_seqs[si][: len(items)]
            items = items[:max_items]
            events = events[:max_items]
            m = len(items)
            tokens_i[bi, ITEM_OFFSET : ITEM_OFFSET + m] = items + NUM_RESERVED_TOKENS
            tokens_e[bi, ITEM_OFFSET : ITEM_OFFSET + m] = events + NUM_RESERVED_TOKENS
            if train:
                n_masked = int(np.clip(int(m * MASKED_PERCENTAGE), 0, MAX_MASKED_ITEMS))
                picks = np.sort(rng.permutation(m)[:n_masked])
            else:
                n_masked = 1
                picks = np.array([m - 1])
            labels[bi, :n_masked] = items[picks]
            positions[bi, :n_masked] = picks + ITEM_OFFSET
            tokens_i[bi, picks + ITEM_OFFSET] = MASK_ID
            tokens_e[bi, picks + ITEM_OFFSET] = NA_ID
        yield {
            "features": {"items": tokens_i, "events": tokens_e},
            "head_positions": positions,
            "labels": labels,
        }


def build_model_config(item_vocab, event_vocab, max_items: int) -> ModelConfig:
    return ModelConfig(
        features={
            # (action, item) pair: separate embeddings, concatenated
            "items": FeatureConfig(item_vocab.model_vocab_size, 56),
            "events": FeatureConfig(event_vocab.model_vocab_size, 8),
        },
        num_layers=2,
        num_heads=2,
        ffn_dim=128,
        max_len=max_items + 3,
        head=HeadConfig("softmax", (128,), item_vocab.label_vocab_size),
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", required=True)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: the card (raises where there is none); cpu: the kernels' plain versions")
    p.add_argument("--n_items", type=int, default=500)
    p.add_argument("--n_events", type=int, default=8)
    p.add_argument("--n_sessions", type=int, default=4000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--max_items", type=int, default=30)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card (torch.cuda.is_available() is False); pass --device cpu")
    device = torch.device(args.device)

    gen = ClickStreamGenerator(n_items=args.n_items, n_events=args.n_events, session_cohesiveness=200, seed=0)
    items, events = gen.generate_sessions(args.n_sessions)
    item_vocab = gen.item_vocab()
    event_vocab = gen.event_vocab()
    cfg = build_model_config(item_vocab, event_vocab, args.max_items)
    tcfg = TrainConfig(
        batch_size=args.batch,
        n_epochs=args.epochs,
        steps_per_epoch=max(1, args.n_sessions // args.batch),
    )
    model = ClickstreamModel(cfg, device=device)
    model.load_state_dict(init_state_dict(cfg, 0))
    tx = make_optimizer(tcfg)
    state = TrainState.create(dict(model.named_parameters()), tx)
    num_valid = item_vocab.label_vocab_size
    trainer = Trainer(
        make_train_step(model, tx, schedules.constant(1e-3), fused_ce_num_valid=num_valid),
        make_eval_step(model, chunked_num_valid=num_valid),
        tcfg,
        model_dir=args.model_dir,
        to_device=lambda b: to_device(b, device),
    )

    def train_stream():
        r = np.random.default_rng(1)
        while True:
            yield from make_pair_batches(items, events, args.batch, args.max_items, r)

    state = trainer.fit(
        state,
        train_stream(),
        lambda: make_pair_batches(items, events, args.batch, args.max_items, np.random.default_rng(0), train=False),
        dropout_generator(device, 2),
    )

    # export and serve the paired-feature model: dict sessions, [MASK] on
    # the item feature and [NA] on the event feature at the appended
    # next-item slot
    export_dir = ckpt_lib.export_serving(
        os.path.join(args.model_dir, "export"), state.params, cfg, {"items": item_vocab, "events": event_vocab},
    )
    served = ServingModel(export_dir, device=device)
    recs = served.recommend(
        [{"items": [item_vocab.decode_label(i) for i in (0, 1, 2)], "events": [event_vocab.decode_label(0)] * 3}],
        k=5,
    )
    print("serving top-5:", [(n, round(s, 3)) for n, s in recs[0]], flush=True)
    print("done", flush=True)
    return types.SimpleNamespace(trainer=trainer, state=state, model=model, export_dir=export_dir)


if __name__ == "__main__":
    main()
