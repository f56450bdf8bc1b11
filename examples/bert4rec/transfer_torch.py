"""Transfer-learning chain of the PyTorch port: Cloze pretrain -> binary
purchase-intent head.

Counterpart of ``examples/bert4rec/transfer.py`` (BASELINE.json
configs[3]): pretrain the Cloze recommender (tied softmax, trained through
the fused CE), save the encoder and embeddings, then load them under a
fresh binary head routed to the [CLS] summary token
(``routing='segment'``, bounds (0, 1)) and fine-tune it beside the same
head trained from scratch. Both print their F1 and predicted-positive rate.

Synthetic task: sessions whose mean item id is high "intend to purchase",
learnable only through the item embeddings, so transfer from pretraining
should beat training the head from scratch. ``--pos_frac`` above 0.5
makes positives rare and weights them by the measured neg/pos ratio
(``pos_weight``) unless ``--pos_weight`` is given.

Runs on the CUDA card (``--device cuda``, the default, which raises where
there is none) or, when asked, on the CPU (``--device cpu``: the kernels'
plain versions):
  python examples/bert4rec/transfer_torch.py --model_dir runs/tl
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

from bert4clickpath_torch.config import FeatureConfig, HeadConfig, ModelConfig, TrainConfig
from bert4clickpath_torch.constants import LABEL_PAD, NUM_RESERVED_TOKENS
from bert4clickpath_torch.data.cloze import _empty_batch
from bert4clickpath_torch.data.generator import ClickStreamGenerator
from bert4clickpath_torch.data.pipeline import ClozeDataset, to_device
from bert4clickpath_torch.models.model import ClickstreamModel, init_state_dict
from bert4clickpath_torch.ops import metrics as M
from bert4clickpath_torch.ops.losses import masked_binary_cross_entropy
from bert4clickpath_torch.training import checkpoint as ckpt_lib
from bert4clickpath_torch.training import schedules
from bert4clickpath_torch.training.train_state import (
    TrainState,
    dropout_generator,
    make_eval_step,
    make_optimizer,
    make_train_step,
)


def binary_batches(sequences, n_items, batch, max_items, rng, shuffle=True, threshold_frac=0.5):
    """CLS-routed binary host batches: label = 1 iff the session's mean item
    id is above the ``threshold_frac`` point of the id range (0.5 =
    balanced; higher makes positives rare)."""
    n = len(sequences)
    order = rng.permutation(n) if shuffle else np.arange(n)
    threshold = (n_items - 1) * threshold_frac
    for start in range(0, n - batch + 1, batch):
        idx = order[start : start + batch]
        tokens, _, _ = _empty_batch(batch, max_items, 1)
        labels = np.full((batch, 1), LABEL_PAD, np.int32)
        for bi, si in enumerate(idx):
            seq = sequences[si][:max_items]
            tokens[bi, 2 : 2 + len(seq)] = seq + NUM_RESERVED_TOKENS
            labels[bi, 0] = int(seq.mean() > threshold)
        yield {"features": {"items": tokens}, "head_positions": None, "labels": labels}


def pretrain_config(vocab, max_items: int) -> ModelConfig:
    return ModelConfig(
        features={"items": FeatureConfig(vocab.model_vocab_size, 32)},
        num_layers=2,
        num_heads=2,
        ffn_dim=64,
        max_len=max_items + 3,
        head=HeadConfig("tied_softmax"),
    )


def finetune_config(pre_cfg: ModelConfig) -> ModelConfig:
    """The pretrained encoder under a binary head on the CLS summary token."""
    return dataclasses.replace(
        pre_cfg, head=HeadConfig("binary", (32,)), routing="segment", segment_bounds=(0, 1),
    )


def finetune(model, init_params, tcfg, batches_fn, steps, lr, generator, device, loss_fn=None):
    """``steps`` train steps of ``model`` from ``init_params`` (a state_dict),
    cycling ``batches_fn()``; returns the state and the last loss."""
    model.load_state_dict(init_params)
    tx = make_optimizer(tcfg)
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, tx, schedules.constant(lr), loss_fn=loss_fn)
    it = batches_fn()
    loss = None
    for _ in range(steps):
        try:
            b = next(it)
        except StopIteration:
            it = batches_fn()
            b = next(it)
        state, loss = step(state, to_device(b, device), generator)
    return state, float(loss)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", required=True)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: the card (raises where there is none); cpu: the kernels' plain versions")
    p.add_argument("--n_items", type=int, default=200)
    p.add_argument("--n_sessions", type=int, default=2000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--pretrain_steps", type=int, default=300)
    p.add_argument("--finetune_steps", type=int, default=60)
    p.add_argument("--max_items", type=int, default=30)
    p.add_argument("--pos_frac", type=float, default=0.5,
                   help="id-range threshold fraction for the intent label; >0.5 makes "
                   "positives rare and activates pos_weight (reference losses.py:71-96)")
    p.add_argument("--pos_weight", type=float, default=0.0,
                   help="positive-class loss weight; 0 = auto (neg/pos ratio measured "
                   "on the corpus) when --pos_frac != 0.5, else unweighted")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card (torch.cuda.is_available() is False); pass --device cpu")
    device = torch.device(args.device)

    gen = ClickStreamGenerator(n_items=args.n_items, session_cohesiveness=200, seed=0)
    sequences, _ = gen.generate_sessions(args.n_sessions)
    vocab = gen.item_vocab()
    ds = ClozeDataset(sequences, vocab, max_items=args.max_items)
    tcfg = TrainConfig(batch_size=args.batch)

    # ---- stage 1: Cloze pretrain (tied softmax, through the fused CE) ----
    pre_cfg = pretrain_config(vocab, args.max_items)
    pre_model = ClickstreamModel(pre_cfg, device=device)
    pre_model.load_state_dict(init_state_dict(pre_cfg, 0))
    tx = make_optimizer(tcfg)
    state = TrainState.create(dict(pre_model.named_parameters()), tx)
    step = make_train_step(pre_model, tx, schedules.constant(2e-3), fused_ce_num_valid=vocab.label_vocab_size)
    it = ds.train_batches(args.batch, seed=1)
    generator = dropout_generator(device, 2)
    for _ in range(args.pretrain_steps):
        state, loss = step(state, to_device(next(it), device), generator)
    print(f"pretrain final loss {float(loss):.4f}", flush=True)
    pre_dir = os.path.join(args.model_dir, "pretrained")
    ckpt_lib.save_params(
        os.path.join(pre_dir, ckpt_lib.PARAMS_FILE),
        {k: v for k, v in state.params.items() if ckpt_lib.is_transferred(k)},
    )

    # ---- stage 2: binary purchase-intent head on [CLS] -------------------
    ft_cfg = finetune_config(pre_cfg)
    ft_model = ClickstreamModel(ft_cfg, device=device)
    fresh = init_state_dict(ft_cfg, 4)

    # imbalance-aware loss: weight rare positives by the measured neg/pos
    # ratio (the reference's pos_weight for return/purchase tasks)
    loss_fn = None
    pos_weight = args.pos_weight
    if not pos_weight and args.pos_frac != 0.5:
        thr = (args.n_items - 1) * args.pos_frac
        pos = sum(float(s[: args.max_items].mean() > thr) for s in sequences)
        pos_rate = pos / len(sequences)
        pos_weight = (1.0 - pos_rate) / max(pos_rate, 1e-6)
    if pos_weight:
        loss_fn = functools.partial(masked_binary_cross_entropy, pos_weight=pos_weight)
        print(f"pos_weight={pos_weight:.2f}", flush=True)

    def stream():
        return binary_batches(
            sequences, args.n_items, args.batch, args.max_items, np.random.default_rng(5),
            threshold_frac=args.pos_frac,
        )

    results = {}
    for name, init_params in (("scratch", fresh), ("transfer", ckpt_lib.restore_encoder(pre_dir, fresh))):
        st, final_loss = finetune(
            ft_model, init_params, tcfg, stream, args.finetune_steps, 1e-3, dropout_generator(device, 6),
            device, loss_fn=loss_fn,
        )
        ev = make_eval_step(ft_model, loss_fn=loss_fn)
        acc = None
        for b in binary_batches(
            sequences, args.n_items, args.batch, args.max_items, np.random.default_rng(7), shuffle=False,
            threshold_frac=args.pos_frac,
        ):
            s = ev(st.params, to_device(b, device))
            acc = s if acc is None else M.merge(acc, s)
        out = M.finalize(acc)
        results[name] = out
        print(f"{name}: loss {final_loss:.4f} f1 {out['f1']:.4f} pred_pos {out['pred_positives']:.3f}", flush=True)
    if results["transfer"]["f1"] > results["scratch"]["f1"]:
        print("TRANSFER WINS", flush=True)
    print("done", flush=True)
    return results


if __name__ == "__main__":
    main()
