"""Plain float32 reference of the train step the benchmark times.

BERT4Rec (Sun et al. 2019, https://arxiv.org/abs/1904.06690) as the
configuration files under ``portbench/configs/`` state it: item ids looked
up in a table scaled by sqrt(d_model), sinusoidal positions added, dropout,
post-LN Transformer layers (multi-head attention with padded keys masked,
ReLU feed-forward, LayerNorm eps 1e-6), the Cloze positions gathered, and a
softmax tied to the item table over the catalog's rows, whose mean negative
log-likelihood over the labelled rows is the loss. Adam (no weight decay)
at a constant learning rate updates every parameter.

Where a batch carries ``negatives`` (S label ids shared by the batch),
the softmax is sampled instead (:func:`sampled_ce`): each labelled row
against its label's row and the S shared rows, the negatives' logits raised
by log(V / S) (the log-Q correction of a uniform sampler), a negative equal
to the row's own label blinded.

Written in plain PyTorch from that description; it imports nothing of the
program. Every product goes through a ``Numerics`` of ``common.py`` (what
every reference shares). The full softmax over a catalog of millions of
rows is taken in blocks of rows (``common.BlockedTiedCE``), so no (rows,
catalog) logits exist at once; the sampled one gathers S + N rows.

Dropout draws its keep masks from a ``torch.Generator`` with
``torch.rand(shape) < 1 - rate``, one draw of the activation's shape per
dropout site in the order of the forward (the encoder input, then each
layer's attention and feed-forward outputs): the draws the model's
description implies, from the generator the benchmark seeds for both sides.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from portbench.reference.common import (
    LABEL_PAD,
    NUM_RESERVED,
    PAD_ID,
    BlockedTiedCE,
    Numerics,
    dropout,
)

LN_EPS = 1e-6
NEG_INF = -1e9  # additive bias of a padded key


def sinusoid(length: int, d: int, device) -> torch.Tensor:
    """(length, d): sin on even features, cos on odd, base 10000."""
    pos = torch.arange(length, dtype=torch.float64)[:, None]
    i = torch.arange(d, dtype=torch.float64)[None, :]
    angles = pos / torch.pow(10000.0, 2.0 * torch.div(i, 2, rounding_mode="floor") / d)
    table = torch.where(i.long() % 2 == 0, torch.sin(angles), torch.cos(angles))
    return table.to(torch.float32).to(device)


def param_specs(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter; kind is ``table``,
    ``dense`` (a weight whose last axis is its fan-in), ``zeros`` or
    ``ones``. Names follow the model's usual parameter tree, with the
    query, key and value projections apart (a program may keep them in one
    tensor; the benchmark reads it by rows)."""
    d, f = cfg["d_model"], cfg["ffn_dim"]
    specs = [("embed_items.weight", (cfg["table_rows"], d), "table")]
    for i in range(cfg["num_layers"]):
        p = f"encoder.layer_{i}."
        for name in ("wq", "wk", "wv", "wo"):
            specs += [(f"{p}mha.{name}.weight", (d, d), "dense"), (f"{p}mha.{name}.bias", (d,), "zeros")]
        for ln in ("ln1", "ln2"):
            specs += [(f"{p}{ln}.weight", (d,), "ones"), (f"{p}{ln}.bias", (d,), "zeros")]
        specs += [
            (f"{p}ffn1.weight", (f, d), "dense"), (f"{p}ffn1.bias", (f,), "zeros"),
            (f"{p}ffn2.weight", (d, f), "dense"), (f"{p}ffn2.bias", (d,), "zeros"),
        ]
    return specs


def check_supported(cfg: dict) -> None:
    """The reference covers the configurations whose every part it writes
    out; anything else is refused rather than approximated."""
    wanted = {"head": "tied_softmax", "norm_style": "post", "positional": "sinusoidal"}
    for key, value in wanted.items():
        if cfg[key] != value:
            raise ValueError(f"reference: {key}={cfg[key]!r} is not written out (only {value!r})")


def _linear(x, params, name, num: Numerics):
    return num.mm(x, params[f"{name}.weight"].t()) + params[f"{name}.bias"]


def _layer_norm(x, params, name):
    return torch.nn.functional.layer_norm(
        x, x.shape[-1:], params[f"{name}.weight"], params[f"{name}.bias"], LN_EPS
    )


def _attention(x, bias, params, prefix, cfg, num: Numerics):
    b, l, d = x.shape
    h = cfg["num_heads"]
    dh = d // h
    q, k, v = (_linear(x, params, f"{prefix}mha.{n}", num) for n in ("wq", "wk", "wv"))
    heads = lambda t: t.reshape(b, l, h, dh).transpose(1, 2)  # noqa: E731
    q, k, v = heads(q), heads(k), heads(v)
    scores = num.mm(q, k.transpose(-1, -2)) / math.sqrt(dh) + bias
    out = num.mm(torch.softmax(scores, dim=-1), v)
    return _linear(out.transpose(1, 2).reshape(b, l, d), params, f"{prefix}mha.wo", num)


def head_inputs(params: dict, cfg: dict, tokens: torch.Tensor, positions: torch.Tensor,
                generator: Optional[torch.Generator], num: Numerics) -> torch.Tensor:
    """(B, P, d_model): the encoder's output at the Cloze positions."""
    b, l = tokens.shape
    d = cfg["d_model"]
    rate = cfg["dropout_rate"]
    x = params["embed_items.weight"][tokens.long()] * math.sqrt(d) + sinusoid(l, d, tokens.device)[None]
    bias = ((tokens == PAD_ID).float() * NEG_INF)[:, None, None, :]
    x = dropout(x, rate, generator)
    for i in range(cfg["num_layers"]):
        p = f"encoder.layer_{i}."
        x = _layer_norm(x + dropout(_attention(x, bias, params, p, cfg, num), rate, generator), params, f"{p}ln1")
        f = _linear(torch.relu(_linear(x, params, f"{p}ffn1", num)), params, f"{p}ffn2", num)
        x = _layer_norm(x + dropout(f, rate, generator), params, f"{p}ln2")
    return torch.gather(x, 1, positions.long()[..., None].expand(-1, -1, d))


def sampled_ce(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor, negatives: torch.Tensor,
               n_items: int, num: Numerics) -> torch.Tensor:
    """Mean NLL of each of the N rows of ``x`` under a softmax over its
    label's table row and the S rows of ``negatives`` (label-space ids
    shared by every row): float32 products, log(n_items / S) added to the
    negatives' logits, a negative equal to the row's own label blinded.
    Gathers the N + S rows; no (N, n_items) logits."""
    s = negatives.shape[0]
    w_label = table[labels + NUM_RESERVED]  # (N, D)
    w_neg = table[negatives + NUM_RESERVED]  # (S, D)
    pos = num.mm(x[:, None, :], w_label[:, :, None]).reshape(-1)
    neg = num.mm(x, w_neg.t()) + math.log(n_items / s)
    neg = neg.masked_fill(negatives[None, :] == labels[:, None], -math.inf)
    logz = torch.logsumexp(torch.cat([pos[:, None], neg], dim=1), dim=1)
    return (logz - pos).mean()


def loss_fn(params: dict, cfg: dict, batch: dict, generator: Optional[torch.Generator],
            num: Numerics, block: int) -> torch.Tensor:
    """The step's loss on one batch of numpy arrays already on the device:
    ``tokens`` (B, L), ``positions`` (B, P), ``labels`` (B, P), and where
    the traffic samples the softmax ``negatives`` (S,)."""
    x = head_inputs(params, cfg, batch["tokens"], batch["positions"], generator, num)
    labels = batch["labels"].reshape(-1).long()
    live = labels != LABEL_PAD
    xs = x.reshape(-1, x.shape[-1])[live]
    table = params["embed_items.weight"]
    if "negatives" in batch:
        return sampled_ce(xs, table, labels[live], batch["negatives"].long(), cfg["n_items"], num)
    return BlockedTiedCE.apply(xs, table, labels[live], cfg["n_items"], block, num)


def encoder_forward_flops(cfg: dict, tokens: int, tokens_sq: int) -> float:
    """Dense layers over the real tokens, attention over the real
    query-key pairs, for every layer."""
    d, f = cfg["d_model"], cfg["ffn_dim"]
    dense = 2.0 * tokens * (4 * d * d + 2 * d * f)
    attention = 4.0 * tokens_sq * d
    return cfg["num_layers"] * (dense + attention)


def model_flops(cfg: dict, stats: dict) -> float:
    """Forward and backward (3x the forward) of the encoder and the tied
    head for one batch (``harness/traffic.py:batch_stats``), without
    recomputed work: the head scores each labelled row against the catalog,
    or against its label and the batch's S negatives where it samples."""
    rows = stats["negatives"] + 1 if "negatives" in stats else cfg["n_items"]
    head = 2.0 * stats["labelled"] * rows * cfg["d_model"]
    return 3.0 * (encoder_forward_flops(cfg, stats["tokens"], stats["tokens_sq"]) + head)
