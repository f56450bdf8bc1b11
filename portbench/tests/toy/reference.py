"""Plain float32 reference of a toy second architecture, which the
benchmark's tests add as new files to a copy of the benchmark.

Item ids looked up in a table scaled by sqrt(d_model), one pre-LN block
whose feed-forward is gated, x + (SiLU(h W_gate^T) * (h W_up^T)) W_down^T
with h = LayerNorm(x) and the gate and up projections one stacked
(2, ffn_dim, d_model) weight, a final LayerNorm, the Cloze positions
gathered, and a softmax tied to the item table, whose mean negative
log-likelihood over the labelled rows is the loss. No positions, no
dropout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from portbench.reference.common import LABEL_PAD, BlockedTiedCE, Numerics

LN_EPS = 1e-5


def check_supported(cfg: dict) -> None:
    if cfg["norm_style"] != "pre" or cfg["head"] != "tied_softmax":
        raise ValueError("toy reference: pre-LN with a tied softmax only")


def param_specs(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    d, f = cfg["d_model"], cfg["ffn_dim"]
    return [
        ("embed_items.weight", (cfg["table_rows"], d), "table"),
        ("block.norm.weight", (d,), "ones"), ("block.norm.bias", (d,), "zeros"),
        ("block.w_in", (2, f, d), "dense"), ("block.w_out", (d, f), "dense"),
        ("final_norm.weight", (d,), "ones"), ("final_norm.bias", (d,), "zeros"),
    ]


def _norm(x, params, name):
    return torch.nn.functional.layer_norm(x, x.shape[-1:], params[f"{name}.weight"], params[f"{name}.bias"], LN_EPS)


def loss_fn(params: dict, cfg: dict, batch: dict, generator: Optional[torch.Generator],
            num: Numerics, block: int) -> torch.Tensor:
    d = cfg["d_model"]
    x = params["embed_items.weight"][batch["tokens"].long()] * math.sqrt(d)
    h = _norm(x, params, "block.norm")
    w_in = params["block.w_in"]
    gated = torch.nn.functional.silu(num.mm(h, w_in[0].t())) * num.mm(h, w_in[1].t())
    x = _norm(x + num.mm(gated, params["block.w_out"].t()), params, "final_norm")
    x = torch.gather(x, 1, batch["positions"].long()[..., None].expand(-1, -1, d))
    labels = batch["labels"].reshape(-1).long()
    live = labels != LABEL_PAD
    xs = x.reshape(-1, d)[live]
    return BlockedTiedCE.apply(xs, params["embed_items.weight"], labels[live], cfg["n_items"], block, num)


def model_flops(cfg: dict, stats: dict) -> float:
    """3x the forward: the gated feed-forward over the real tokens and the
    tied head over the catalog."""
    d, f = cfg["d_model"], cfg["ffn_dim"]
    forward = 2.0 * stats["tokens"] * 3 * d * f + 2.0 * stats["labelled"] * cfg["n_items"] * d
    return 3.0 * forward
