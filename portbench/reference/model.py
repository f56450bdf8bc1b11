"""Plain float32 reference of the train step the benchmark times.

BERT4Rec (Sun et al. 2019, https://arxiv.org/abs/1904.06690) as the
configuration files under ``portbench/configs/`` state it: item ids looked
up in a table scaled by sqrt(d_model), sinusoidal positions added, dropout,
post-LN Transformer layers (multi-head attention with padded keys masked,
ReLU feed-forward, LayerNorm eps 1e-6), the Cloze positions gathered, and a
softmax tied to the item table over the catalog's rows, whose mean negative
log-likelihood over the labelled rows is the loss. Adam (no weight decay)
at a constant learning rate updates every parameter.

Written in plain PyTorch from that description; it imports nothing of the
program. Every product goes through a :class:`Numerics`, which is exact
float32 for the reference (the caller turns TF32 off) and rounds the
operands to fp8 for the lower-precision control. The softmax
over a catalog of millions of rows is taken in blocks of rows
(:class:`BlockedTiedCE`), so no (rows, catalog) logits exist at once.

Dropout draws its keep masks from a ``torch.Generator`` with
``torch.rand(shape) < 1 - rate``, one draw of the activation's shape per
dropout site in the order of the forward (the encoder input, then each
layer's attention and feed-forward outputs): the draws the model's
description implies, from the generator the benchmark seeds for both sides.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

NUM_RESERVED = 10  # reserved rows ahead of the items in the table
PAD_ID = 0
LABEL_PAD = -1
LN_EPS = 1e-6
NEG_INF = -1e9  # additive bias of a padded key


class Numerics:
    """Products in float32 (``"float32"``), or with each operand rounded to
    fp8 first (``"fp8"``: e4m3 for activations and weights, e5m2 for the
    gradients of the backward, one scale per tensor, float32 sums)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown numerics {name!r}")
        self.name = name

    def fwd(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.name == "float32" else _round_scaled(t, torch.float8_e4m3fn, 448.0)

    def bwd(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.name == "float32" else _round_scaled(t, torch.float8_e5m2, 57344.0)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` (batched), differentiable."""
        if self.name == "float32":
            return a @ b
        return _RoundedMatmul.apply(a, b, self)


def _round_scaled(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return (t * scale).to(dtype).to(t.dtype) / scale


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, numerics):
        qa, qb = numerics.fwd(a), numerics.fwd(b)
        ctx.save_for_backward(qa, qb)
        ctx.numerics = numerics
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = ctx.numerics.bwd(g)
        da = qg @ qb.transpose(-1, -2)
        db = qa.transpose(-1, -2) @ qg
        # undo broadcasting over leading batch dimensions
        while da.dim() > qa.dim():
            da = da.sum(0)
        while db.dim() > qb.dim():
            db = db.sum(0)
        return da, db, None


def sinusoid(length: int, d: int, device) -> torch.Tensor:
    """(length, d): sin on even features, cos on odd, base 10000."""
    pos = torch.arange(length, dtype=torch.float64)[:, None]
    i = torch.arange(d, dtype=torch.float64)[None, :]
    angles = pos / torch.pow(10000.0, 2.0 * torch.div(i, 2, rounding_mode="floor") / d)
    table = torch.where(i.long() % 2 == 0, torch.sin(angles), torch.cos(angles))
    return table.to(torch.float32).to(device)


def param_specs(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter; kind is ``table``,
    ``dense`` (a weight whose second axis is its fan-in), ``zeros`` or
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


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    if generator is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


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


class BlockedTiedCE(torch.autograd.Function):
    """Mean NLL of ``labels`` (label-space ids) under softmax(x @ W^T) over
    the table rows ``[NUM_RESERVED, NUM_RESERVED + n_items)``, taken over
    blocks of ``block`` rows; the backward computes each block's scores
    again."""

    @staticmethod
    def forward(ctx, x, table, labels, n_items, block, num):
        n = x.shape[0]
        m = torch.full((n,), -math.inf, device=x.device)
        s = torch.zeros(n, device=x.device)
        picked = torch.zeros(n, device=x.device)
        qx = num.fwd(x)
        rows = torch.arange(n, device=x.device)
        for start in range(0, n_items, block):
            stop = min(n_items, start + block)
            z = qx @ num.fwd(table[NUM_RESERVED + start : NUM_RESERVED + stop]).t()
            top = torch.maximum(m, z.amax(dim=1))
            s = s * torch.exp(m - top) + torch.exp(z - top[:, None]).sum(dim=1)
            m = top
            inside = (labels >= start) & (labels < stop)
            picked = torch.where(inside, z[rows, (labels - start).clamp(0, stop - start - 1)], picked)
        logz = m + torch.log(s)
        ctx.save_for_backward(x, table, labels, logz)
        ctx.shape = (n_items, block, num)
        return (logz - picked).mean()

    @staticmethod
    def backward(ctx, g):
        x, table, labels, logz = ctx.saved_tensors
        n_items, block, num = ctx.shape
        n = x.shape[0]
        coef = g / n
        qx = num.fwd(x)
        rows = torch.arange(n, device=x.device)
        dx = torch.zeros_like(x)
        dtable = torch.zeros_like(table)
        for start in range(0, n_items, block):
            stop = min(n_items, start + block)
            w = num.fwd(table[NUM_RESERVED + start : NUM_RESERVED + stop])
            p = torch.exp(qx @ w.t() - logz[:, None]) * coef
            inside = (labels >= start) & (labels < stop)
            p[rows[inside], labels[inside] - start] -= coef
            dz = num.bwd(p)
            dx += dz @ w
            dtable[NUM_RESERVED + start : NUM_RESERVED + stop] = dz.t() @ qx
        return dx, dtable, None, None, None, None


def loss_fn(params: dict, cfg: dict, batch: dict, generator: Optional[torch.Generator],
            num: Numerics, block: int) -> torch.Tensor:
    """The step's loss on one batch of numpy arrays already on the device:
    ``tokens`` (B, L), ``positions`` (B, P), ``labels`` (B, P)."""
    x = head_inputs(params, cfg, batch["tokens"], batch["positions"], generator, num)
    labels = batch["labels"].reshape(-1).long()
    live = labels != LABEL_PAD
    xs = x.reshape(-1, x.shape[-1])[live]
    return BlockedTiedCE.apply(xs, params["embed_items.weight"], labels[live], cfg["n_items"], block, num)


class Adam:
    """Adam without weight decay: mu = b1 mu + (1 - b1) g, nu = b2 nu +
    (1 - b2) g^2, p -= lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps);
    mu is kept in the configuration's first-moment type."""

    def __init__(self, params: dict, opt: dict):
        self.b1, self.b2, self.eps, self.lr = opt["b1"], opt["b2"], opt["eps"], opt["lr"]
        self.mu_dtype = getattr(torch, opt["mu_dtype"])
        self.mu = {k: torch.zeros_like(p, dtype=self.mu_dtype) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> None:
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for k, p in params.items():
            g = grads[k]
            mu = self.mu[k].float().mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.nu[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.nu[k] / bc2).sqrt_().add_(self.eps)
            p.addcdiv_(mu, denom, value=-self.lr / bc1)
            self.mu[k].copy_(mu)


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.float())) for k, t in tensors.items()}


def gradient_rms(norms: dict, sizes: dict) -> dict:
    return {k: norms[k] / math.sqrt(sizes[k]) for k in norms}


def median(values) -> float:
    return float(np.median(np.asarray(list(values), dtype=np.float64)))
