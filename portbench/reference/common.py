"""What every plain reference shares: the token layout's ids, the
numerics of products, dropout, the blocked tied softmax, Adam, and the
norms the check reads.

A reference module (``portbench/reference/<r>.py``, picked by a
configuration's ``"reference"`` key, ``model`` without one) exports
``check_supported(cfg)``, ``param_specs(cfg)``, ``loss_fn(params, cfg,
batch, generator, numerics, block_rows)`` and ``model_flops(cfg, stats)``,
and takes from here what it shares with the others. Written in plain
PyTorch; it imports nothing of the program.

Every product goes through a :class:`Numerics`, which is exact float32 for
the reference (the caller turns TF32 off) and rounds the operands to fp8
for the lower-precision control.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

NUM_RESERVED = 10  # reserved rows ahead of the items in the table
PAD_ID = 0
LABEL_PAD = -1


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


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    if generator is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


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
