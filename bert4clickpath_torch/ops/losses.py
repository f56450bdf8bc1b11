"""Masked losses over padded label tensors (counterpart of
``bert4clickpath_tpu/ops/losses.py``).

Labels are always fixed-shape with ``LABEL_PAD`` fill; losses take logits
and run in f32; the masked mean divides by ``max(count, 1)``. The JAX
versions' ``axis_name`` (a psum of sums and counts across devices) is left
out: the port's data-parallel tier will reduce outside autograd.
``sampled_softmax_ce`` is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from bert4clickpath_torch.constants import LABEL_PAD


def masked_mean(
    item_losses: torch.Tensor,
    labels: torch.Tensor,
    label_pad: int = LABEL_PAD,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean of ``item_losses`` over positions where ``labels != label_pad``."""
    mask = (labels != label_pad).to(item_losses.dtype)
    if weights is not None:
        item_losses = item_losses * weights
    return (item_losses * mask).sum() / mask.sum().clamp(min=1.0)


def softmax_ce_items(
    logits: torch.Tensor, labels: torch.Tensor, label_pad: int = LABEL_PAD
) -> torch.Tensor:
    """Per-position NLL (no reduction), in f32; pad labels read class 0."""
    logits = logits.float()
    safe = torch.where(labels == label_pad, 0, labels).long()
    label_logit = logits.gather(-1, safe[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - label_logit


def masked_softmax_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, label_pad: int = LABEL_PAD
) -> torch.Tensor:
    """Sparse softmax CE over (B, P, V) logits / (B, P) labels with pads."""
    return masked_mean(softmax_ce_items(logits, labels, label_pad), labels, label_pad)


def binary_ce_items(
    logits: torch.Tensor,
    labels: torch.Tensor,
    label_pad: int = LABEL_PAD,
    pos_weight: Optional[float] = None,
):
    """(nll, weights, scale): per-item stable BCE with logits, per-item
    weights (None without pos_weight), and the (pos_weight + 1) / 2
    normalizer that puts the weighted mean back on the unweighted scale."""
    logits = logits.float()
    labels_f = labels.float()
    safe = torch.where(labels_f == label_pad, torch.zeros_like(labels_f), labels_f)
    # max(x, 0) - x*z + log1p(exp(-|x|))
    nll = logits.clamp(min=0.0) - logits * safe + torch.log1p(torch.exp(-logits.abs()))
    weights = None
    scale = 1.0
    if pos_weight is not None:
        weights = torch.where(safe == 1.0, torch.full_like(safe, pos_weight), torch.ones_like(safe))
        scale = (pos_weight + 1.0) / 2.0
    return nll, weights, scale


def masked_binary_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    label_pad: int = LABEL_PAD,
    pos_weight: Optional[float] = None,
) -> torch.Tensor:
    """Binary CE from logits over (B, P) with -1 pads; positives weighted by
    ``pos_weight`` and the mean divided by (pos_weight + 1) / 2."""
    nll, weights, scale = binary_ce_items(logits, labels, label_pad, pos_weight)
    return masked_mean(nll, labels, label_pad, weights=weights) / scale


def masked_multilabel_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, label_pad: int = LABEL_PAD
) -> torch.Tensor:
    """Independent-sigmoid CE over (B, C) multi-hot labels with -1 pads."""
    return masked_binary_cross_entropy(logits, labels, label_pad=label_pad)
