"""Masked losses over padded label tensors (counterpart of
``bert4clickpath_tpu/ops/losses.py``).

Labels are always fixed-shape with ``LABEL_PAD`` fill; losses take logits
and run in f32; the masked mean divides by ``max(count, 1)``. The JAX
versions' ``axis_name`` (a psum of sums and counts across devices) is left
out: the port's data-parallel tier (``parallel/spmd.py``) reduces sums and
counts outside autograd instead.

``sampled_softmax_ce`` takes its negatives as an argument:
:func:`sample_negatives` draws them from an explicit ``torch.Generator``
(the JAX version draws them from ``jax.random`` inside; the bits cannot
match, so tests pass the JAX package's negatives in). Plain PyTorch, as it
is plain XLA in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
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


def sample_negatives(num_valid: int, num_samples: int, generator: torch.Generator) -> torch.Tensor:
    """(num_samples,) int64 label-space ids drawn uniformly from [0,
    num_valid) with replacement, on the generator's device: the batch-shared
    negatives of :func:`sampled_softmax_ce`."""
    return torch.randint(0, num_valid, (num_samples,), generator=generator, device=generator.device)


def sampled_softmax_ce(
    x: torch.Tensor,  # (N, D) head inputs
    table: torch.Tensor,  # (V, D) catalog rows (model space)
    labels: torch.Tensor,  # (N,) label-space ids, LABEL_PAD allowed
    row_offset: int,
    num_valid: int,
    negatives: torch.Tensor,  # (S,) label-space ids (sample_negatives)
    bias: Optional[torch.Tensor] = None,  # (V,) model-space logit bias
    take: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,  # model-space ids -> rows
) -> torch.Tensor:
    """Per-row sampled-softmax NLL over a tied catalog projection: the
    label's logit against S batch-shared negatives instead of all V rows.

    Negatives get ``+log(num_valid / S)`` (the -log Q correction of a
    uniform sampler; the always-present positive has Q = 1), and an
    accidental hit (a negative equal to the row's own label) is blinded to
    -1e30. Products in x's dtype with f32 sums, as the fused CE. Returns nll
    (N,) f32 with 0 at LABEL_PAD rows; differentiable in x, table and bias
    (only the S + N gathered rows get a gradient). ``take``: how the
    labels' and the negatives' rows are read, ``table[ids]`` by default
    (the sampled SPMD tier reads a row-sharded table through its sharded
    lookup)."""
    if take is None:
        take = table.__getitem__
    s = negatives.shape[0]
    neg_lab = negatives.long()
    lab_safe = labels.long().clamp(min=0)
    xf = x.float()
    w_pos = take(lab_safe + row_offset).to(x.dtype).float()  # (N, D)
    w_neg = take(neg_lab + row_offset).to(x.dtype).float()  # (S, D)
    pos = (xf * w_pos).sum(dim=-1)
    neg = xf @ w_neg.T
    if bias is not None:
        b = bias.float()
        pos = pos + b[lab_safe + row_offset]
        neg = neg + b[neg_lab + row_offset]
    # importance correction (f32, as the JAX version), then accidental hits
    correction = float(np.log(np.float32(num_valid) / np.float32(s)))
    neg = neg + correction
    hit = neg_lab[None, :] == lab_safe[:, None]
    neg = torch.where(hit, torch.full_like(neg, -1e30), neg)
    m = torch.maximum(pos, neg.max(dim=-1).values)
    logz = m + torch.log(torch.exp(pos - m) + torch.exp(neg - m[:, None]).sum(dim=-1))
    mask = (labels != LABEL_PAD).float()
    return (logz - pos) * mask
