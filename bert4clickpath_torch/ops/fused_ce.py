"""Fused tied-projection softmax cross-entropy (counterpart of
``bert4clickpath_tpu/ops/pallas/fused_ce.py:438-558``).

``nll = fused_softmax_ce(x, table, labels, row_offset, num_valid)`` is the
per-row NLL of ``labels`` under ``softmax(x . table^T)`` without the (N, V)
logits ever being stored: the forward takes the online max / sum-exp of
each row from ``ops/kernels/fused_ce.py:ce_stats`` and the backward
recomputes the scores in ``ce_backward``: once in the merged kernel for rows
up to 256 wide, twice in the two-pass pair above that (CUDA kernels on the
card, their plain versions on the CPU). The contract is the JAX package's:

* ``labels`` are label-space ids (N,); model-space row = label +
  ``row_offset``; table rows outside ``[row_offset, row_offset +
  num_valid)`` (reserved tokens, OOV, padding) are blinded to -1e30, so
  they get exactly zero probability;
* ``LABEL_PAD`` rows give nll 0 and no gradient;
* an OOV label (outside the window) gives an nll of about 1e30, so it
  fails loudly instead of reading a row excluded from the partition
  function;
* the label logit is a row gather and a row dot outside the kernel
  (``_label_logit``); the one-hot term of its gradient lives in the
  backward kernel.

x is f32 or bf16 and the arithmetic follows it (``w.astype(x.dtype)``);
the table is f32; nll is f32. :func:`dense_softmax_ce` is the dense f32
oracle of the same contract (differentiable by autograd), for tests.
"""

from __future__ import annotations

from typing import Optional

import torch

from bert4clickpath_torch.constants import LABEL_PAD
from bert4clickpath_torch.ops.kernels.fused_ce import NEG_BIG, ce_backward, ce_stats


def padded_rows(v: int) -> int:
    """Smallest row count >= v that the fused-CE vocab tile and
    chunked_eval's ``pick_chunk`` accept: a multiple of 128 below the 4096
    whole-table cutoff, of 1024 above, of 65536 past 1M rows. Padding rows
    are blinded by every consumer (chunked_scores)."""
    if v > 1_000_000:
        return v + (-v % 65536)
    return v + (-v % (1024 if v > 4096 else 128))


def _labels_model(labels: torch.Tensor, row_offset: int) -> torch.Tensor:
    """Model-space row of each label; pad rows get -1 (never a row)."""
    return torch.where(labels == LABEL_PAD, -1, labels + row_offset).to(torch.int32)


def _label_logit(x, table, lab_model, row_offset, num_valid, bias=None):
    """The label's logit by a row gather and a row dot, in x's dtype with
    f32 sums (as the kernel's scores); labels outside the window -> -1e30."""
    lab = lab_model.long().clamp(min=0)
    g = (x.float() * table[lab].to(x.dtype).float()).sum(dim=-1)
    if bias is not None:
        g = g + bias[lab]
    in_range = (lab_model >= row_offset) & (lab_model < row_offset + num_valid)
    return torch.where(in_range, g, torch.full_like(g, NEG_BIG))


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table, bias, labels, row_offset, num_valid):
        lab = _labels_model(labels, row_offset)
        m, l = ce_stats(x, table, bias, row_offset, num_valid)
        logz = m + torch.log(l)
        mask = (labels != LABEL_PAD).float()
        nll = (logz - _label_logit(x, table, lab, row_offset, num_valid, bias)) * mask
        ctx.save_for_backward(x, table, bias, lab, logz, mask)
        ctx.window = (row_offset, num_valid)
        return nll

    @staticmethod
    def backward(ctx, g):
        x, table, bias, lab, logz, mask = ctx.saved_tensors
        dnll = (g * mask).float()
        dx, dw, db = ce_backward(x, table, bias, lab, logz, dnll, *ctx.window)
        db = None if db is None else db.to(bias.dtype)
        return dx, dw.to(table.dtype), db, None, None, None


def fused_softmax_ce(
    x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor, row_offset: int, num_valid: int,
) -> torch.Tensor:
    """Per-row NLL of ``labels`` under softmax(x @ table^T) with row
    blinding. x (N, D); table (V, D); labels (N,) label-space, LABEL_PAD
    allowed (those rows return 0). Returns nll (N,) f32, differentiable in
    x and table."""
    return _FusedCE.apply(x, table, None, labels, row_offset, num_valid)


def fused_softmax_ce_bias(
    x: torch.Tensor, table: torch.Tensor, bias: torch.Tensor, labels: torch.Tensor,
    row_offset: int, num_valid: int,
) -> torch.Tensor:
    """``fused_softmax_ce`` with a per-row logit bias (V,) f32 aligned to
    the table's model-space rows, added before blinding; differentiable in
    x, table and bias."""
    return _FusedCE.apply(x, table, bias, labels, row_offset, num_valid)


def fused_masked_ce_sums(
    x: torch.Tensor,  # (B, P, D)
    table: torch.Tensor,  # (V, D) model-space rows
    labels: torch.Tensor,  # (B, P) label-space, LABEL_PAD padded
    row_offset: int,
    num_valid: int,
    bias: Optional[torch.Tensor] = None,  # (V,) per-row logit bias
) -> tuple[torch.Tensor, torch.Tensor]:
    """(nll_sum, mask_count): the data-parallel building block (reduce the
    sums outside autograd)."""
    b, p, d = x.shape
    flat = labels.reshape(-1)
    nll = _FusedCE.apply(x.reshape(b * p, d), table, bias, flat, row_offset, num_valid)
    return nll.sum(), (flat != LABEL_PAD).float().sum()


def fused_masked_softmax_cross_entropy(
    x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor, row_offset: int,
    num_valid: int, bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked-mean CE on top of the fused op (local mean)."""
    total, count = fused_masked_ce_sums(x, table, labels, row_offset, num_valid, bias=bias)
    return total / count.clamp(min=1.0)


def dense_softmax_ce(
    x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor, row_offset: int,
    num_valid: int, bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The same contract through dense f32 logits over the window's rows,
    differentiated by autograd: the oracle the fused op is held to."""
    rows = slice(row_offset, row_offset + num_valid)
    logits = x.float() @ table[rows].float().T
    if bias is not None:
        logits = logits + bias[rows].float()
    safe = torch.where(labels == LABEL_PAD, 0, labels).long()
    picked = logits.gather(1, safe[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - picked) * (labels != LABEL_PAD).float()
