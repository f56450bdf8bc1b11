"""Full-catalog scoring without materializing logits: chunked scan + top-k merge.

Counterpart of ``bert4clickpath_tpu/ops/chunked_eval.py``. The JAX
``lax.scan`` over vocab chunks becomes a Python loop: per chunk the tied
projection computes (N, C) logits in f32, folds them into a running
(max, sumexp, label-logit, top-k) carry and discards them, so peak memory is
O(N*C) instead of O(N*V). Plain PyTorch (no kernel): the JAX package also
leaves this scan to XLA.

All arithmetic is f32, as in the JAX version (``chunked_eval.py:105,115``);
TF32 is left off, so the matmul runs in full f32 on the card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from bert4clickpath_torch.constants import LABEL_PAD

NEG_BIG = -1e30


def pick_chunk(v: int, target: int = 0, rows: int = 0) -> int:
    """Largest chunk <= target dividing v; raises rather than falling back to
    a full-table chunk. Default target scales with the table (65536 at >1M
    rows, else 8192). ``rows``: the scoring row count (B*P) when known; the
    target halves until the (rows, chunk) f32 logits tile stays <= 256 MB.
    """
    if not target:
        target = 65536 if v > 1_000_000 else 8192
    if rows:
        while target > 128 and rows * target * 4 > (256 << 20):
            target //= 2
    for c in (target, 32768, 16384, 8192, 4096, 2048, 1024, 512, 256, 128):
        if c <= target and v % c == 0:
            return c
    if v <= 8192:
        return v
    raise ValueError(
        f"table rows {v} not divisible by any eval chunk; pad rows "
        "(ops.fused_ce.padded_rows)"
    )


def ranking_sums_from_topk(
    logz: torch.Tensor,  # (B, P)
    label_logit: torch.Tensor,  # (B, P)
    top_labels: torch.Tensor,  # (B, P, kmax) label-space ids
    labels: torch.Tensor,  # (B, P)
    ks: Sequence[int],
    label_pad: int = LABEL_PAD,
) -> dict[str, torch.Tensor]:
    """loss/recall/NDCG sums given top-k results."""
    kmax = max(ks)
    mask = (labels != label_pad).float()
    nll = (logz - label_logit) * mask
    hit = (top_labels == labels[..., None]).float()
    discounts = 1.0 / (
        torch.log(torch.arange(2, kmax + 2, dtype=torch.float32, device=logz.device))
        / torch.log(torch.tensor(2.0, device=logz.device))
    )
    stats = {"n": mask.sum(), "loss_sum": nll.sum()}
    for k in ks:
        stats[f"recall@{k}_sum"] = (hit[..., :k].sum(-1) * mask).sum()
        stats[f"ndcg@{k}_sum"] = ((hit[..., :k] * discounts[:k]).sum(-1) * mask).sum()
    return stats


def chunked_scores(
    x: torch.Tensor,  # (B, P, D) head inputs
    table: torch.Tensor,  # (V, D) projection rows (model space)
    labels: torch.Tensor,  # (B, P) label-space ids, LABEL_PAD padded
    k: int,
    row_offset: int = 0,
    num_valid: Optional[int] = None,
    chunk: int = 8192,
    bias: Optional[torch.Tensor] = None,  # (V,) per-row logit bias, model space
):
    """Returns (logz, label_logit, topk_vals, topk_rows) with global row ids
    (int64). Rows outside ``[row_offset, row_offset + num_valid)`` are
    blinded to ``NEG_BIG``. Requires V % chunk == 0 (pad the table)."""
    v, d = table.shape
    if v % chunk:
        raise ValueError(f"table rows {v} not divisible by chunk {chunk}")
    b, p, _ = x.shape
    n = b * p
    dev = x.device
    xf = x.reshape(n, d).float()
    flat = labels.reshape(-1).long()
    labels_model = torch.where(flat == LABEL_PAD, -1, flat + row_offset)
    rows_all = torch.arange(v, dtype=torch.int64, device=dev)
    valid_all = None
    if num_valid is not None:
        valid_all = (rows_all >= row_offset) & (rows_all < row_offset + num_valid)
    kc = min(k, chunk)

    m = torch.full((n,), NEG_BIG, dtype=torch.float32, device=dev)
    l = torch.zeros((n,), dtype=torch.float32, device=dev)
    g = torch.zeros((n,), dtype=torch.float32, device=dev)
    tv = torch.full((n, k), NEG_BIG, dtype=torch.float32, device=dev)
    ti = torch.full((n, k), -1, dtype=torch.int64, device=dev)
    for start in range(0, v, chunk):
        sl = slice(start, start + chunk)
        logits = xf @ table[sl].float().T  # (n, C)
        if bias is not None:
            logits = logits + bias[sl].float()[None, :]
        if valid_all is not None:
            logits = torch.where(valid_all[sl][None, :], logits, NEG_BIG)
        # online logsumexp
        m_new = torch.maximum(m, logits.max(dim=1).values)
        l = l * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=1)
        m = m_new
        # label logit: the label's column when it falls in this chunk
        local = labels_model - start
        hit = (local >= 0) & (local < chunk)
        picked = logits.gather(1, local.clamp(0, chunk - 1)[:, None])[:, 0]
        g = g + torch.where(hit, picked, 0.0)
        # running top-k: merge the chunk's top-k with the carry
        cv, cidx = torch.topk(logits, kc, dim=1)
        av = torch.cat([tv, cv], dim=1)
        ar = torch.cat([ti, cidx + start], dim=1)
        tv, sel = torch.topk(av, k, dim=1)
        ti = ar.gather(1, sel)
    logz = m + torch.log(torch.clamp(l, min=1e-30))
    return (
        logz.reshape(b, p),
        g.reshape(b, p),
        tv.reshape(b, p, k),
        ti.reshape(b, p, k),
    )

