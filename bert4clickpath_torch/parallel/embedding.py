"""Row-sharded embedding tables: lookup, vocab-parallel CE, distributed top-k
(counterpart of ``bert4clickpath_tpu/parallel/embedding.py``).

The item table lives row-sharded across the mesh's ``model`` group: each
rank holds its ``(V_local, D)`` shard, rows ``[row_start, row_start +
V_local)`` of the global table with ``row_start = model_index * V_local``.

* :func:`sharded_embedding_lookup` — each shard takes the rows it owns and
  an ``all_reduce`` sum over the model group assembles the full
  embeddings; its backward is the local masked scatter-add, with no
  collective (the output's gradient is the same on every model rank).
* :func:`sharded_softmax_cross_entropy` — vocab-parallel CE from partial
  logits, a global logsumexp by max and sum over the model group, the label
  logit from the owning shard. Forward value only (eval).
* :func:`sharded_fused_softmax_ce` and :func:`sharded_fused_softmax_ce_bias`
  (JAX ``ops/pallas/fused_ce.py:565-742``) — the training loss: each shard
  runs the fused-CE kernels with ``row_start = shard * V_local``, and the
  shards' statistics, label logit, dx and bias gradient are combined by
  ``all_reduce`` inside a hand-written forward and backward, which
  autograd never traces.
* :func:`sharded_top_k` and :func:`sharded_chunked_eval_stats` — per-shard
  top-k candidates combined into the exact global top-k; the chunked
  catalog scan per shard.

Collectives are ``all_reduce`` only (``parallel/mesh.py``), always on f32
(or integer) buffers, and run outside autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from bert4clickpath_torch.constants import LABEL_PAD
from bert4clickpath_torch.ops.chunked_eval import chunked_scores, pick_chunk, ranking_sums_from_topk
from bert4clickpath_torch.ops.fused_ce import _labels_model
from bert4clickpath_torch.ops.kernels.fused_ce import ce_backward, ce_stats
from bert4clickpath_torch.ops.metrics import psum_stats
from bert4clickpath_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, all_gather_stacked, all_reduce, sum_flat

NEG_BIG = -1e30  # blinds reserved/OOV/padding rows in f32 logits


def shard_info(mesh: Mesh) -> tuple[int, int]:
    """(this rank's shard index, number of shards) over the model group."""
    return mesh.model_index, mesh.model_size


def shard_row_start(mesh: Mesh, v_local: int) -> int:
    """The global row id of this rank's first table row."""
    return shard_info(mesh)[0] * v_local


class _ShardedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table_shard, ids, mesh, compute_dtype):
        v_local = table_shard.shape[0]
        local = ids.long() - shard_row_start(mesh, v_local)
        in_range = (local >= 0) & (local < v_local)
        safe = local.clamp(0, v_local - 1)
        rows = table_shard.detach()[safe].float()
        rows = torch.where(in_range[..., None], rows, torch.zeros_like(rows))
        # one nonzero term per row: the f32 sum then the cast equals the
        # JAX package's cast then psum
        all_reduce(rows, mesh, MODEL_AXIS)
        ctx.save_for_backward(safe, in_range)
        ctx.table_meta = (v_local, table_shard.dtype)
        return rows if compute_dtype is None else rows.to(compute_dtype)

    @staticmethod
    def backward(ctx, g):
        safe, in_range = ctx.saved_tensors
        v_local, dtype = ctx.table_meta
        g = torch.where(in_range[..., None], g, torch.zeros_like(g))
        flat_g = g.reshape(-1, g.shape[-1]).to(dtype)
        d_table = torch.zeros((v_local, g.shape[-1]), dtype=dtype, device=g.device)
        d_table.index_add_(0, safe.reshape(-1), flat_g)
        return d_table, None, None, None


def sharded_embedding_lookup(
    table_shard: torch.Tensor,  # (V_local, D) this rank's rows
    ids: torch.Tensor,  # (...,) global row ids
    mesh: Mesh,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """(..., D) full embeddings of global ids on every model rank; the
    gradient reaches only the rows this shard owns."""
    return _ShardedLookup.apply(table_shard, ids, mesh, compute_dtype)


def sharded_logits_local(
    x: torch.Tensor,  # (B, P, D)
    table_shard: torch.Tensor,  # (V_local, D)
    row_start: int = 0,
    row_offset: int = 0,
    num_valid: Optional[int] = None,
) -> torch.Tensor:
    """Partial tied-projection logits over this shard's rows (f32; products
    in x's dtype), rows outside ``[row_offset, row_offset + num_valid)`` (in
    global rows) blinded to -1e30."""
    logits = x.float() @ table_shard.to(x.dtype).float().T
    if num_valid is not None:
        rows = row_start + torch.arange(table_shard.shape[0], device=x.device)
        valid = (rows >= row_offset) & (rows < row_offset + num_valid)
        logits = torch.where(valid, logits, torch.full_like(logits, NEG_BIG))
    return logits


@torch.no_grad()
def sharded_softmax_cross_entropy(
    x: torch.Tensor,  # (B, P, D) gathered head inputs
    table_shard: torch.Tensor,  # (V_local, D)
    labels: torch.Tensor,  # (B, P) label-space ids, LABEL_PAD padded
    mesh: Mesh,
    row_offset: int = 0,
    num_valid: Optional[int] = None,
) -> torch.Tensor:
    """Globally normalized masked CE without the full logits: the mean over
    every row of the data group. Forward value only."""
    v_local = table_shard.shape[0]
    row_start = shard_row_start(mesh, v_local)
    logits = sharded_logits_local(x, table_shard, row_start, row_offset, num_valid)
    gmax = all_reduce(logits.max(dim=-1).values, mesh, MODEL_AXIS, "max")
    total = all_reduce(torch.exp(logits - gmax[..., None]).sum(dim=-1), mesh, MODEL_AXIS)
    logz = gmax + torch.log(total)
    safe = torch.where(labels == LABEL_PAD, 0, labels).long() + row_offset
    local = safe - row_start
    owned = (local >= 0) & (local < v_local)
    picked = logits.gather(-1, local.clamp(0, v_local - 1)[..., None])[..., 0]
    label_logit = all_reduce(torch.where(owned, picked, torch.zeros_like(picked)), mesh, MODEL_AXIS)
    mask = (labels != LABEL_PAD).float()
    total, count = sum_flat([((logz - label_logit) * mask).sum(), mask.sum()], mesh, DATA_AXIS)
    return total / count.clamp(min=1.0)


class _ShardedFusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table_shard, bias_full, labels, row_offset, num_valid, mesh):
        b, p, d = x.shape
        n = b * p
        xf = x.reshape(n, d)
        labf = labels.reshape(-1)
        lab = _labels_model(labf, row_offset)
        v_local = table_shard.shape[0]
        row_start = shard_row_start(mesh, v_local)
        brow = None if bias_full is None else bias_full[row_start : row_start + v_local].float()
        m, l = ce_stats(xf, table_shard, brow, row_offset, num_valid, row_start)
        gmax = all_reduce(m.clone(), mesh, MODEL_AXIS, "max")
        total = all_reduce(l * torch.exp(m - gmax), mesh, MODEL_AXIS)
        logz = gmax + torch.log(total)
        # the label logit: the owning shard's row dot, the others add 0
        local = lab.long() - row_start
        in_shard = (local >= 0) & (local < v_local)
        idx = local.clamp(0, v_local - 1)
        g = (xf.float() * table_shard[idx].to(x.dtype).float()).sum(dim=-1)
        if brow is not None:
            g = g + brow[idx]
        label_logit = all_reduce(torch.where(in_shard, g, torch.zeros_like(g)), mesh, MODEL_AXIS)
        # labels outside the window fail loudly, as _label_logit
        in_range = (lab >= row_offset) & (lab < row_offset + num_valid)
        label_logit = torch.where(in_range, label_logit, torch.full_like(label_logit, NEG_BIG))
        mask = (labf != LABEL_PAD).float()
        # the loss and the count over every row of the data group
        total, count = sum_flat([((logz - label_logit) * mask).sum(), mask.sum()], mesh, DATA_AXIS)
        count = count.clamp(min=1.0)
        ctx.save_for_backward(x, table_shard, brow, lab, logz, mask, count)
        ctx.meta = (row_offset, num_valid, row_start, mesh)
        ctx.bias_meta = None if bias_full is None else (bias_full.shape, bias_full.dtype)
        return total / count

    @staticmethod
    def backward(ctx, gbar):
        x, table_shard, brow, lab, logz, mask, count = ctx.saved_tensors
        row_offset, num_valid, row_start, mesh = ctx.meta
        b, p, d = x.shape
        dnll = ((gbar / count) * mask).float()
        dx, dw, db = ce_backward(
            x.reshape(b * p, d), table_shard, brow, lab, logz, dnll, row_offset, num_valid, row_start
        )
        # each shard's dx holds its rows' share: summed over the model group
        # in f32, rounded once to x's dtype
        dx = all_reduce(dx.float(), mesh, MODEL_AXIS).to(x.dtype).reshape(b, p, d)
        db_full = None
        if ctx.bias_meta is not None:
            # the bias is replicated: this shard's db in its window, summed
            shape, dtype = ctx.bias_meta
            db_full = torch.zeros(shape, dtype=torch.float32, device=db.device)
            db_full[row_start : row_start + db.shape[0]] = db
            db_full = all_reduce(db_full, mesh, MODEL_AXIS).to(dtype)
        return dx, dw.to(table_shard.dtype), db_full, None, None, None, None


def sharded_fused_softmax_ce(
    x: torch.Tensor,  # (B, P, D) this data shard's head inputs
    table_shard: torch.Tensor,  # (V_local, D) this model shard's rows
    labels: torch.Tensor,  # (B, P) label-space, LABEL_PAD padded
    row_offset: int,
    num_valid: int,
    mesh,
) -> torch.Tensor:
    """Vocab-parallel fused CE over a table row-sharded on the mesh's model
    group: the global masked-mean CE over every row of the data group, the
    same on every rank. Gradients flow to x (summed
    over the model group) and to the local table shard; the caller sums the
    parameters' gradients over the data group (the loss is already the
    global mean)."""
    return _ShardedFusedCE.apply(x, table_shard, None, labels, row_offset, num_valid, mesh)


def sharded_fused_softmax_ce_bias(
    x: torch.Tensor,
    table_shard: torch.Tensor,
    bias_full: torch.Tensor,  # (V_total,) model-space bias, replicated
    labels: torch.Tensor,
    row_offset: int,
    num_valid: int,
    mesh,
) -> torch.Tensor:
    """:func:`sharded_fused_softmax_ce` with a replicated model-space bias:
    each shard slices its row window, and the bias gradient comes back
    whole (every shard's window, summed) on every rank."""
    return _ShardedFusedCE.apply(x, table_shard, bias_full, labels, row_offset, num_valid, mesh)


def _merge_candidates(vals: torch.Tensor, idx: torch.Tensor, k: int, mesh: Mesh):
    """The exact top-k of every model rank's (..., kk) candidates."""
    all_vals = all_gather_stacked(vals, mesh, MODEL_AXIS)  # (S, ..., kk)
    all_idx = all_gather_stacked(idx, mesh, MODEL_AXIS)
    all_vals = all_vals.movedim(0, -2).reshape(*vals.shape[:-1], -1)
    all_idx = all_idx.movedim(0, -2).reshape(*vals.shape[:-1], -1)
    top_vals, sel = torch.topk(all_vals, k, dim=-1)
    return top_vals, all_idx.gather(-1, sel)


@torch.no_grad()
def sharded_top_k(
    logits_local: torch.Tensor,  # (..., V_local)
    k: int,
    mesh: Mesh,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact global top-k over the sharded vocabulary: (values, global
    indices), each (..., k), the same on every model rank. One gather of
    S * k candidates instead of V."""
    v_local = logits_local.shape[-1]
    vals, local_idx = torch.topk(logits_local, min(k, v_local), dim=-1)
    return _merge_candidates(vals, local_idx + shard_row_start(mesh, v_local), k, mesh)


@torch.no_grad()
def sharded_chunked_eval_stats(
    x: torch.Tensor,  # (B, P, D)
    table_shard: torch.Tensor,  # (V_local, D)
    labels: torch.Tensor,  # (B, P) label-space
    mesh: Mesh,
    ks=(5, 10),
    row_offset: int = 0,
    num_valid: Optional[int] = None,
    bias_shard: Optional[torch.Tensor] = None,  # (V_local,) this shard's logit bias
) -> dict[str, torch.Tensor]:
    """Full-catalog eval sums with a chunked scan of each shard (no (B, P,
    V_local) tile): a global logsumexp from the shards' logz, the label
    logit summed, the global top-k from each shard's candidates; summed
    over the data group."""
    v_local = table_shard.shape[0]
    row_start = shard_row_start(mesh, v_local)
    kmax = max(ks)
    logz_l, label_l, vals_l, rows_l = chunked_scores(
        x, table_shard, labels, kmax, row_offset=row_offset, num_valid=num_valid,
        chunk=pick_chunk(v_local, rows=x.shape[0] * x.shape[1]), bias=bias_shard, base_row=row_start,
    )
    gmax = all_reduce(logz_l.clone(), mesh, MODEL_AXIS, "max")
    total = all_reduce(torch.exp(logz_l - gmax), mesh, MODEL_AXIS)
    logz = gmax + torch.log(total)
    label_logit = all_reduce(label_l, mesh, MODEL_AXIS)
    _, top_rows = _merge_candidates(vals_l, rows_l, kmax, mesh)
    stats = ranking_sums_from_topk(logz, label_logit, top_rows - row_offset, labels, ks)
    return psum_stats(stats, mesh, DATA_AXIS)
