"""Fused embedding gather + scale + position add.

Counterpart of ``bert4clickpath_tpu/ops/pallas/gather.py``:
``out[b, l, :] = table[ids[b, l], :] * scale + pos[l, :]``, computed in f32
and rounded once to the output dtype. The CUDA kernel is
``bert4clickpath_torch/csrc/gather.cu``; :func:`gather_scale_pos_reference`
is its plain PyTorch version. Any B*L is accepted (the TPU kernel's row
tiling is gone), and an id outside [0, V) traps on the device.

:func:`gather_scale_pos` is differentiable in the table and pos. Its
backward is the JAX package's ``fused_embed_scale_pos`` VJP (``_fesp_bwd``),
which is plain XLA there and plain PyTorch here
(:func:`gather_scale_pos_backward`): d_table = scatter-add of g * scale in
f32, cast to the table dtype; d_pos = the sum of g over the batch.
"""

from __future__ import annotations

import torch

from bert4clickpath_torch.ops.kernels import _build

_OUT_DTYPES = (torch.bfloat16, torch.float32)


def gather_scale_pos_reference(
    table: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor, scale: float,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same roundings."""
    return (table[ids.long()].float() * scale + pos.float()).to(out_dtype)


def gather_scale_pos_backward(
    g: torch.Tensor, ids: torch.Tensor, num_rows: int, scale: float,
    table_dtype: torch.dtype,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(d_table, d_pos) for the (B, L, D) output gradient ``g``: the
    scatter-add of g * scale into the rows ``ids`` name (f32, then the table
    dtype), and g summed over the batch (as ``_fesp_bwd``)."""
    d = g.shape[-1]
    g32 = g.float()
    d_table = torch.zeros((num_rows, d), dtype=torch.float32, device=g.device)
    d_table.index_add_(0, ids.reshape(-1).long(), g32.reshape(-1, d) * scale)
    return d_table.to(table_dtype), g32.sum(0).to(table_dtype)


def _check(table, ids, pos, out_dtype):
    if table.dim() != 2 or table.dtype != torch.float32:
        raise ValueError(f"table must be (V, D) float32, got {tuple(table.shape)} {table.dtype}")
    if ids.dim() != 2 or ids.dtype != torch.int32:
        raise ValueError(f"ids must be (B, L) int32, got {tuple(ids.shape)} {ids.dtype}")
    l, d = ids.shape[1], table.shape[1]
    if pos.dtype != torch.float32 or tuple(pos.shape) != (l, d):
        raise ValueError(f"pos must be ({l}, {d}) float32, got {tuple(pos.shape)} {pos.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    if not (table.device == ids.device == pos.device):
        raise ValueError("table, ids and pos must be on one device")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")


def _launch(table, ids, pos, scale, out_dtype):
    v, d = table.shape
    b, l = ids.shape
    if d % 4:
        raise ValueError(f"the kernel loads 16-byte rows: D={d} must be a multiple of 4")
    table, ids, pos = table.contiguous(), ids.contiguous(), pos.contiguous()
    if table.data_ptr() % 16 or pos.data_ptr() % 16:
        raise ValueError("table and pos must be 16-byte aligned")
    out = torch.empty((b, l, d), dtype=out_dtype, device=table.device)
    lib = _build.library()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.b4cp_gather_scale_pos(
            table.data_ptr(), ids.data_ptr(), pos.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.bfloat16), b * l, l, d, v, float(scale),
            table.device.index, stream,
        )
    _build.check(code, "gather_scale_pos")
    _build.count("gather")
    return out


class _GatherScalePos(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, pos, scale, out_dtype):
        ctx.save_for_backward(ids)
        ctx.scale = scale
        ctx.rows, ctx.table_dtype, ctx.pos_dtype = table.shape[0], table.dtype, pos.dtype
        if table.device.type == "cpu":
            return gather_scale_pos_reference(table, ids, pos, scale, out_dtype)
        return _launch(table, ids, pos, scale, out_dtype)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        d_table, d_pos = gather_scale_pos_backward(g, ids, ctx.rows, ctx.scale, ctx.table_dtype)
        return d_table, None, d_pos.to(ctx.pos_dtype), None, None


def gather_scale_pos(
    table: torch.Tensor,  # (V, D) f32
    ids: torch.Tensor,  # (B, L) int32
    pos: torch.Tensor,  # (L, D) f32
    scale: float,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(B, L, D) = table[ids] * scale + pos, rounded once to ``out_dtype``;
    differentiable in ``table`` and ``pos``.

    CPU tensors take the plain version; CUDA tensors launch the kernel (the
    backward is a plain scatter-add on either).
    """
    _check(table, ids, pos, out_dtype)
    return _GatherScalePos.apply(table, ids, pos, scale, out_dtype)
