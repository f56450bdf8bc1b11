"""Fused embedding gather + scale + position add (forward).

Counterpart of ``bert4clickpath_tpu/ops/pallas/gather.py``:
``out[b, l, :] = table[ids[b, l], :] * scale + pos[l, :]``, computed in f32
and rounded once to the output dtype. The CUDA kernel is
``bert4clickpath_torch/csrc/gather.cu``; :func:`gather_scale_pos_reference`
is its plain PyTorch version. Any B*L is accepted (the TPU kernel's row
tiling is gone), and an id outside [0, V) traps on the device.
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
    if torch.is_grad_enabled() and (table.requires_grad or pos.requires_grad):
        raise RuntimeError(
            "gather_scale_pos is forward-only (no autograd yet): call it under "
            "torch.no_grad() or torch.inference_mode()"
        )


def gather_scale_pos(
    table: torch.Tensor,  # (V, D) f32
    ids: torch.Tensor,  # (B, L) int32
    pos: torch.Tensor,  # (L, D) f32
    scale: float,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(B, L, D) = table[ids] * scale + pos, rounded once to ``out_dtype``.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    _check(table, ids, pos, out_dtype)
    if table.device.type == "cpu":
        return gather_scale_pos_reference(table, ids, pos, scale, out_dtype)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
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
