"""The expert layer's moves between tokens and the rows sorted by expert
(``models/deepseek_v2.py``): a weighted gather-sum and its weights'
gradient.

It replaces no Pallas kernel: the JAX package has no experts. The CUDA
kernels are ``bert4clickpath_torch/csrc/moe_gather.cu`` (bf16 rows, f32
sums, one warp a token); :func:`gather_sum_reference` and
:func:`gather_dot_reference` are their plain versions, which CPU tensors
take. An index outside ``[0, rows)`` names no row: it adds 0. Each launch
adds one to the counter ``kernels.moe_gather_sum`` or
``kernels.moe_gather_dot``. Neither reads anything back to the host.
"""

from __future__ import annotations

import torch

from bert4clickpath_torch.ops.kernels import _build

MAX_K = 16  # csrc/moe_gather.cu kMaxK


def _picked(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(T, k, D) f32: rows[idx], 0 where idx names no row."""
    inside = (idx >= 0) & (idx < rows.shape[0])
    got = rows.index_select(0, idx.clamp(0, rows.shape[0] - 1).reshape(-1)).view(*idx.shape, rows.shape[1])
    return got.float() * inside[..., None]


def gather_sum_reference(rows: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gather_sum`."""
    return (_picked(rows, idx) * w[..., None].float()).sum(1).to(rows.dtype)


def gather_dot_reference(rows: torch.Tensor, idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gather_dot`."""
    return (_picked(rows, idx) * g[:, None, :].float()).sum(-1)


def _check(rows, idx, other, what):
    t, k = idx.shape
    if rows.dim() != 2 or idx.dtype != torch.int64 or other.shape[0] != t:
        raise ValueError(f"rows (R, D), idx (T, k) int64 and {what} with T rows; got {tuple(rows.shape)}, "
                         f"{tuple(idx.shape)} {idx.dtype}, {tuple(other.shape)}")
    if not (rows.device == idx.device == other.device):
        raise ValueError(f"rows, idx and {what} must be on one device")


def _launch(entry, rows, idx, other, out, counter):
    if rows.dtype != torch.bfloat16 or rows.shape[1] % 8 or idx.shape[1] > MAX_K:
        raise ValueError(f"the kernel takes bf16 rows of a multiple of 8 and k <= {MAX_K}; got {rows.dtype}, "
                         f"{tuple(rows.shape)}, k {idx.shape[1]}")
    rows, idx, other = rows.contiguous(), idx.contiguous(), other.contiguous()
    if rows.data_ptr() % 16 or other.data_ptr() % 16:
        raise ValueError("the kernel needs 16-byte aligned rows")
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(_build.library(), entry)(
            rows.data_ptr(), idx.data_ptr(), other.data_ptr(), out.data_ptr(), idx.shape[0], idx.shape[1],
            rows.shape[1], rows.shape[0], rows.device.index, stream,
        )
    _build.check(code, entry)
    _build.count(counter)
    return out


def gather_sum(rows: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(T, D) in rows' dtype: ``sum_j w[t, j] * rows[idx[t, j]]``, f32 sums
    rounded once. rows (R, D), idx (T, k) int64, w (T, k) f32."""
    _check(rows, idx, w, "w")
    if rows.device.type == "cpu":
        return gather_sum_reference(rows, idx, w)
    out = torch.empty((idx.shape[0], rows.shape[1]), dtype=rows.dtype, device=rows.device)
    return _launch("b4cp_moe_gather_sum", rows, idx, w.float(), out, "moe_gather_sum")


def gather_dot(rows: torch.Tensor, idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(T, k) f32: ``<rows[idx[t, j]], g[t]>``. rows (R, D), idx (T, k)
    int64, g (T, D) of rows' dtype."""
    _check(rows, idx, g, "g")
    if rows.device.type == "cpu":
        return gather_dot_reference(rows, idx, g)
    out = torch.empty(idx.shape, dtype=torch.float32, device=rows.device)
    return _launch("b4cp_moe_gather_dot", rows, idx, g.to(rows.dtype), out, "moe_gather_dot")
