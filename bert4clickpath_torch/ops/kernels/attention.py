"""Masked multi-head attention forward over (B, L, D).

Counterpart of the forward of ``bert4clickpath_tpu/ops/pallas/attention.py:
fused_mha``: heads are column sub-ranges of D, the (B, 1, 1, L) f32
padding bias is added after the 1/sqrt(Dh) scale, the softmax runs in f32,
the probabilities are rounded to v's dtype before the PV product, which
accumulates in f32, and the result is stored in the input dtype. The CUDA
kernel is ``bert4clickpath_torch/csrc/attention.cu``; :func:`mha_reference`
is its plain PyTorch version, with the same roundings in the same order.

q, k and v may be column slices of one (B, L, 3D) projection: the kernel
reads them through their strides (only the last dimension must be
contiguous), so no copy is made.
"""

from __future__ import annotations

import torch

from bert4clickpath_torch.ops.kernels import _build

_DTYPES = (torch.bfloat16, torch.float32)
_WARPS = 8  # csrc/attention.cu kWarps
# largest dynamic shared memory one block may use on sm_90 (227 KB)
MAX_SHARED_BYTES = 232_448


def mha_smem_bytes(seq_len: int, head_dim: int) -> int:
    """Shared memory the kernel needs: K (padded rows), V, the bias row,
    and one q row + one score row per warp, all f32."""
    return 4 * (seq_len * (2 * head_dim + 2) + _WARPS * (head_dim + seq_len))


def mha_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    num_heads: int,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same roundings in the same order."""
    b, l, d = q.shape
    split = lambda t: t.unflatten(-1, (num_heads, d // num_heads)).float()  # noqa: E731
    scale = 1.0 / ((d // num_heads) ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", split(q), split(k)) * scale + bias.float()
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    o = torch.einsum("bhqk,bkhd->bqhd", p, split(v))
    return o.reshape(b, l, d).to(q.dtype)


def _check(q, k, v, bias, num_heads):
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must share one (B, L, D) shape, got "
            f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be bfloat16 or all float32, got {q.dtype} {k.dtype} {v.dtype}")
    b, l, d = q.shape
    if d % num_heads:
        raise ValueError(f"D={d} not divisible by num_heads={num_heads}")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (b, 1, 1, l):
        raise ValueError(f"bias must be ({b}, 1, 1, {l}) float32, got {tuple(bias.shape)} {bias.dtype}")
    if not (q.device == k.device == v.device == bias.device):
        raise ValueError("q, k, v and bias must be on one device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
        raise RuntimeError(
            "mha is forward-only (no autograd yet): call it under "
            "torch.no_grad() or torch.inference_mode()"
        )


def mha(
    q: torch.Tensor,  # (B, L, D)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,  # (B, 1, 1, L) f32
    num_heads: int,
) -> torch.Tensor:
    """(B, L, D) masked MHA. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    _check(q, k, v, bias, num_heads)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, bias, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, l, d = q.shape
    smem = mha_smem_bytes(l, d // num_heads)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"L={l} needs {smem} bytes of shared memory, more than one block "
            f"holds ({MAX_SHARED_BYTES}); the blockwise (K/V-streaming) "
            "attention kernel that covers long sequences is not ported yet"
        )
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a contiguous last dimension")
    bias = bias.contiguous()
    out = torch.empty((b, l, d), dtype=q.dtype, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.b4cp_mha_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, l, d, num_heads,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1),
            1.0 / ((d // num_heads) ** 0.5), q.device.index, stream,
        )
    _build.check(code, "mha")
    _build.count("attention")
    return out
