"""Masked multi-head attention over (B, L, D): forward and backward.

Counterpart of ``bert4clickpath_tpu/ops/pallas/attention.py:fused_mha``:
heads are column sub-ranges of D, the (B, 1, 1, L) f32 padding bias is
added after the 1/sqrt(Dh) scale, the softmax runs in f32, the
probabilities are rounded to v's dtype before the PV product, which
accumulates in f32, and the result is stored in the input dtype. The
backward (the JAX kernel's ``_mha_bwd_kernel``) recomputes p in f32, takes
dv from the unrounded p, rounds ds to k's dtype before dq and dk, and
stores each gradient in the input dtype.

The CUDA kernels are ``bert4clickpath_torch/csrc/attention.cu``;
:func:`mha_reference` and :func:`mha_backward_reference` are their plain
PyTorch versions, with the same roundings in the same order. :func:`mha`
is differentiable (an autograd Function over the two).

q, k and v may be column slices of one (B, L, 3D) projection: the kernels
read them through their strides (only the last dimension must be
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
    """Shared memory the forward kernel needs: K (padded rows), V, the bias
    row, and one q row + one score row per warp, all f32."""
    return 4 * (seq_len * (2 * head_dim + 2) + _WARPS * (head_dim + seq_len))


def mha_bwd_smem_bytes(seq_len: int, head_dim: int) -> int:
    """Shared memory the backward kernel needs: q, k, v and do (padded
    rows), the bias row, and the (L, L) p and ds, all f32."""
    return 4 * (4 * seq_len * (head_dim + 1) + seq_len + 2 * seq_len * (seq_len + 1))


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


def mha_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    do: torch.Tensor, num_heads: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel: (dq, dk, dv), with the
    JAX kernel's roundings (do and p in f32, dv from the unrounded p, ds
    rounded to k's dtype before dq and dk, each gradient in the input
    dtype)."""
    b, l, d = q.shape
    split = lambda t: t.unflatten(-1, (num_heads, d // num_heads)).float()  # noqa: E731
    scale = 1.0 / ((d // num_heads) ** 0.5)
    qf, kf, vf, dof = split(q), split(k), split(v), split(do)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale + bias.float()
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (p * dp).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(k.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return tuple(t.reshape(b, l, d).to(q.dtype) for t in (dq, dk, dv))


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
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def _launch_fwd(q, k, v, bias, num_heads):
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


def _check_bwd_fits(l, d, num_heads):
    smem = mha_bwd_smem_bytes(l, d // num_heads)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"the attention backward at L={l} needs {smem} bytes of shared "
            f"memory, more than one block holds ({MAX_SHARED_BYTES}); the "
            "blockwise backward kernels are not ported yet"
        )


def _launch_bwd(q, k, v, bias, do, num_heads):
    b, l, d = q.shape
    _check_bwd_fits(l, d, num_heads)
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a contiguous last dimension")
    do = do.to(q.dtype).contiguous()
    bias = bias.contiguous()
    dq, dk, dv = (torch.empty((b, l, d), dtype=q.dtype, device=q.device) for _ in range(3))
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.b4cp_mha_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            int(q.dtype == torch.bfloat16), b, l, d, num_heads,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1),
            1.0 / ((d // num_heads) ** 0.5), q.device.index, stream,
        )
    _build.check(code, "mha backward")
    _build.count("attention_bwd")
    return dq, dk, dv


def mha_backward(q, k, v, bias, do, num_heads):
    """(dq, dk, dv) for the output gradient ``do`` (B, L, D). CPU tensors
    take the plain version; CUDA tensors launch the backward kernel."""
    _check(q, k, v, bias, num_heads)
    if do.shape != q.shape or do.device != q.device:
        raise ValueError(f"do must be {tuple(q.shape)} on {q.device}, got {tuple(do.shape)} on {do.device}")
    if q.device.type == "cpu":
        return mha_backward_reference(q, k, v, bias, do, num_heads)
    return _launch_bwd(q, k, v, bias, do, num_heads)


class _MHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, num_heads):
        ctx.save_for_backward(q, k, v, bias)
        ctx.num_heads = num_heads
        if q.device.type == "cpu":
            return mha_reference(q, k, v, bias, num_heads)
        return _launch_fwd(q, k, v, bias, num_heads)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = mha_backward(q, k, v, bias, do, ctx.num_heads)
        return dq, dk, dv, None, None


def mha(
    q: torch.Tensor,  # (B, L, D)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,  # (B, 1, 1, L) f32
    num_heads: int,
) -> torch.Tensor:
    """(B, L, D) masked MHA, differentiable in q, k and v. CPU tensors take
    the plain versions; CUDA tensors launch the kernels."""
    _check(q, k, v, bias, num_heads)
    if q.device.type == "cuda" and torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v)
    ):
        # refuse up front rather than after the forward has run
        _check_bwd_fits(q.shape[1], q.shape[2], num_heads)
    return _MHA.apply(q, k, v, bias, num_heads)
