"""Masked multi-head attention over (B, L, D): forward and backward.

Counterpart of ``bert4clickpath_tpu/ops/pallas/attention.py``. Heads are
column sub-ranges of D, the (B, 1, 1, L) f32 padding bias is added after
the 1/sqrt(Dh) scale, and the softmax runs in f32. Two kernel families,
as there:

* **whole-row** (``fused_mha`` there, :func:`fused_mha` here): one block
  holds a head's whole K and V (the backward also the (L, L) p and ds) in
  shared memory. The normalised probabilities are rounded to v's dtype
  before the PV product. The backward (``_mha_bwd_kernel``) recomputes p in
  f32, takes dv from the unrounded p, rounds ds to k's dtype before dq and
  dk, and stores each gradient in the input dtype. On the card bf16 inputs
  (head width up to 128) take a forward and a backward kernel whose
  products all run on the tensor cores (bf16 tiles of q, k, v and do, no
  (L, L) tile; in the backward p enters the dv product as two bf16 terms,
  hi + lo, which keeps the unrounded p: PERF.md, "the whole-row dv
  decision"); f32 inputs keep the scalar kernels.
* **blockwise** (``blockwise_mha``): K and V are streamed in tiles (128
  keys in the bf16 forward, 64 elsewhere) with an online softmax, so any L
  runs, also one that no tile divides. The
  forward rounds the *un-normalised* p = exp(s - m_running) to v's dtype
  before the PV product and divides by l once at the end; it keeps
  lse = m + log(l) per (row, head) as the residual. The backward (a dq
  kernel per query tile and a dk/dv kernel per key tile) recomputes
  p = exp(s - lse) in f32, takes dp = do . v^T in f32, rounds
  ds = p (dp - delta) scale (from the f32 p) to the input dtype before dq
  and dk, and rounds p to the input dtype before dv = p^T . do. That last
  rounding is the port's: the TPU kernel takes dv from the unrounded p. It
  is the identity in f32 and makes every product of the bf16 backward a
  bf16 x bf16 product with f32 sums, which is what the tensor cores take
  (measured on the card: see PERF.md, "the dv decision"). The TPU kernels
  add every tile pair's partial gradient into an output of the input dtype
  (one rounding per tile pair in bf16); the port sums in f32 and rounds
  once. delta = sum_dh(do * out) is plain PyTorch, as it is plain XLA
  there. lse = m + log(l) in f32 loses log(l) for a fully padded row
  (m = -1e9), there as here. On the card the input dtype alone picks the
  kernels, the forward's too: f32 inputs take scalar f32 FMA kernels (the
  exactness route), bf16 inputs take kernels whose products all run on the
  tensor cores: the forward on Hopper's TMA loads and ``wgmma`` products
  (128-key steps of the online softmax; q, k and v read through rank-4
  tensor maps, :func:`_tma_operands`), the backward on ``mma.sync`` with
  asynchronous double-buffered copies.

:func:`mha` is what the model calls. :func:`attention_family` picks the
family, the port's counterpart of ``fused_mha_supported`` (a VMEM rule
there): the whole-row kernels where their shared memory fits one block
(:func:`mha_smem_bytes`, and :func:`mha_bwd_smem_bytes` when a gradient is
needed; L <= 417 and L <= 116 at Dh = 64), the blockwise kernels otherwise.
No sequence length is refused; the blockwise kernels take a head width up
to 128 (their tiles are instantiated for 16, 32, 64 and 128).

The CUDA kernels are ``bert4clickpath_torch/csrc/attention.cu`` (whole-row)
and ``csrc/attention_blockwise.cu`` (tiles and shared-memory use in its
header); :func:`mha_reference`, :func:`mha_backward_reference`,
:func:`blockwise_mha_reference`, :func:`blockwise_dq_reference` and
:func:`blockwise_dkv_reference` are their plain PyTorch versions, with the same roundings in the same
order. CPU tensors take the plain versions; CUDA tensors launch the kernels
or raise.

q, k and v may be column slices of one (B, L, 3D) projection: the kernels
read them through their strides (only the last dimension must be
contiguous), so no copy is made; the bf16 forward copies only an input
whose base or strides are not multiples of 16 bytes (:func:`_tma_operands`).
"""

from __future__ import annotations

import torch

from bert4clickpath_torch.ops.kernels import _build

_DTYPES = (torch.bfloat16, torch.float32)
_WARPS = 8  # csrc/attention.cu kWarps
# largest dynamic shared memory one block may use on sm_90 (227 KB)
MAX_SHARED_BYTES = 232_448


def mha_smem_bytes(seq_len: int, head_dim: int) -> int:
    """Shared memory the scalar forward kernel needs: K (padded rows), V,
    the bias row, and one q row + one score row per warp, all f32. The
    dispatch holds both dtypes to this rule; the bf16 tensor-core kernel's
    bf16 tiles need less wherever their head fits a tile instance (its C
    entry keeps the scalar kernel where they would not)."""
    return 4 * (seq_len * (2 * head_dim + 2) + _WARPS * (head_dim + seq_len))


def mha_bwd_smem_bytes(seq_len: int, head_dim: int) -> int:
    """Shared memory the scalar backward kernel needs: q, k, v and do (padded
    rows), the bias row, and the (L, L) p and ds, all f32. The bf16
    tensor-core kernel needs less at every shape this admits (bf16 tiles, no
    (L, L) tile); the dispatch holds both dtypes to this one rule."""
    return 4 * (4 * seq_len * (head_dim + 1) + seq_len + 2 * seq_len * (seq_len + 1))


def _split_heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    return t.unflatten(-1, (num_heads, t.shape[-1] // num_heads)).float()


def mha_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    num_heads: int,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same roundings in the same order."""
    b, l, d = q.shape
    split = lambda t: _split_heads(t, num_heads)  # noqa: E731
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
    split = lambda t: _split_heads(t, num_heads)  # noqa: E731
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
            f"the whole-row kernel at L={l} needs {smem} bytes of shared "
            f"memory, more than one block holds ({MAX_SHARED_BYTES}); call "
            "mha, which takes blockwise_mha for such a length"
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
            f"the whole-row backward at L={l} needs {smem} bytes of shared "
            f"memory, more than one block holds ({MAX_SHARED_BYTES}); call "
            "mha, which takes blockwise_mha for such a length"
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


def fused_mha(
    q: torch.Tensor,  # (B, L, D)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,  # (B, 1, 1, L) f32
    num_heads: int,
) -> torch.Tensor:
    """(B, L, D) whole-row masked MHA, differentiable in q, k and v. CPU
    tensors take the plain versions; CUDA tensors launch the kernels, which
    need a head's whole row in one block's shared memory (see :func:`mha`)."""
    _check(q, k, v, bias, num_heads)
    if q.device.type == "cuda" and _needs_grad(q, k, v):
        # refuse up front rather than after the forward has run
        _check_bwd_fits(q.shape[1], q.shape[2], num_heads)
    return _MHA.apply(q, k, v, bias, num_heads)


# -- blockwise (K/V-streaming) family ---------------------------------------

BLOCKWISE_MAX_HEAD_DIM = 128  # csrc/attention_blockwise.cu launch_dh


def blockwise_mha_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    num_heads: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the blockwise forward, dense in f32:
    (out (B, L, D) in the input dtype, lse (B, L, H) f32). With one key
    tile the running maximum is the row maximum, so the un-normalised
    p = exp(s - max) is what rounds to v's dtype; l sums the unrounded p."""
    b, l, d = q.shape
    scale = 1.0 / ((d // num_heads) ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", _split_heads(q, num_heads), _split_heads(k, num_heads))
    s = s * scale + bias.float()
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), _split_heads(v, num_heads))
    o = o / lsum.squeeze(-1).transpose(1, 2).unsqueeze(-1)
    lse = (m + torch.log(lsum)).squeeze(-1).transpose(1, 2).contiguous()
    return o.reshape(b, l, d).to(q.dtype), lse


def attention_delta(do: torch.Tensor, out: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H) f32: sum over a head's columns of do * out, the row term of
    the softmax backward (plain XLA in the JAX package, plain PyTorch here)."""
    return (_split_heads(do, num_heads) * _split_heads(out, num_heads)).sum(-1)


def _recompute_p_ds(q, k, v, bias, lse, do, delta, num_heads):
    """(p f32, ds rounded to the input dtype from that f32 p, q, k, do split
    by head in f32), what both backward kernels recompute from lse and
    delta."""
    scale = 1.0 / ((q.shape[-1] // num_heads) ** 0.5)
    qf, kf, vf, dof = (_split_heads(t, num_heads) for t in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale + bias.float()
    p = torch.exp(s - lse.transpose(1, 2).unsqueeze(-1))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = (p * (dp - delta.transpose(1, 2).unsqueeze(-1)) * scale).to(k.dtype).float()
    return p, ds, qf, kf, dof


def blockwise_dq_reference(q, k, v, bias, lse, do, delta, num_heads) -> torch.Tensor:
    """Plain PyTorch version of the dq kernel: dq = ds . k, summed in f32
    and rounded once to the input dtype."""
    _, ds, _, kf, _ = _recompute_p_ds(q, k, v, bias, lse, do, delta, num_heads)
    return torch.einsum("bhqk,bkhd->bqhd", ds, kf).reshape(q.shape).to(q.dtype)


def blockwise_dkv_reference(q, k, v, bias, lse, do, delta, num_heads) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dk/dv kernel: dk = ds^T . q and
    dv = p^T . do with p rounded to the input dtype first (as the forward
    rounds it before its PV product; the identity for f32 inputs), each
    summed in f32 and rounded once to the input dtype."""
    p, ds, qf, _, dof = _recompute_p_ds(q, k, v, bias, lse, do, delta, num_heads)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof)
    return dk.reshape(q.shape).to(q.dtype), dv.reshape(q.shape).to(q.dtype)


def blockwise_mha_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, delta: torch.Tensor, num_heads: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the blockwise backward: (dq, dk, dv) from
    the forward's lse and delta = :func:`attention_delta`."""
    args = (q, k, v, bias, lse, do, delta, num_heads)
    return (blockwise_dq_reference(*args), *blockwise_dkv_reference(*args))


def _vector_chunk(dtype: torch.dtype) -> int:
    """Elements per vector access of the blockwise kernels that copy their
    own tiles: 4-element loads in the scalar f32 kernels, 8-element (16-byte)
    asynchronous copies in the bf16 backward kernels."""
    return 8 if dtype == torch.bfloat16 else 4


def _check_blockwise(q, k, v, num_heads):
    dh = q.shape[-1] // num_heads
    if dh > BLOCKWISE_MAX_HEAD_DIM:
        raise ValueError(
            f"the blockwise kernels take a head width up to {BLOCKWISE_MAX_HEAD_DIM}, got {dh}"
        )
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a contiguous last dimension")


def _blockwise_args(q, k, v, bias, num_heads, *others, chunk: int):
    """What every blockwise C entry takes after its pointers, and whether
    ``chunk``-element vector accesses are allowed (head width, strides and
    base addresses); the kernels fill their tiles by plain loads otherwise."""
    _check_blockwise(q, k, v, num_heads)
    b, l, d = q.shape
    dh = d // num_heads
    width = chunk * q.element_size()
    vec = dh % chunk == 0 and d % chunk == 0 and all(
        t.stride(0) % chunk == 0 and t.stride(1) % chunk == 0 and t.data_ptr() % width == 0
        for t in (q, k, v)
    ) and all(t.data_ptr() % width == 0 for t in others)
    return (
        int(q.dtype == torch.bfloat16), b, l, d, num_heads,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        1.0 / (dh ** 0.5), int(vec), q.device.index,
    )


TMA_ALIGN = 16  # bytes: a tensor map's base address and each of its strides


def tma_describable(data_ptr: int, strides_bytes) -> bool:
    """Whether a tensor map can describe an operand: its base address and
    every stride (bytes) a positive multiple of 16."""
    return data_ptr % TMA_ALIGN == 0 and all(s > 0 and s % TMA_ALIGN == 0 for s in strides_bytes)


def _tma_operands(q, k, v, bias, num_heads):
    """(q, k, v, bias, head stride in elements) as the bf16 forward's tensor
    maps take them. A map describes one input over (head column, head, row,
    batch): its base and its head, row and batch strides (bytes) must be
    multiples of 16 (:func:`tma_describable`); the contiguous bias is one
    row of B L values, which needs only its base aligned. Strided slices of
    one (B, L, 3D) projection pass as they are. An input that fails gets a
    copy, counted on the copy counter (``_build.copy_counts``; every main
    path reads 0 there): a contiguous (B, L, D) copy where the head width
    is a multiple of 16 bytes, else all three become zero-padded
    (B, L, H, dh') copies with dh' the head width rounded up to 16 bytes,
    whose pad columns lie past the map's dh and are never read."""
    b, l, d = q.shape
    dh = d // num_heads
    size = q.element_size()
    bias = bias.contiguous()
    if not tma_describable(bias.data_ptr(), ()):
        bias = bias.clone()
        _build.count_copy("blockwise_fwd")
    if (dh * size) % TMA_ALIGN:
        dhp = -(-dh * size // TMA_ALIGN) * TMA_ALIGN // size
        padded = []
        for t in (q, k, v):
            c = t.new_zeros((b, l, num_heads, dhp))
            c[..., :dh] = t.unflatten(-1, (num_heads, dh))
            padded.append(c.flatten(2))
            _build.count_copy("blockwise_fwd")
        return (*padded, bias, dhp)
    out = []
    for t in (q, k, v):
        if not tma_describable(t.data_ptr(), (dh * size, t.stride(1) * size, t.stride(0) * size)):
            t = torch.empty((b, l, d), dtype=t.dtype, device=t.device).copy_(t)
            _build.count_copy("blockwise_fwd")
        out.append(t)
    return (*out, bias, dh)


def _launch_blockwise_fwd(q, k, v, bias, num_heads):
    b, l, d = q.shape
    bias = bias.contiguous()
    out = torch.empty((b, l, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, l, num_heads), dtype=torch.float32, device=q.device)
    if q.dtype == torch.bfloat16:
        # tensor maps: the head stride is the map's, the vector flag unused
        _check_blockwise(q, k, v, num_heads)
        q, k, v, bias, head_stride = _tma_operands(q, k, v, bias, num_heads)
        args = (1, b, l, d, num_heads, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                v.stride(0), v.stride(1), head_stride, 1.0 / ((d // num_heads) ** 0.5), 0, q.device.index)
    else:
        *head, scale, vec, device = _blockwise_args(q, k, v, bias, num_heads, out, chunk=_vector_chunk(q.dtype))
        args = (*head, d // num_heads, scale, vec, device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        code = lib.b4cp_bmha_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *args, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "blockwise mha")
    _build.count("blockwise_fwd")
    return out, lse


def _launch_blockwise_bwd(entry, counter, n_out, q, k, v, bias, lse, do, delta, num_heads):
    """One backward kernel (``entry``) into ``n_out`` fresh (B, L, D) tensors."""
    bias, lse, delta = bias.contiguous(), lse.contiguous(), delta.contiguous()
    do = do.to(q.dtype).contiguous()
    outs = [torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(n_out)]
    args = _blockwise_args(q, k, v, bias, num_heads, do, *outs, chunk=_vector_chunk(q.dtype))
    lib = _build.library()
    with torch.cuda.device(q.device):
        code = getattr(lib, entry)(
            *(t.data_ptr() for t in (q, k, v, bias, lse, do, delta, *outs)),
            *args, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, entry)
    _build.count(counter)
    return outs


def _check_bwd(q, k, v, bias, lse, do, delta, num_heads):
    _check(q, k, v, bias, num_heads)
    b, l, _ = q.shape
    if do.shape != q.shape or do.device != q.device:
        raise ValueError(f"do must be {tuple(q.shape)} on {q.device}, got {tuple(do.shape)} on {do.device}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, l, num_heads) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(
                f"{name} must be ({b}, {l}, {num_heads}) float32 on {q.device}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}"
            )


def blockwise_mha_dq(q, k, v, bias, lse, do, delta, num_heads) -> torch.Tensor:
    """dq from the forward's lse and delta = :func:`attention_delta`. CPU
    tensors take the plain version; CUDA tensors launch the dq kernel."""
    _check_bwd(q, k, v, bias, lse, do, delta, num_heads)
    if q.device.type == "cpu":
        return blockwise_dq_reference(q, k, v, bias, lse, do, delta, num_heads)
    return _launch_blockwise_bwd("b4cp_bmha_dq", "blockwise_dq", 1, q, k, v, bias, lse, do, delta, num_heads)[0]


def blockwise_mha_dkv(q, k, v, bias, lse, do, delta, num_heads) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), as :func:`blockwise_mha_dq`: the dk/dv kernel on the card."""
    _check_bwd(q, k, v, bias, lse, do, delta, num_heads)
    if q.device.type == "cpu":
        return blockwise_dkv_reference(q, k, v, bias, lse, do, delta, num_heads)
    dk, dv = _launch_blockwise_bwd("b4cp_bmha_dkv", "blockwise_dkv", 2, q, k, v, bias, lse, do, delta, num_heads)
    return dk, dv


def blockwise_mha_forward(q, k, v, bias, num_heads):
    """(out, lse) of the blockwise forward, no autograd. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    _check(q, k, v, bias, num_heads)
    if q.device.type == "cpu":
        return blockwise_mha_reference(q, k, v, bias, num_heads)
    return _launch_blockwise_fwd(q, k, v, bias, num_heads)


def blockwise_mha_backward(q, k, v, bias, out, lse, do, num_heads):
    """(dq, dk, dv) for the output gradient ``do``, from the forward's
    ``out`` and ``lse``: delta in plain PyTorch, then the dq and the dk/dv
    kernel (their plain versions on CPU tensors)."""
    if do.shape != out.shape:
        raise ValueError(f"do must be {tuple(out.shape)}, got {tuple(do.shape)}")
    args = (q, k, v, bias, lse, do, attention_delta(do, out, num_heads), num_heads)
    return (blockwise_mha_dq(*args), *blockwise_mha_dkv(*args))


class _BlockwiseMHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, num_heads):
        out, lse = blockwise_mha_forward(q, k, v, bias, num_heads)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv = blockwise_mha_backward(q, k, v, bias, out, lse, do, ctx.num_heads)
        return dq, dk, dv, None, None


def blockwise_mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    num_heads: int,
) -> torch.Tensor:
    """(B, L, D) blockwise masked MHA at any L, differentiable in q, k and
    v (the per-(row, head) log-sum-exp is kept for the backward)."""
    _check(q, k, v, bias, num_heads)
    return _BlockwiseMHA.apply(q, k, v, bias, num_heads)


# -- the dispatch -----------------------------------------------------------


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def attention_family(seq_len: int, head_dim: int, needs_grad: bool) -> str:
    """``"whole_row"`` where the whole-row kernels' shared memory fits one
    block (the backward's too when a gradient is needed), else
    ``"blockwise"``. The same rule on the CPU, so that a path takes the same
    family's plain versions there as it takes kernels on the card."""
    fits = mha_smem_bytes(seq_len, head_dim) <= MAX_SHARED_BYTES and (
        not needs_grad or mha_bwd_smem_bytes(seq_len, head_dim) <= MAX_SHARED_BYTES
    )
    return "whole_row" if fits else "blockwise"


def mha(
    q: torch.Tensor,  # (B, L, D)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,  # (B, 1, 1, L) f32
    num_heads: int,
) -> torch.Tensor:
    """(B, L, D) masked MHA at any L, differentiable in q, k and v: the
    family :func:`attention_family` names. CPU tensors take the plain
    versions; CUDA tensors launch the kernels."""
    _check(q, k, v, bias, num_heads)
    family = attention_family(q.shape[1], q.shape[2] // num_heads, _needs_grad(q, k, v))
    return (fused_mha if family == "whole_row" else blockwise_mha)(q, k, v, bias, num_heads)
