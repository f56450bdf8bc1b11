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
  tensor cores, on Hopper's TMA loads and ``wgmma`` products: the forward
  in 128-key steps of the online softmax, the backward's dq and dk/dv
  kernels from one C call on one set of tensor maps (q, k, v and do read
  through rank-4 tensor maps, :func:`_tma_operands`).

:func:`mha` is what the model calls. :func:`attention_family` picks the
family, the port's counterpart of ``fused_mha_supported`` (a VMEM rule
there): the whole-row kernels where their shared memory fits one block
(:func:`mha_smem_bytes`, and :func:`mha_bwd_smem_bytes` when a gradient is
needed; L <= 417 and L <= 116 at Dh = 64), the blockwise kernels otherwise.
No sequence length is refused; the blockwise kernels take a head width up
to 128 (their tiles are instantiated for 16, 32, 64 and 128). Heads whose
v is narrower than q and k, or another softmax scale (the DeepSeek-V2
block's latent attention, 192 and 128), take :func:`uneven_mha`: the
blockwise family's roundings, and on the card the kernels of
``csrc/attention_uneven.cu`` (a forward, a dq and a dk/dv kernel on the
tensor cores, the other side of each product resident in shared memory,
so L <= 256 there).

The CUDA kernels are ``bert4clickpath_torch/csrc/attention.cu`` (whole-row)
and ``csrc/attention_blockwise.cu`` (tiles and shared-memory use in its
header); :func:`mha_reference`, :func:`mha_backward_reference`,
:func:`blockwise_mha_reference`, :func:`blockwise_dq_reference` and
:func:`blockwise_dkv_reference` are their plain PyTorch versions, with the same roundings in the same
order. CPU tensors take the plain versions; CUDA tensors launch the kernels
or raise.

q, k and v may be column slices of one (B, L, 3D) projection: the kernels
read them through their strides (only the last dimension must be
contiguous), so no copy is made; the bf16 kernels copy only an input
whose base or strides are not multiples of 16 bytes (:func:`_tma_operands`).
"""

from __future__ import annotations

import torch

from bert4clickpath_torch.ops.kernels import _build
from bert4clickpath_torch.utils import profiling

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
    @profiling.span("b4cp.attention")
    def forward(ctx, q, k, v, bias, num_heads):
        ctx.save_for_backward(q, k, v, bias)
        ctx.num_heads = num_heads
        if q.device.type == "cpu":
            return mha_reference(q, k, v, bias, num_heads)
        return _launch_fwd(q, k, v, bias, num_heads)

    @staticmethod
    @profiling.span("b4cp.attention")
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
    num_heads: int, scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the blockwise forward, dense in f32:
    (out (B, L, H * Dv) in the input dtype, lse (B, L, H) f32). With one key
    tile the running maximum is the row maximum, so the un-normalised
    p = exp(s - max) is what rounds to v's dtype; l sums the unrounded p.
    ``scale`` (default 1 / sqrt(head width)) and a v narrower than q and k
    are the uneven kernels' (:func:`uneven_mha`)."""
    b, l, d = q.shape
    scale = 1.0 / ((d // num_heads) ** 0.5) if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", _split_heads(q, num_heads), _split_heads(k, num_heads))
    s = s * scale + bias.float()
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), _split_heads(v, num_heads))
    o = o / lsum.squeeze(-1).transpose(1, 2).unsqueeze(-1)
    lse = (m + torch.log(lsum)).squeeze(-1).transpose(1, 2).contiguous()
    return o.reshape(b, l, -1).to(q.dtype), lse


def attention_delta(do: torch.Tensor, out: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H) f32: sum over a head's columns of do * out, the row term of
    the softmax backward (plain XLA in the JAX package, plain PyTorch here)."""
    return (_split_heads(do, num_heads) * _split_heads(out, num_heads)).sum(-1)


def _recompute_p_ds(q, k, v, bias, lse, do, delta, num_heads, scale=None):
    """(p f32, ds rounded to the input dtype from that f32 p, q, k, do split
    by head in f32), what both backward kernels recompute from lse and
    delta."""
    scale = 1.0 / ((q.shape[-1] // num_heads) ** 0.5) if scale is None else scale
    qf, kf, vf, dof = (_split_heads(t, num_heads) for t in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale + bias.float()
    p = torch.exp(s - lse.transpose(1, 2).unsqueeze(-1))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = (p * (dp - delta.transpose(1, 2).unsqueeze(-1)) * scale).to(k.dtype).float()
    return p, ds, qf, kf, dof


def blockwise_dq_reference(q, k, v, bias, lse, do, delta, num_heads, scale=None) -> torch.Tensor:
    """Plain PyTorch version of the dq kernel: dq = ds . k, summed in f32
    and rounded once to the input dtype."""
    _, ds, _, kf, _ = _recompute_p_ds(q, k, v, bias, lse, do, delta, num_heads, scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds, kf).reshape(q.shape).to(q.dtype)


def blockwise_dkv_reference(q, k, v, bias, lse, do, delta, num_heads, scale=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dk/dv kernel: dk = ds^T . q and
    dv = p^T . do with p rounded to the input dtype first (as the forward
    rounds it before its PV product; the identity for f32 inputs), each
    summed in f32 and rounded once to the input dtype."""
    p, ds, qf, _, dof = _recompute_p_ds(q, k, v, bias, lse, do, delta, num_heads, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof)
    return dk.reshape(k.shape).to(q.dtype), dv.reshape(v.shape).to(q.dtype)


def blockwise_mha_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, delta: torch.Tensor, num_heads: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the blockwise backward: (dq, dk, dv) from
    the forward's lse and delta = :func:`attention_delta`."""
    args = (q, k, v, bias, lse, do, delta, num_heads)
    return (blockwise_dq_reference(*args), *blockwise_dkv_reference(*args))


def _check_blockwise(q, k, v, num_heads):
    dh = q.shape[-1] // num_heads
    if dh > BLOCKWISE_MAX_HEAD_DIM:
        raise ValueError(
            f"the blockwise kernels take a head width up to {BLOCKWISE_MAX_HEAD_DIM}, got {dh}"
        )
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a contiguous last dimension")


def _blockwise_args(q, k, v, bias, num_heads, *others):
    """What the blockwise C entries take after their pointers for f32
    inputs (the scalar kernels), and whether 4-element vector loads are
    allowed (head width, strides and base addresses); the kernels fill
    their tiles by plain loads otherwise."""
    _check_blockwise(q, k, v, num_heads)
    b, l, d = q.shape
    dh = d // num_heads
    chunk = 4  # elements of a vector load
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


def _tma_operands(q, k, v, bias, num_heads, *others, counter: str = "blockwise_fwd"):
    """(q, k, v, *others, bias, head stride in elements) as the bf16
    kernels' tensor maps take them: the forward's q, k and v, the
    backward's also do (``others``). A map describes one input over (head
    column, head, row, batch): its base and its head, row and batch strides
    (bytes) must be multiples of 16 (:func:`tma_describable`); the
    contiguous bias is one row of B L values, which needs only its base
    aligned. Strided slices of one (B, L, 3D) projection pass as they are.
    An input that fails gets a copy, counted on the copy counter under
    ``counter`` (``_build.copy_counts``; every main path reads 0 there): a
    contiguous (B, L, D) copy where the head width is a multiple of 16
    bytes, else every input becomes a zero-padded (B, L, H, dh') copy with
    dh' the head width rounded up to 16 bytes, whose pad columns lie past
    the map's dh and are never read."""
    b, l, d = q.shape
    dh = d // num_heads
    size = q.element_size()
    bias = bias.contiguous()
    if not tma_describable(bias.data_ptr(), ()):
        bias = bias.clone()
        _build.count_copy(counter)
    if (dh * size) % TMA_ALIGN:
        dhp = -(-dh * size // TMA_ALIGN) * TMA_ALIGN // size
        padded = []
        for t in (q, k, v, *others):
            c = t.new_zeros((b, l, num_heads, dhp))
            c[..., :dh] = t.unflatten(-1, (num_heads, dh))
            padded.append(c.flatten(2))
            _build.count_copy(counter)
        return (*padded, bias, dhp)
    out = []
    for t in (q, k, v, *others):
        if not tma_describable(t.data_ptr(), (dh * size, t.stride(1) * size, t.stride(0) * size)):
            t = torch.empty((b, l, d), dtype=t.dtype, device=t.device).copy_(t)
            _build.count_copy(counter)
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
        *head, scale, vec, device = _blockwise_args(q, k, v, bias, num_heads, out)
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


BWD_DQ, BWD_DKV = 1, 2  # the backward C entry's mask of kernels


def _launch_blockwise_bwd(which, q, k, v, bias, lse, do, delta, num_heads):
    """The backward kernels ``which`` names (a mask of BWD_DQ and BWD_DKV)
    in one C call, into fresh (B, L, D) tensors: (dq or None, dk or None,
    dv or None). In bf16 one set of tensor maps serves both kernels."""
    bias, lse, delta = bias.contiguous(), lse.contiguous(), delta.contiguous()
    do = do.to(q.dtype).contiguous()
    b, l, d = q.shape
    new = lambda wanted: torch.empty(q.shape, dtype=q.dtype, device=q.device) if wanted else None  # noqa: E731
    dq, dk, dv = new(which & BWD_DQ), new(which & BWD_DKV), new(which & BWD_DKV)
    outs = [t for t in (dq, dk, dv) if t is not None]
    if q.dtype == torch.bfloat16:
        # tensor maps: the head stride is the maps', the vector flag unused
        _check_blockwise(q, k, v, num_heads)
        q, k, v, do, bias, head_stride = _tma_operands(q, k, v, bias, num_heads, do, counter="blockwise_bwd")
        args = (1, b, l, d, num_heads, q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                do.stride(0), do.stride(1), head_stride, 1.0 / ((d // num_heads) ** 0.5), 0, which, q.device.index)
    else:
        *head, scale, vec, device = _blockwise_args(q, k, v, bias, num_heads, do, *outs)
        args = (*head, do.stride(0), do.stride(1), d // num_heads, scale, vec, which, device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        code = lib.b4cp_bmha_bwd(
            *(t.data_ptr() for t in (q, k, v, bias, lse, do, delta)),
            *(None if t is None else t.data_ptr() for t in (dq, dk, dv)),
            *args, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "blockwise mha backward")
    if which & BWD_DQ:
        _build.count("blockwise_dq")
    if which & BWD_DKV:
        _build.count("blockwise_dkv")
    return dq, dk, dv


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
    return _launch_blockwise_bwd(BWD_DQ, q, k, v, bias, lse, do, delta, num_heads)[0]


def blockwise_mha_dkv(q, k, v, bias, lse, do, delta, num_heads) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), as :func:`blockwise_mha_dq`: the dk/dv kernel on the card."""
    _check_bwd(q, k, v, bias, lse, do, delta, num_heads)
    if q.device.type == "cpu":
        return blockwise_dkv_reference(q, k, v, bias, lse, do, delta, num_heads)
    _, dk, dv = _launch_blockwise_bwd(BWD_DKV, q, k, v, bias, lse, do, delta, num_heads)
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
    kernel from one C call (one set of tensor maps for both; their plain
    versions on CPU tensors)."""
    if do.shape != out.shape:
        raise ValueError(f"do must be {tuple(out.shape)}, got {tuple(do.shape)}")
    args = (q, k, v, bias, lse, do, attention_delta(do, out, num_heads), num_heads)
    _check_bwd(*args)
    if q.device.type == "cpu":
        return (blockwise_dq_reference(*args), *blockwise_dkv_reference(*args))
    return _launch_blockwise_bwd(BWD_DQ | BWD_DKV, *args)


class _BlockwiseMHA(torch.autograd.Function):
    @staticmethod
    @profiling.span("b4cp.attention")
    def forward(ctx, q, k, v, bias, num_heads):
        out, lse = blockwise_mha_forward(q, k, v, bias, num_heads)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    @profiling.span("b4cp.attention")
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


# -- heads whose v is narrower than q and k, or another scale ----------------

UNEVEN_HEADS = ((192, 128),)  # (q/k, v) head widths of csrc/attention_uneven.cu's instance
_UNEVEN_TILE = 64  # rows of a block's own tile; resident rows are L rounded up to this


def uneven_smem_bytes(seq_len: int, dqk: int, dv: int) -> int:
    """Shared memory the largest of the uneven kernels (dk/dv) needs: its
    own 64 rows of k and v, all of q and do (L rounded up to 64), bf16 rows
    with 8 elements of skew, and the lse and delta rows in f32 (L <= 256 at
    (192, 128))."""
    rows = -(-seq_len // _UNEVEN_TILE) * _UNEVEN_TILE
    return 2 * (_UNEVEN_TILE + rows) * (dqk + dv + 16) + 4 * 2 * rows


def _check_uneven(q, k, v, bias, num_heads):
    if q.dim() != 3 or q.shape != k.shape or v.dim() != 3 or v.shape[:2] != q.shape[:2]:
        raise ValueError(f"q, k must share one (B, L, H * Dqk) shape and v its (B, L), got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if q.shape[2] % num_heads or v.shape[2] % num_heads:
        raise ValueError(f"q ({q.shape[2]}) and v ({v.shape[2]}) widths must divide into {num_heads} heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be bfloat16 or all float32, got {q.dtype} {k.dtype} {v.dtype}")
    b, l, _ = q.shape
    if bias.dtype != torch.float32 or tuple(bias.shape) != (b, 1, 1, l):
        raise ValueError(f"bias must be ({b}, 1, 1, {l}) float32, got {tuple(bias.shape)} {bias.dtype}")
    if not (q.device == k.device == v.device == bias.device):
        raise ValueError("q, k, v and bias must be on one device")
    if q.device.type == "cuda":
        heads = (q.shape[2] // num_heads, v.shape[2] // num_heads)
        if q.dtype != torch.bfloat16 or heads not in UNEVEN_HEADS:
            raise ValueError(f"the uneven kernels take bfloat16 heads of (q/k, v) widths {UNEVEN_HEADS}, "
                             f"got {q.dtype} {heads}")
        if uneven_smem_bytes(l, *heads) > MAX_SHARED_BYTES:
            raise ValueError(f"the uneven kernels at L={l} need {uneven_smem_bytes(l, *heads)} bytes of "
                             f"shared memory, more than one block holds ({MAX_SHARED_BYTES})")
    elif q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")


def _kernel_operands(*tensors):
    """Each tensor contiguous with a 16-byte aligned base, as the uneven
    kernels' 16-byte copies read it; the main path's are already."""
    out = [t.contiguous() for t in tensors]
    if any(t.data_ptr() % TMA_ALIGN for t in out):
        raise ValueError("the uneven kernels need 16-byte aligned inputs")
    return out


def _launch_uneven_fwd(q, k, v, bias, num_heads, scale):
    b, l, _ = q.shape
    q, k, v, bias = _kernel_operands(q, k, v, bias)
    out = torch.empty((b, l, v.shape[2]), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, l, num_heads), dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        code = lib.b4cp_umha_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, l, num_heads, q.shape[2] // num_heads, v.shape[2] // num_heads, float(scale),
            q.device.index, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "uneven mha")
    _build.count("uneven_fwd")
    return out, lse


def _launch_uneven_bwd(q, k, v, bias, lse, do, delta, num_heads, scale):
    b, l, _ = q.shape
    q, k, v, bias, lse, do, delta = _kernel_operands(q, k, v, bias, lse, do.to(q.dtype), delta)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.library()
    with torch.cuda.device(q.device):
        code = lib.b4cp_umha_bwd(
            *(t.data_ptr() for t in (q, k, v, bias, lse, do, delta, dq, dk, dv)),
            b, l, num_heads, q.shape[2] // num_heads, v.shape[2] // num_heads, float(scale),
            q.device.index, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "uneven mha backward")
    _build.count("uneven_bwd")
    return dq, dk, dv


def uneven_mha_forward(q, k, v, bias, num_heads, scale):
    """(out (B, L, H * Dv), lse (B, L, H) f32) of the uneven forward, no
    autograd. CPU tensors take the plain version
    (:func:`blockwise_mha_reference` with ``scale``); CUDA tensors launch
    the kernel."""
    _check_uneven(q, k, v, bias, num_heads)
    if q.device.type == "cpu":
        return blockwise_mha_reference(q, k, v, bias, num_heads, scale)
    return _launch_uneven_fwd(q, k, v, bias, num_heads, scale)


def uneven_mha_backward(q, k, v, bias, out, lse, do, num_heads, scale):
    """(dq, dk, dv) for the output gradient ``do`` from the forward's
    ``out`` and ``lse``: delta in plain PyTorch, then the dq and the dk/dv
    kernels from one C call (on CPU tensors :func:`blockwise_dq_reference`
    and :func:`blockwise_dkv_reference` with ``scale``)."""
    _check_uneven(q, k, v, bias, num_heads)
    if do.shape != out.shape or do.device != q.device:
        raise ValueError(f"do must be {tuple(out.shape)} on {q.device}, got {tuple(do.shape)} on {do.device}")
    args = (q, k, v, bias, lse, do, attention_delta(do, out, num_heads), num_heads, scale)
    if q.device.type == "cpu":
        return (blockwise_dq_reference(*args), *blockwise_dkv_reference(*args))
    return _launch_uneven_bwd(*args)


class _UnevenMHA(torch.autograd.Function):
    @staticmethod
    @profiling.span("b4cp.attention")
    def forward(ctx, q, k, v, bias, num_heads, scale):
        out, lse = uneven_mha_forward(q, k, v, bias, num_heads, scale)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    @profiling.span("b4cp.attention")
    def backward(ctx, do):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv = uneven_mha_backward(q, k, v, bias, out, lse, do, ctx.num_heads, ctx.scale)
        return dq, dk, dv, None, None, None


def uneven_mha(
    q: torch.Tensor,  # (B, L, H * Dqk)
    k: torch.Tensor,  # (B, L, H * Dqk)
    v: torch.Tensor,  # (B, L, H * Dv)
    bias: torch.Tensor,  # (B, 1, 1, L) f32
    num_heads: int,
    scale: float,
) -> torch.Tensor:
    """(B, L, H * Dv) masked MHA with heads whose v is narrower than q and k
    (the DeepSeek-V2 block's 192 and 128) at the softmax scale ``scale``,
    differentiable in q, k and v, with the blockwise family's roundings (the
    log-sum-exp is kept for the backward). CUDA tensors launch
    ``csrc/attention_uneven.cu`` (bf16, the heads of :data:`UNEVEN_HEADS`,
    L <= 256 there; anything else raises), CPU tensors take the plain
    versions."""
    _check_uneven(q, k, v, bias, num_heads)
    return _UnevenMHA.apply(q, k, v, bias, num_heads, scale)


def mha(
    q: torch.Tensor,  # (B, L, D)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,  # (B, 1, 1, L) f32
    num_heads: int,
    scale: float | None = None,
) -> torch.Tensor:
    """(B, L, D) masked MHA at any L, differentiable in q, k and v: the
    family :func:`attention_family` names. CPU tensors take the plain
    versions; CUDA tensors launch the kernels. Heads whose v is narrower
    than q and k, or a ``scale`` other than the kernels' 1 / sqrt(head
    width), take :func:`uneven_mha` ((B, L, H * Dv) out)."""
    if scale is not None or v.shape != q.shape:
        head = q.shape[-1] // num_heads
        return uneven_mha(q, k, v, bias, num_heads, head ** -0.5 if scale is None else scale)
    _check(q, k, v, bias, num_heads)
    family = attention_family(q.shape[1], q.shape[2] // num_heads, _needs_grad(q, k, v))
    return (fused_mha if family == "whole_row" else blockwise_mha)(q, k, v, bias, num_heads)
