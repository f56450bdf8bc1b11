"""Grouped expert products over a buffer of rows sorted by expert.

It replaces no Pallas kernel: the JAX package has no experts. It was added
for the DeepSeek-V2 block's expert layer (``models/deepseek_v2.py:MoE``),
whose routed (token, expert) rows are sorted by expert on the device, each
expert's rows padded to a multiple of :data:`GROUP_ROWS` with zero rows
(``route``), so that ``offsets`` (E + 1,) int32 on the device say where each
expert's rows start and where the last ends. Nothing about the split is read
on the host: the kernel walks it on the device.

Three products, for expert weights ``w`` (E, N, K):

* :func:`grouped_mm`: ``y[r] = x[r] @ w[e(r)]^T`` for each row r of expert
  e(r): the forward (x (R, K), y (R, N));
* :func:`grouped_mm_w`: ``dx[r] = dy[r] @ w[e(r)]``, the input gradient,
  with ``w`` read as it lies;
* :func:`grouped_mm_dw`: ``dw[e] = dy[rows of e]^T @ x[rows of e]`` (E, N,
  K), in f32: a reduction over each expert's rows, ragged.

Rows past ``offsets[E]`` come out 0 in ``y`` (and the padding rows, which
are 0 in ``x``, too); an expert without rows gets a ``dw`` of 0.

On the card (``csrc/grouped_gemm.cu``) bf16 operands with f32 sums, on
TMA loads and ``wgmma``: persistent blocks, one an SM, walk (expert,
128-row tile, 128-column tile) units built on the device from ``offsets``;
``dw`` reads ``dy`` and ``x`` as they lie, each chunk 64 of an expert's rows
(the products take both operands transposed). What bounds it and its design are in the
source's header. The plain versions (:func:`grouped_mm_reference`,
:func:`grouped_mm_dw_reference`: a per-expert loop of ``torch.mm``) are the
CPU route and the tests' oracle. Each launch adds one to the counter
``kernels.grouped_gemm``.

:func:`grouped_linear` is what the model calls: ``y = x @ w[e]^T`` with f32
``w`` cast to x's dtype, differentiable in x and w.
"""

from __future__ import annotations

import torch

from bert4clickpath_torch.ops.kernels import _build

GROUP_ROWS = 128  # csrc/grouped_gemm.cu kBM: an expert's rows are padded to a multiple
K_STEP = 64  # csrc/grouped_gemm.cu kBK: the reduction's chunk
COLS = 128  # csrc/grouped_gemm.cu kBN: an output tile's columns
MODE_ROWS, MODE_DW, MODE_ROWS_W = 0, 1, 2


def grouped_mm_reference(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`grouped_mm`: products in x's dtype (f32 sums
    on the card, as ``torch.mm``), rows past the last expert 0."""
    off = offsets.tolist()
    y = torch.zeros((x.shape[0], w.shape[1]), dtype=x.dtype, device=x.device)
    for e in range(w.shape[0]):
        if off[e + 1] > off[e]:
            y[off[e] : off[e + 1]] = x[off[e] : off[e + 1]] @ w[e].t()
    return y


def grouped_mm_w_reference(dy: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`grouped_mm_w`."""
    return grouped_mm_reference(dy, w.transpose(1, 2), offsets)


def grouped_mm_dw_reference(dy: torch.Tensor, x: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`grouped_mm_dw`, f32 out."""
    off = offsets.tolist()
    n = len(off) - 1
    dw = torch.zeros((n, dy.shape[1], x.shape[1]), dtype=torch.float32, device=x.device)
    for e in range(n):
        if off[e + 1] > off[e]:
            dw[e] = (dy[off[e] : off[e + 1]].t() @ x[off[e] : off[e + 1]]).float()
    return dw


def _check_offsets(offsets: torch.Tensor, experts: int, device) -> None:
    if offsets.dtype != torch.int32 or tuple(offsets.shape) != (experts + 1,) or offsets.device != device:
        raise ValueError(f"offsets must be ({experts + 1},) int32 on {device}, got "
                         f"{tuple(offsets.shape)} {offsets.dtype} on {offsets.device}")


def _check_card(*tensors) -> None:
    for t in tensors:
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"the grouped GEMM kernel takes contiguous bfloat16, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError("the grouped GEMM kernel needs 16-byte aligned operands")


def _launch(a, b, out, offsets, mode, m, n, k, experts):
    lib = _build.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.b4cp_grouped_gemm(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), offsets.data_ptr(), mode, m, n, k, experts,
            a.device.index, stream,
        )
    _build.check(code, "grouped_gemm")
    _build.count("grouped_gemm")
    return out


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(R, N): ``x[r] @ w[e(r)]^T`` over the experts' rows, 0 past
    ``offsets[E]``; x (R, K), w (E, N, K) of x's dtype. CPU tensors take the
    plain version; CUDA tensors the kernel (bf16, R a multiple of
    ``GROUP_ROWS``, N of ``COLS``, K of ``K_STEP``)."""
    r, k = x.shape
    e, n, k2 = w.shape
    if k2 != k or w.dtype != x.dtype or w.device != x.device:
        raise ValueError(f"w must be (E, N, {k}) {x.dtype} on {x.device}, got {tuple(w.shape)} {w.dtype}")
    _check_offsets(offsets, e, x.device)
    if x.device.type == "cpu":
        return grouped_mm_reference(x, w, offsets)
    _check_card(x, w)
    if r % GROUP_ROWS or n % COLS or k % K_STEP:
        raise ValueError(f"the kernel takes R % {GROUP_ROWS}, N % {COLS}, K % {K_STEP} == 0; got {r}, {n}, {k}")
    out = torch.empty((r, n), dtype=x.dtype, device=x.device)
    return _launch(x, w, out, offsets, MODE_ROWS, r, n, k, e)


def grouped_mm_w(dy: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(R, K): ``dy[r] @ w[e(r)]`` over the experts' rows, 0 past
    ``offsets[E]``; dy (R, N), w (E, N, K) of dy's dtype. CPU tensors take
    the plain version; CUDA tensors the kernel (bf16, R a multiple of
    ``GROUP_ROWS``, K of ``COLS``, N of ``K_STEP``)."""
    r, n = dy.shape
    e, n2, k = w.shape
    if n2 != n or w.dtype != dy.dtype or w.device != dy.device:
        raise ValueError(f"w must be (E, {n}, K) {dy.dtype} on {dy.device}, got {tuple(w.shape)} {w.dtype}")
    _check_offsets(offsets, e, dy.device)
    if dy.device.type == "cpu":
        return grouped_mm_w_reference(dy, w, offsets)
    _check_card(dy, w)
    if r % GROUP_ROWS or k % COLS or n % K_STEP:
        raise ValueError(f"the kernel takes R % {GROUP_ROWS}, K % {COLS}, N % {K_STEP} == 0; got {r}, {k}, {n}")
    out = torch.empty((r, k), dtype=dy.dtype, device=dy.device)
    return _launch(dy, w, out, offsets, MODE_ROWS_W, r, k, n, e)


def grouped_mm_dw(dy: torch.Tensor, x: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(E, N, K) f32: ``dy[rows of e]^T @ x[rows of e]`` for each expert e;
    dy (R, N), x (R, K). CPU tensors take the plain version; CUDA tensors
    the kernel (bf16, R a multiple of ``GROUP_ROWS``, N and K of
    ``COLS``)."""
    r, n = dy.shape
    r2, k = x.shape
    experts = offsets.shape[0] - 1
    if r2 != r or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy ({tuple(dy.shape)}) and x ({tuple(x.shape)}) must share rows, dtype and device")
    _check_offsets(offsets, experts, x.device)
    if x.device.type == "cpu":
        return grouped_mm_dw_reference(dy, x, offsets)
    if r % GROUP_ROWS or n % COLS or k % COLS:
        raise ValueError(f"the kernel takes R % {GROUP_ROWS}, N and K % {COLS} == 0; got {r}, {n}, {k}")
    _check_card(dy, x)
    out = torch.empty((experts, n, k), dtype=torch.float32, device=x.device)
    return _launch(dy, x, out, offsets, MODE_DW, r, n, k, experts)


class _GroupedLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, offsets):
        wc = w.to(x.dtype)
        ctx.save_for_backward(x, wc, offsets)
        ctx.w_dtype = w.dtype
        return grouped_mm(x, wc, offsets)

    @staticmethod
    def backward(ctx, dy):
        x, wc, offsets = ctx.saved_tensors
        dy = dy.contiguous()
        return grouped_mm_w(dy, wc, offsets), grouped_mm_dw(dy, x, offsets).to(ctx.w_dtype), None


def grouped_linear(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(R, N) = ``x[r] @ w[e(r)]^T`` with the f32 weights ``w`` (E, N, K)
    cast to x's dtype (the cast kept for the backward's input gradient);
    differentiable in x and w."""
    return _GroupedLinear.apply(x, w, offsets)
