"""Fused softmax-CE statistics (forward) and backward over a catalog table.

Counterparts of the Pallas kernels of
``bert4clickpath_tpu/ops/pallas/fused_ce.py``:

* :func:`ce_stats` — ``_fwd_kernel``: per row of x, the max ``m`` and the
  sum-exp ``l`` of ``x . table^T (+ bias)`` with table rows outside
  ``[row_offset, row_offset + num_valid)`` blinded to -1e30, so that
  ``logz = m + log(l)``;
* :func:`ce_backward_merged` — ``_bwd_fused_kernel``: with
  ``A = dnll * (softmax - onehot(label))`` recomputed once, ``dx = A . W``
  in x's dtype, ``dW = A^T . x`` summed in f32 and ``db = sum_rows A`` in
  f32;
* :func:`ce_backward_dx` and :func:`ce_backward_dw` — ``_bwd_dx_kernel``
  and ``_bwd_dw_kernel``: the same three results from two kernels that each
  recompute A; :func:`ce_backward_two_pass` is the pair, the counterpart of
  ``_bwd``;
* :func:`ce_backward` — ``_bwd_auto``: the merged kernel or the pair, by
  :func:`ce_backward_route`.

All compute in x's dtype as the JAX kernels do (``w.astype(x.dtype)``, and
A rounded to it before the products): f32 FMA for f32 x, exact bf16
products with f32 sums for bf16 x. dx sums in f32 over the whole
vocabulary and rounds to x's dtype once; the JAX dx kernel rounds its bf16
output once per vocab tile, so bf16 dx agrees with it to a few bf16 ulps
(f32 is unaffected). The CUDA kernels are
``bert4clickpath_torch/csrc/fused_ce.cu`` and ``fused_ce_two_pass.cu``;
the ``*_reference`` functions are their plain PyTorch versions (dense
(N, V) f32 logits). CPU tensors take the plain versions, CUDA tensors
launch the kernels.

Which backward runs is a function of the shape alone, like
``ops.kernels.attention.attention_family``: the merged kernel keeps a
(64, D) dW tile in registers, so it takes D <= ``MAX_D`` (256); wider rows
take the two-pass pair, whose blocks own 384 output columns at a time and
stream the other operand through shared memory (D <= ``MAX_D_TWO_PASS``,
713, the one whole 64-row tile that must fit a block's shared memory). The
forward keeps two whole 64-row tiles in shared memory: D <=
``MAX_D_FWD`` (453). No flag or environment variable changes the route, and
a launch that fails raises.

``labels_model`` is the row id of each label in the table (-1 for a padded
row, whose one-hot never fires): ``ops/fused_ce.py`` builds it.
"""

from __future__ import annotations

from typing import Optional

import torch

from bert4clickpath_torch.ops.kernels import _build

NEG_BIG = -1e30
TILE = 64  # csrc/fused_ce_tiles.cuh kTile: rows of x and of the table per tile
TILES_PER_SPLIT = 32  # forward: vocab tiles one block walks (2,048 rows)
SMEM_FLOATS = 232448 // 4  # the most shared memory one block can have (227 KB)
MAX_D = 256  # the merged backward holds a (64, D) dW tile in registers
MAX_D_FWD = SMEM_FLOATS // (2 * TILE) - 1  # two (64, D + 1) tiles: 453
# csrc/fused_ce_two_pass.cu: one (64, D + 1) tile, a (64, 129) chunk buffer
# and the (64, 65) A tile: 713
MAX_D_TWO_PASS = (SMEM_FLOATS - TILE * 129 - TILE * 65) // TILE - 1
TWO_PASS_OUT_COLS = 384  # kOutCols: output columns one two-pass block owns
# dx grid: one block is resident per SM (its shared memory), so the grid runs
# in waves of 132 and the last, partly empty wave costs less the shorter a
# block's vocab walk is. Timed at N=2,560, V=55,296, D=384 on an H100 (700 W):
# 132 / 264 / 528 / 1,056 blocks aimed at take 21.9 / 18.2 / 15.5 / 14.6 ms
DX_TARGET_BLOCKS = 1056
_X_DTYPES = (torch.float32, torch.bfloat16)


def _scores(x, table, bias, row_offset, num_valid):
    """(N, V) f32 logits in x's dtype (f32 accumulation), the bias added
    before the blinding of rows outside the window."""
    s = x.float() @ table.to(x.dtype).float().T
    if bias is not None:
        s = s + bias.float()
    rows = torch.arange(table.shape[0], device=x.device)
    inside = (rows >= row_offset) & (rows < row_offset + num_valid)
    return torch.where(inside, s, torch.full_like(s, NEG_BIG))


def ce_stats_reference(
    x: torch.Tensor, table: torch.Tensor, bias: Optional[torch.Tensor],
    row_offset: int, num_valid: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (m, l), each (N,) f32."""
    s = _scores(x, table, bias, row_offset, num_valid)
    m = s.max(dim=1).values
    return m, torch.exp(s - m[:, None]).sum(dim=1)


def _adjoint(x, table, bias, labels_model, logz, dnll, row_offset, num_valid):
    """A = dnll * (softmax - onehot(label)), (N, V) f32, unrounded."""
    s = _scores(x, table, bias, row_offset, num_valid)
    p = torch.exp(s - logz[:, None])  # blinded rows: exactly 0
    rows = torch.arange(table.shape[0], device=x.device)
    onehot = (rows[None, :] == labels_model.long()[:, None]).float()
    return dnll[:, None] * (p - onehot)


def ce_backward_dx_reference(
    x: torch.Tensor, table: torch.Tensor, bias: Optional[torch.Tensor],
    labels_model: torch.Tensor, logz: torch.Tensor, dnll: torch.Tensor,
    row_offset: int, num_valid: int,
) -> torch.Tensor:
    """Plain version of the dx kernel: dx (N, D) in x's dtype."""
    a = _adjoint(x, table, bias, labels_model, logz, dnll, row_offset, num_valid)
    return (a.to(x.dtype).float() @ table.to(x.dtype).float()).to(x.dtype)


def ce_backward_dw_reference(
    x: torch.Tensor, table: torch.Tensor, bias: Optional[torch.Tensor],
    labels_model: torch.Tensor, logz: torch.Tensor, dnll: torch.Tensor,
    row_offset: int, num_valid: int,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of the dW kernel: (dW (V, D) f32, db (V,) f32 or None)."""
    a = _adjoint(x, table, bias, labels_model, logz, dnll, row_offset, num_valid)
    dw = a.to(x.dtype).float().T @ x.float()
    return dw, (a.sum(dim=0) if bias is not None else None)


def ce_backward_reference(
    x: torch.Tensor, table: torch.Tensor, bias: Optional[torch.Tensor],
    labels_model: torch.Tensor, logz: torch.Tensor, dnll: torch.Tensor,
    row_offset: int, num_valid: int,
) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of the merged backward kernel: (dx in x's dtype, dW f32,
    db f32 or None), from one A."""
    a = _adjoint(x, table, bias, labels_model, logz, dnll, row_offset, num_valid)
    ab = a.to(x.dtype).float()
    dx = (ab @ table.to(x.dtype).float()).to(x.dtype)
    dw = ab.T @ x.float()
    db = a.sum(dim=0) if bias is not None else None
    return dx, dw, db


def _check(x, table, bias, what: str, max_d: int):
    if x.dim() != 2 or table.dim() != 2 or x.shape[1] != table.shape[1]:
        raise ValueError(f"x (N, D) and table (V, D) needed, got {tuple(x.shape)} {tuple(table.shape)}")
    if x.dtype not in _X_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if table.dtype != torch.float32:
        raise ValueError(f"table must be float32, got {table.dtype}")
    if bias is not None and (bias.dtype != torch.float32 or tuple(bias.shape) != (table.shape[0],)):
        raise ValueError(f"bias must be ({table.shape[0]},) float32, got {tuple(bias.shape)} {bias.dtype}")
    devices = {x.device, table.device} | ({bias.device} if bias is not None else set())
    if len(devices) != 1:
        raise ValueError("x, table and bias must be on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    d = x.shape[1]
    if x.device.type == "cuda" and d > max_d:
        raise ValueError(f"D={d}: {what} takes D <= {max_d}")


def _check_rows(x, labels_model, logz, dnll):
    n = x.shape[0]
    for name, t in (("labels_model", labels_model), ("logz", logz), ("dnll", dnll)):
        if tuple(t.shape) != (n,) or t.device != x.device:
            raise ValueError(f"{name} must be ({n},) on {x.device}, got {tuple(t.shape)} on {t.device}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def ce_splits(v: int) -> int:
    """Vocab splits of the forward grid: blocks of 32 vocab tiles."""
    n_vtiles = -(-v // TILE)
    return max(1, -(-n_vtiles // TILES_PER_SPLIT))


def ce_stats(
    x: torch.Tensor,  # (N, D) f32 or bf16
    table: torch.Tensor,  # (V, D) f32
    bias: Optional[torch.Tensor],  # (V,) f32
    row_offset: int,
    num_valid: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(m, l), each (N,) f32: logz = m + log(l)."""
    _check(x, table, bias, "the CE forward holds two (64, D) tiles in one block's shared memory and",
           MAX_D_FWD)
    if x.device.type == "cpu":
        return ce_stats_reference(x, table, bias, row_offset, num_valid)
    n, d = x.shape
    v = table.shape[0]
    x, table = x.contiguous(), table.contiguous()
    bias = None if bias is None else bias.contiguous()
    splits = ce_splits(v)
    part = torch.empty((2, splits, n), dtype=torch.float32, device=x.device)
    m = torch.empty(n, dtype=torch.float32, device=x.device)
    l = torch.empty(n, dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.b4cp_ce_fwd(
            x.data_ptr(), table.data_ptr(), _ptr(bias), part[0].data_ptr(),
            part[1].data_ptr(), m.data_ptr(), l.data_ptr(),
            int(x.dtype == torch.bfloat16), n, v, d, row_offset, num_valid,
            splits, TILES_PER_SPLIT, x.device.index, stream,
        )
    _build.check(code, "fused CE forward")
    _build.count("ce_fwd")
    return m, l


def ce_backward_merged(
    x: torch.Tensor,  # (N, D) f32 or bf16
    table: torch.Tensor,  # (V, D) f32
    bias: Optional[torch.Tensor],  # (V,) f32
    labels_model: torch.Tensor,  # (N,) int32 table row of each label, -1 = pad
    logz: torch.Tensor,  # (N,) f32
    dnll: torch.Tensor,  # (N,) f32
    row_offset: int,
    num_valid: int,
) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(dx in x's dtype, dW (V, D) f32, db (V,) f32 or None) from the
    single-recompute kernel; on the card dx sums with atomics, so it
    repeats to rounding, not bit for bit."""
    _check(x, table, bias, "the merged CE backward holds a (64, D) tile in registers and", MAX_D)
    _check_rows(x, labels_model, logz, dnll)
    if x.device.type == "cpu":
        return ce_backward_reference(x, table, bias, labels_model, logz, dnll, row_offset, num_valid)
    n, d = x.shape
    v = table.shape[0]
    x, table = x.contiguous(), table.contiguous()
    bias = None if bias is None else bias.contiguous()
    lab = labels_model.to(torch.int32).contiguous()
    logz = logz.float().contiguous()
    dnll = dnll.float().contiguous()
    dx32 = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    dw = torch.empty((v, d), dtype=torch.float32, device=x.device)
    db = None if bias is None else torch.empty(v, dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.b4cp_ce_bwd(
            x.data_ptr(), table.data_ptr(), _ptr(bias), lab.data_ptr(),
            logz.data_ptr(), dnll.data_ptr(), dx32.data_ptr(), dw.data_ptr(),
            _ptr(db), int(x.dtype == torch.bfloat16), n, v, d, row_offset,
            num_valid, x.device.index, stream,
        )
    _build.check(code, "fused CE backward")
    _build.count("ce_bwd")
    return dx32.to(x.dtype), dw, db


_TWO_PASS_WHAT = "the two-pass CE backward holds one (64, D) tile in one block's shared memory and"


def ce_dx_splits(n: int, v: int, d: int) -> tuple[int, int]:
    """(splits, vocab tiles per split) of the dx grid: the vocabulary is
    split until row tiles x D splits x vocab splits reaches
    ``DX_TARGET_BLOCKS``, then evened out."""
    n_vtiles = max(1, -(-v // TILE))
    base = max(1, -(-n // TILE)) * max(1, -(-d // TWO_PASS_OUT_COLS))
    splits = min(n_vtiles, max(1, -(-DX_TARGET_BLOCKS // base)))
    per_split = -(-n_vtiles // splits)
    return -(-n_vtiles // per_split), per_split


def ce_backward_dx(
    x: torch.Tensor,  # (N, D) f32 or bf16
    table: torch.Tensor,  # (V, D) f32
    bias: Optional[torch.Tensor],  # (V,) f32
    labels_model: torch.Tensor,  # (N,) int32 table row of each label, -1 = pad
    logz: torch.Tensor,  # (N,) f32
    dnll: torch.Tensor,  # (N,) f32
    row_offset: int,
    num_valid: int,
) -> torch.Tensor:
    """dx (N, D) in x's dtype: the first pass of the two-pass backward.
    Summed in a fixed order (no atomics): the same bits every run."""
    _check(x, table, bias, _TWO_PASS_WHAT, MAX_D_TWO_PASS)
    _check_rows(x, labels_model, logz, dnll)
    if x.device.type == "cpu":
        return ce_backward_dx_reference(x, table, bias, labels_model, logz, dnll, row_offset, num_valid)
    n, d = x.shape
    v = table.shape[0]
    x, table = x.contiguous(), table.contiguous()
    bias = None if bias is None else bias.contiguous()
    lab = labels_model.to(torch.int32).contiguous()
    logz = logz.float().contiguous()
    dnll = dnll.float().contiguous()
    splits, per_split = ce_dx_splits(n, v, d)
    part = torch.empty((splits, n, d), dtype=torch.float32, device=x.device)
    dx = torch.empty((n, d), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.b4cp_ce_bwd_dx(
            x.data_ptr(), table.data_ptr(), _ptr(bias), lab.data_ptr(),
            logz.data_ptr(), dnll.data_ptr(), part.data_ptr(), dx.data_ptr(),
            int(x.dtype == torch.bfloat16), n, v, d, row_offset, num_valid,
            splits, per_split, x.device.index, stream,
        )
    _build.check(code, "fused CE backward, dx pass")
    _build.count("ce_bwd_dx")
    return dx


def ce_backward_dw(
    x: torch.Tensor,  # (N, D) f32 or bf16
    table: torch.Tensor,  # (V, D) f32
    bias: Optional[torch.Tensor],  # (V,) f32
    labels_model: torch.Tensor,  # (N,) int32 table row of each label, -1 = pad
    logz: torch.Tensor,  # (N,) f32
    dnll: torch.Tensor,  # (N,) f32
    row_offset: int,
    num_valid: int,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dW (V, D) f32, db (V,) f32 or None): the second pass of the
    two-pass backward."""
    _check(x, table, bias, _TWO_PASS_WHAT, MAX_D_TWO_PASS)
    _check_rows(x, labels_model, logz, dnll)
    if x.device.type == "cpu":
        return ce_backward_dw_reference(x, table, bias, labels_model, logz, dnll, row_offset, num_valid)
    n, d = x.shape
    v = table.shape[0]
    x, table = x.contiguous(), table.contiguous()
    bias = None if bias is None else bias.contiguous()
    lab = labels_model.to(torch.int32).contiguous()
    logz = logz.float().contiguous()
    dnll = dnll.float().contiguous()
    dw = torch.empty((v, d), dtype=torch.float32, device=x.device)
    db = None if bias is None else torch.empty(v, dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.b4cp_ce_bwd_dw(
            x.data_ptr(), table.data_ptr(), _ptr(bias), lab.data_ptr(),
            logz.data_ptr(), dnll.data_ptr(), dw.data_ptr(), _ptr(db),
            int(x.dtype == torch.bfloat16), n, v, d, row_offset, num_valid,
            x.device.index, stream,
        )
    _build.check(code, "fused CE backward, dW pass")
    _build.count("ce_bwd_dw")
    return dw, db


def ce_backward_two_pass(
    x, table, bias, labels_model, logz, dnll, row_offset: int, num_valid: int,
) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(dx, dW, db) from the dx pass and the dW pass (two recomputes of the
    scores): the counterpart of the JAX package's ``_bwd``."""
    args = (x, table, bias, labels_model, logz, dnll, row_offset, num_valid)
    dx = ce_backward_dx(*args)
    dw, db = ce_backward_dw(*args)
    return dx, dw, db


def ce_backward_route(d: int) -> str:
    """Which backward a (N, D) x takes, by its shape alone: ``"merged"``
    where the merged kernel's register tile holds D (D <= ``MAX_D``),
    ``"two_pass"`` above."""
    return "merged" if d <= MAX_D else "two_pass"


def ce_backward(
    x, table, bias, labels_model, logz, dnll, row_offset: int, num_valid: int,
) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(dx in x's dtype, dW (V, D) f32, db (V,) f32 or None) by the route of
    :func:`ce_backward_route`, on either device."""
    route = ce_backward_merged if ce_backward_route(x.shape[-1]) == "merged" else ce_backward_two_pass
    return route(x, table, bias, labels_model, logz, dnll, row_offset, num_valid)
