"""Fused softmax-CE statistics (forward) and backward over a catalog table.

Counterparts of two Pallas kernels of
``bert4clickpath_tpu/ops/pallas/fused_ce.py``:

* :func:`ce_stats` — ``_fwd_kernel``: per row of x, the max ``m`` and the
  sum-exp ``l`` of ``x . table^T (+ bias)`` with table rows outside
  ``[row_offset, row_offset + num_valid)`` blinded to -1e30, so that
  ``logz = m + log(l)``;
* :func:`ce_backward` — ``_bwd_fused_kernel``: with
  ``A = dnll * (softmax - onehot(label))`` recomputed once, ``dx = A . W``
  in x's dtype, ``dW = A^T . x`` summed in f32 and ``db = sum_rows A`` in
  f32.

Both compute in x's dtype as the JAX kernels do (``w.astype(x.dtype)``, and
A rounded to it before the products): f32 FMA for f32 x, exact bf16
products with f32 sums for bf16 x. The CUDA kernels are
``bert4clickpath_torch/csrc/fused_ce.cu``; :func:`ce_stats_reference` and
:func:`ce_backward_reference` are their plain PyTorch versions (dense
(N, V) f32 logits). CPU tensors take the plain versions, CUDA tensors
launch the kernels.

``labels_model`` is the row id of each label in the table (-1 for a padded
row, whose one-hot never fires): ``ops/fused_ce.py`` builds it.
"""

from __future__ import annotations

from typing import Optional

import torch

from bert4clickpath_torch.ops.kernels import _build

NEG_BIG = -1e30
TILE = 64  # csrc/fused_ce.cu kTile: rows of x and of the table per tile
TILES_PER_SPLIT = 32  # forward: vocab tiles one block walks (2,048 rows)
MAX_D = 256  # the backward holds a (64, D) dW tile in registers
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


def ce_backward_reference(
    x: torch.Tensor, table: torch.Tensor, bias: Optional[torch.Tensor],
    labels_model: torch.Tensor, logz: torch.Tensor, dnll: torch.Tensor,
    row_offset: int, num_valid: int,
) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of the backward kernel: (dx in x's dtype, dW f32,
    db f32 or None)."""
    s = _scores(x, table, bias, row_offset, num_valid)
    p = torch.exp(s - logz[:, None])  # blinded rows: exactly 0
    rows = torch.arange(table.shape[0], device=x.device)
    onehot = (rows[None, :] == labels_model.long()[:, None]).float()
    a = dnll[:, None] * (p - onehot)
    ab = a.to(x.dtype).float()
    dx = (ab @ table.to(x.dtype).float()).to(x.dtype)
    dw = ab.T @ x.float()
    db = a.sum(dim=0) if bias is not None else None
    return dx, dw, db


def _check(x, table, bias):
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
    if x.device.type == "cuda" and d > MAX_D:
        raise ValueError(
            f"D={d}: the CE kernels hold a (64, D) tile per thread block and "
            f"take D <= {MAX_D}"
        )


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
    _check(x, table, bias)
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


def ce_backward(
    x: torch.Tensor,  # (N, D) f32 or bf16
    table: torch.Tensor,  # (V, D) f32
    bias: Optional[torch.Tensor],  # (V,) f32
    labels_model: torch.Tensor,  # (N,) int32 table row of each label, -1 = pad
    logz: torch.Tensor,  # (N,) f32
    dnll: torch.Tensor,  # (N,) f32
    row_offset: int,
    num_valid: int,
) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(dx in x's dtype, dW (V, D) f32, db (V,) f32 or None)."""
    _check(x, table, bias)
    n = x.shape[0]
    for name, t in (("labels_model", labels_model), ("logz", logz), ("dnll", dnll)):
        if tuple(t.shape) != (n,) or t.device != x.device:
            raise ValueError(f"{name} must be ({n},) on {x.device}, got {tuple(t.shape)} on {t.device}")
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
