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
A rounded to it before the products): for f32 x every product (the
forward's scores, the merged kernel, the dx and dW passes) on the tensor
cores with each f32 operand as two tf32 terms, hi + lo, in three products
with f32 sums (``kDxNumerics`` in ``csrc/fused_ce_mma.cuh``: measured
against a dense f64 oracle beside f32 FMA, one TF32 product and three bf16
ones, PERF.md "the dx numerics decision"; within the f32 tolerances of the
plain version); for bf16 x exact bf16 products with f32 sums. dx sums in
f32 over the whole vocabulary and rounds to x's dtype once; the JAX dx
kernel rounds its bf16 output once per vocab tile, so bf16 dx agrees with it
to a few bf16 ulps (f32 is unaffected). The CUDA kernels are
``bert4clickpath_torch/csrc/fused_ce.cu`` (the forward and the merged
backward, on Hopper's TMA loads and ``wgmma`` products through
``hopper.cuh``: the merged backward walks the live rows packed into
scratch on the device, and adds dx across its units with TMA reduce-adds),
``fused_ce_two_pass.cu`` and ``fused_ce_mma.cuh`` (the two-pass kernels,
on ``mma.sync``); the
``*_reference`` functions are their plain PyTorch versions (dense (N, V)
f32 logits). CPU tensors take the plain versions, CUDA tensors launch the
kernels.

Which backward runs is a function of the shape alone, like
``ops.kernels.attention.attention_family``: the merged kernel keeps its
table rows' dW in registers (f32 x: 64 rows a unit at D <= 128, 32 up to
256; bf16 x: 64), so it takes D <= ``MAX_D`` (256); wider rows
take the two-pass pair, whose blocks own 384 output columns at a time and
stream the other operand through shared memory. No kernel refuses a row
width: where a backward block's own operand (x's rows, or the table's) does
not fit its shared memory whole, the kernels stream it in chunks too, a
route each C entry takes by D alone; the forward loads x's chunk beside the
table's at every D (one route), after padding D to a multiple of 16 bytes
where it is not one (:func:`_tma_operands`). No flag or environment
variable changes a route, and a launch that fails raises.

Where the streamed routes fall off: above D = 384 the dx pass streams x's
chunks and the dW pass its table rows (f32 x), and at D = 1,024 (no main
path) they take 54.4 / 56.2 ms against their plain versions' 14.0 / 14.8
(N = 2,560, V = 55,296, f32, NVIDIA H100 80GB HBM3 at 700 W; PERF.md). The
route past that cliff is the forward's TMA + ``wgmma`` mainloop (ROADMAP.md,
Queue 2).

``labels_model`` is the row id of each label in the table (-1 for a padded
row, whose one-hot never fires): ``ops/fused_ce.py`` builds it. Row ids are
``int`` (a table of up to 2^31 rows); every product of a row by D in the
four CE entries widens to 64 bits first, so a table of more than 2^31
elements is addressed right (held at V = 9,000,000, D = 256 by
``chip_smoke.py``'s large-catalog phase).

``row_start`` (every entry; default 0) is the global row id of
``table[0]``, as the JAX kernels' ``row_start`` operand: a table that is
one row shard of a larger one (the vocab-sharded tier,
``parallel/spmd.py``) passes ``shard * V_local``. The window and
``labels_model`` are in global rows, and table row r is global row
``row_start + r``. The arithmetic shift, not the kernels, carries it: the
C entries hand the kernels the window in local rows (``row_offset -
row_start``, on the host), and the backward wrappers shift the labels
(``labels_model - row_start``, one elementwise op, skipped at row_start
0). So the kernels are the ones from before the argument existed, with
their bits and times at row_start 0, and a shard's call is the call
shifted by its row_start (both held on the card: PERF.md). A row whose
label lies on another shard matches no local row, keeps its nonzero dnll
and still adds its softmax share to this shard's dx, dW and db (the
merged kernel's row list keys on dnll).
"""

from __future__ import annotations

from typing import Optional

import torch

from bert4clickpath_torch.ops.kernels import _build

NEG_BIG = -1e30
TILE = 64  # csrc/fused_ce_mma.cuh kTile: rows of x and of the table per backward tile
# the forward's tiles (csrc/fused_ce.cu kCeFwdRows, kCeFwdVocab): 128 rows of
# x a block (two wgmma warpgroups of 64), 128 table rows a vocab tile
FWD_ROWS = 128
FWD_VOCAB = 128
# forward schedule: units of (row tile, vocab split), the vocabulary split
# until row tiles x splits reaches FWD_TARGET_UNITS units, each split
# walking at least FWD_MIN_TILES vocab tiles; one persistent block an SM
# walks every gridDim-th unit (row tiles fastest), so the card idles at
# most one unit a block at the end, and a split's (m, l) partial costs the
# combine 8 bytes a row. Timed at N=2,560, V=55,296 and at N=160, V=20,480
# on an H100 by chip_smoke.py's sweeps of both (PERF.md)
FWD_TARGET_UNITS = 16896
FWD_MIN_TILES = 1
MAX_D = 256  # the merged backward holds its table rows' dW in registers
TWO_PASS_OUT_COLS = 384  # kOutCols: output columns one two-pass block owns
# dx grid: one block is resident per SM (its shared memory), so the grid runs
# in waves of 132 and the last, partly empty wave costs less the shorter a
# block's vocab walk is. Timed at N=2,560, V=55,296, D=384 on an H100 (700 W)
# by chip_smoke.py's DX_TARGETS sweep (PERF.md)
DX_TARGET_BLOCKS = 1056
_X_DTYPES = (torch.float32, torch.bfloat16)


def _rows(table, row_start):
    """The global row id of each of the table's rows."""
    return row_start + torch.arange(table.shape[0], device=table.device)


def _scores(x, table, bias, row_offset, num_valid, row_start=0):
    """(N, V) f32 logits in x's dtype (f32 accumulation), the bias added
    before the blinding of rows outside the window (in global rows)."""
    s = x.float() @ table.to(x.dtype).float().T
    if bias is not None:
        s = s + bias.float()
    rows = _rows(table, row_start)
    inside = (rows >= row_offset) & (rows < row_offset + num_valid)
    return torch.where(inside, s, torch.full_like(s, NEG_BIG))


def ce_stats_reference(
    x: torch.Tensor, table: torch.Tensor, bias: Optional[torch.Tensor],
    row_offset: int, num_valid: int, row_start: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (m, l), each (N,) f32."""
    s = _scores(x, table, bias, row_offset, num_valid, row_start)
    m = s.max(dim=1).values
    return m, torch.exp(s - m[:, None]).sum(dim=1)


def _adjoint(x, table, bias, labels_model, logz, dnll, row_offset, num_valid, row_start=0):
    """A = dnll * (softmax - onehot(label)), (N, V) f32, unrounded; labels
    are global rows, so a label on another shard adds no one-hot here."""
    s = _scores(x, table, bias, row_offset, num_valid, row_start)
    p = torch.exp(s - logz[:, None])  # blinded rows: exactly 0
    rows = _rows(table, row_start)
    onehot = (rows[None, :] == labels_model.long()[:, None]).float()
    return dnll[:, None] * (p - onehot)


def ce_backward_dx_reference(
    x: torch.Tensor, table: torch.Tensor, bias: Optional[torch.Tensor],
    labels_model: torch.Tensor, logz: torch.Tensor, dnll: torch.Tensor,
    row_offset: int, num_valid: int, row_start: int = 0,
) -> torch.Tensor:
    """Plain version of the dx kernel: dx (N, D) in x's dtype."""
    a = _adjoint(x, table, bias, labels_model, logz, dnll, row_offset, num_valid, row_start)
    return (a.to(x.dtype).float() @ table.to(x.dtype).float()).to(x.dtype)


def ce_backward_dw_reference(
    x: torch.Tensor, table: torch.Tensor, bias: Optional[torch.Tensor],
    labels_model: torch.Tensor, logz: torch.Tensor, dnll: torch.Tensor,
    row_offset: int, num_valid: int, row_start: int = 0,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of the dW kernel: (dW (V, D) f32, db (V,) f32 or None)."""
    a = _adjoint(x, table, bias, labels_model, logz, dnll, row_offset, num_valid, row_start)
    dw = a.to(x.dtype).float().T @ x.float()
    return dw, (a.sum(dim=0) if bias is not None else None)


def ce_backward_reference(
    x: torch.Tensor, table: torch.Tensor, bias: Optional[torch.Tensor],
    labels_model: torch.Tensor, logz: torch.Tensor, dnll: torch.Tensor,
    row_offset: int, num_valid: int, row_start: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of the merged backward kernel: (dx in x's dtype, dW f32,
    db f32 or None), from one A."""
    a = _adjoint(x, table, bias, labels_model, logz, dnll, row_offset, num_valid, row_start)
    ab = a.to(x.dtype).float()
    dx = (ab @ table.to(x.dtype).float()).to(x.dtype)
    dw = ab.T @ x.float()
    db = a.sum(dim=0) if bias is not None else None
    return dx, dw, db


def _check(x, table, bias, max_d: Optional[int] = None):
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
    if x.device.type == "cuda" and max_d is not None and d > max_d:
        raise ValueError(f"D={d}: the merged CE backward holds its dW rows in registers and takes D <= {max_d}")


def _check_rows(x, labels_model, logz, dnll):
    n = x.shape[0]
    for name, t in (("labels_model", labels_model), ("logz", logz), ("dnll", dnll)):
        if tuple(t.shape) != (n,) or t.device != x.device:
            raise ValueError(f"{name} must be ({n},) on {x.device}, got {tuple(t.shape)} on {t.device}")


def _local_labels(labels_model: torch.Tensor, row_start: int) -> torch.Tensor:
    """The kernels' int32 labels, in the table's local rows."""
    lab = labels_model if row_start == 0 else labels_model - row_start
    return lab.to(torch.int32).contiguous()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _vocab_splits(base: int, v: int, target: int, min_tiles: int = 1, tile: int = TILE) -> tuple[int, int]:
    """(splits, vocab tiles per split): the vocabulary, in tiles of ``tile``
    rows, split until ``base`` blocks x splits reaches ``target``, with at
    least ``min_tiles`` tiles a split, then evened out; every vocab tile in
    exactly one split."""
    n_vtiles = max(1, -(-v // tile))
    splits = min(n_vtiles, max(1, -(-target // base)))
    per_split = max(min_tiles, -(-n_vtiles // splits))
    return -(-n_vtiles // per_split), per_split


def ce_splits(n: int, v: int) -> tuple[int, int]:
    """(splits, vocab tiles per split) of the forward's units: ``FWD_ROWS``-row
    tiles of x x vocab splits of ``FWD_VOCAB``-row tiles, aimed at
    ``FWD_TARGET_UNITS`` units, a split at least ``FWD_MIN_TILES`` tiles."""
    return _vocab_splits(max(1, -(-n // FWD_ROWS)), v, FWD_TARGET_UNITS, FWD_MIN_TILES, FWD_VOCAB)


def _tma_operands(x: torch.Tensor, table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x and the table as the forward's TMA loads take them: 16-byte
    aligned, rows a multiple of 16 bytes. Other widths are padded with zero
    columns (which add nothing to the products) through a copy of both; a
    misaligned view is copied."""
    d = x.shape[1]
    unit = 16 // x.element_size()  # 4 f32 or 8 bf16 columns; the f32 table needs 4
    width = max(unit, -(-d // unit) * unit)
    if width != d:
        pad = (0, width - d)
        return torch.nn.functional.pad(x, pad), torch.nn.functional.pad(table, pad)
    if x.data_ptr() % 16:
        x = x.clone()
    if table.data_ptr() % 16:
        table = table.clone()
    return x, table


def ce_stats(
    x: torch.Tensor,  # (N, D) f32 or bf16
    table: torch.Tensor,  # (V, D) f32
    bias: Optional[torch.Tensor],  # (V,) f32
    row_offset: int,
    num_valid: int,
    row_start: int = 0,  # global row id of table[0] (a shard's first row)
) -> tuple[torch.Tensor, torch.Tensor]:
    """(m, l), each (N,) f32: logz = m + log(l)."""
    _check(x, table, bias)
    if x.device.type == "cpu":
        return ce_stats_reference(x, table, bias, row_offset, num_valid, row_start)
    n = x.shape[0]
    v = table.shape[0]
    x, table = _tma_operands(x.contiguous(), table.contiguous())
    d = x.shape[1]
    bias = None if bias is None else bias.contiguous()
    splits, per_split = ce_splits(n, v)
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
            row_start, splits, per_split, x.device.index, stream,
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
    row_start: int = 0,  # global row id of table[0]
) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(dx in x's dtype, dW (V, D) f32, db (V,) f32 or None) from the
    single-recompute kernel. On the card it walks only the rows whose dnll
    is nonzero (the others add nothing, and their dx rows are 0): they are
    listed and packed into scratch on the device (no host read of their
    count), and a width off 16 bytes is padded
    (:func:`_tma_operands`) for the tensor maps. dW and db are summed in a
    fixed order (two runs give the same bits); dx sums across vocab tiles
    with f32 atomic adds (TMA reduce-adds into the packed scratch,
    scattered back after), so it repeats to rounding, not bit for bit: two
    runs within 1e-5 of the largest |dx| of each other (kept on purpose: a
    fixed order would cost at least as much, for bits no tolerance
    needs)."""
    _check(x, table, bias, MAX_D)
    _check_rows(x, labels_model, logz, dnll)
    if x.device.type == "cpu":
        return ce_backward_reference(
            x, table, bias, labels_model, logz, dnll, row_offset, num_valid, row_start
        )
    n, d = x.shape
    v = table.shape[0]
    # the live rows are packed for the tensor maps, which need 16-byte rows
    x, table = _tma_operands(x.contiguous(), table.contiguous())
    width = x.shape[1]
    bias = None if bias is None else bias.contiguous()
    lab = _local_labels(labels_model, row_start)
    logz = logz.float().contiguous()
    dnll = dnll.float().contiguous()
    # the rows the kernel walks (count, rows, each row's place among them)
    # and the packed rows: x, dx (width f32 each) and (logz, dnll, label) a row
    live = torch.empty(2 * n + 1, dtype=torch.int32, device=x.device)
    rows = max(n, 1)
    work = torch.empty(rows * (2 * width + 4), dtype=torch.float32, device=x.device)
    dx32 = torch.empty((n, width), dtype=torch.float32, device=x.device)
    dw = torch.empty((v, width), dtype=torch.float32, device=x.device)
    db = None if bias is None else torch.empty(v, dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.b4cp_ce_bwd(
            x.data_ptr(), table.data_ptr(), _ptr(bias), lab.data_ptr(),
            logz.data_ptr(), dnll.data_ptr(), live.data_ptr(), work.data_ptr(), dx32.data_ptr(),
            dw.data_ptr(), _ptr(db), int(x.dtype == torch.bfloat16), n, v, width,
            row_offset, num_valid, row_start, x.device.index, stream,
        )
    _build.check(code, "fused CE backward")
    _build.count("ce_bwd")
    if width != d:
        dx32, dw = dx32[:, :d].contiguous(), dw[:, :d].contiguous()
    return dx32.to(x.dtype), dw, db


def ce_dx_splits(n: int, v: int, d: int) -> tuple[int, int]:
    """(splits, vocab tiles per split) of the dx grid: row tiles x D splits
    x vocab splits aimed at ``DX_TARGET_BLOCKS``."""
    return _vocab_splits(max(1, -(-n // TILE)) * max(1, -(-d // TWO_PASS_OUT_COLS)), v, DX_TARGET_BLOCKS)


def ce_backward_dx(
    x: torch.Tensor,  # (N, D) f32 or bf16
    table: torch.Tensor,  # (V, D) f32
    bias: Optional[torch.Tensor],  # (V,) f32
    labels_model: torch.Tensor,  # (N,) int32 table row of each label, -1 = pad
    logz: torch.Tensor,  # (N,) f32
    dnll: torch.Tensor,  # (N,) f32
    row_offset: int,
    num_valid: int,
    row_start: int = 0,  # global row id of table[0]
) -> torch.Tensor:
    """dx (N, D) in x's dtype: the first pass of the two-pass backward.
    Summed in a fixed order (no atomics): the same bits every run."""
    _check(x, table, bias)
    _check_rows(x, labels_model, logz, dnll)
    if x.device.type == "cpu":
        return ce_backward_dx_reference(
            x, table, bias, labels_model, logz, dnll, row_offset, num_valid, row_start
        )
    n, d = x.shape
    v = table.shape[0]
    x, table = x.contiguous(), table.contiguous()
    bias = None if bias is None else bias.contiguous()
    lab = _local_labels(labels_model, row_start)
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
            row_start, splits, per_split, x.device.index, stream,
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
    row_start: int = 0,  # global row id of table[0]
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dW (V, D) f32, db (V,) f32 or None): the second pass of the
    two-pass backward."""
    _check(x, table, bias)
    _check_rows(x, labels_model, logz, dnll)
    if x.device.type == "cpu":
        return ce_backward_dw_reference(
            x, table, bias, labels_model, logz, dnll, row_offset, num_valid, row_start
        )
    n, d = x.shape
    v = table.shape[0]
    x, table = x.contiguous(), table.contiguous()
    bias = None if bias is None else bias.contiguous()
    lab = _local_labels(labels_model, row_start)
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
            row_start, x.device.index, stream,
        )
    _build.check(code, "fused CE backward, dW pass")
    _build.count("ce_bwd_dw")
    return dw, db


def ce_backward_two_pass(
    x, table, bias, labels_model, logz, dnll, row_offset: int, num_valid: int,
    row_start: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(dx, dW, db) from the dx pass and the dW pass (two recomputes of the
    scores): the counterpart of the JAX package's ``_bwd``."""
    args = (x, table, bias, labels_model, logz, dnll, row_offset, num_valid, row_start)
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
    row_start: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(dx in x's dtype, dW (V, D) f32, db (V,) f32 or None) by the route of
    :func:`ce_backward_route`, on either device."""
    route = ce_backward_merged if ce_backward_route(x.shape[-1]) == "merged" else ce_backward_two_pass
    return route(x, table, bias, labels_model, logz, dnll, row_offset, num_valid, row_start)
