"""The card's two-pass CE backward, its arithmetic and its schedule, emulated on the CPU.

``ce_bwd_two_pass_kernel`` (``bert4clickpath_torch/csrc/fused_ce_two_pass.cu``:
the dx pass and the dW pass) runs only on the card. What it decides is held
here instead:

* **Numerics.** A plain-PyTorch emulation of its f32 arithmetic at its own
  granularity: the live rows packed in order; every operand of every
  product read from shared memory as written beside its lo plane (the value
  as it is is the hi term, lo = v - trunc(v) beside it, each read as its top
  19 bits by the product: x and the table for the scores, the table and x
  transposed for the gradients, A written as raw f32 beside its lo term);
  the scores S = x . W^T, three products a k-step summed exactly and
  rounded once per 32-column box, the boxes joined by round-to-nearest f32
  adds; A = dnll (exp(s (+ b) - logz) - onehot) in f32. The dx pass: dx^T =
  W^T . A^T rounded once per 64-row vocab tile and joined by
  round-to-nearest adds in the tiles' order within a vocab split, the
  splits' partials added in split order and scattered back to the rows
  (rows not walked exactly 0). The dW pass: dW^T = x^T . A rounded once per
  tile of 64 packed rows and joined in the tiles' order; db the f32 sum of
  the unrounded A. It is held against the JAX two-pass backward ``_bwd``
  (its two Pallas kernels in interpret mode, as
  ``tests/test_torch_two_pass.py`` runs them) and the port's
  ``ce_backward_dx_reference`` / ``ce_backward_dw_reference``: dx, dW and
  db within 1e-4 of the largest magnitude (``CE_GRAD_REL``), at D in {264,
  384, 520, 1024}, ordinary and wide logits, with and without a bias,
  LABEL_PAD rows, a label outside the window, a window that blinds rows at
  both ends. bf16 x: W rounded to bf16, A rounded once, one exact product
  (64-column boxes); within 2e-2. One tf32 product misses 1e-4.
* **The walk.** The dx pass's units (tile of packed rows, vocab split,
  slice of D) and the dW pass's (table tile, slice) cover every live row,
  every table row and every output column once.
* **The constants fit the card.** Each instance's shared memory (the ring
  of stages, the two buffers of A planes, the db scratch, barriers and
  alignment) within 232,448 bytes; the running sums within the 168
  registers a thread of a 288-thread block gets.
* **The route.** The two-pass route goes through the new C entry alone,
  whose kernel is built on TMA and ``wgmma``; nothing of the ``mma.sync``
  pair is left.

The kernel itself is held on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert4clickpath_tpu.ops.pallas import fused_ce as jce
from bert4clickpath_torch.constants import LABEL_PAD
from bert4clickpath_torch.ops import fused_ce as tce
from bert4clickpath_torch.ops.kernels import _build
from bert4clickpath_torch.ops.kernels import fused_ce as k

torch.set_num_threads(1)

CSRC = Path(k.__file__).resolve().parents[2] / "csrc"
SOURCE = CSRC / "fused_ce_two_pass.cu"
OFF = 10  # the window's first row
MAX_SMEM = 232_448  # the most dynamic shared memory one block can have on sm_90
REGISTERS = 65_536  # an SM's register file
CE_GRAD_REL = 1e-4  # chip_smoke.py: f32 gradients, of the largest magnitude


def _constant(name: str) -> int:
    found = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert found, name
    return int(found.group(1))


ROWS = _constant("kTpRows")  # rows of a tile, in both passes


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """f32 rounded to tf32 as cvt.rna.tf32.f32 does: to nearest, ties away
    from zero, keeping 10 mantissa bits."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _trunc(a: torch.Tensor) -> torch.Tensor:
    """f32 as a tf32 product reads it: its top 19 bits."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _terms(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """An operand split in the consumers' registers: rounded to nearest."""
    hi = _tf32(a)
    return hi, _tf32(a - hi)


def _plane_terms(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """An operand read from shared memory: raw f32 as hi (truncated by the
    product), lo the exact rest (truncated by the product too)."""
    hi = _trunc(a)
    return hi, _trunc(a - hi)


def _x3(a: tuple, b: tuple) -> torch.Tensor:
    """The three tf32 products a . b (lo . hi, hi . lo, hi . hi), summed
    exactly (f64) and rounded once to f32: one group of k-steps."""
    (ah, al), (bh, bl) = (tuple(t.double() for t in a), tuple(t.double() for t in b))
    return (al @ bh + ah @ bl + ah @ bh).float()


def _emulated_pair(x, table, bias, lab, logz, dnll, row_offset, num_valid):
    """(dx, dW, db) as the card's two passes compute them for f32 x (tf32
    x3), or for bf16 x (one exact bf16 product, W and A rounded to bf16)."""
    n, d = x.shape
    v = table.shape[0]
    bf16 = x.dtype == torch.bfloat16
    box = 64 if bf16 else 32  # columns of a 128-byte box: a stage of the scores
    rows = torch.from_numpy(np.nonzero(dnll.numpy())[0])  # packed in order
    pos = np.full(n, -1, np.int64)
    pos[rows.numpy()] = np.arange(rows.shape[0])
    xp = x[rows].float()
    lz, dn, lb = logz[rows], dnll[rows], lab[rows].long()
    nl = rows.shape[0]
    zero = torch.zeros_like
    if bf16:  # exact products of the rounded operands
        w = table.to(torch.bfloat16).float()
        x_reg, w_pl, w_reg = (xp, zero(xp)), (w, zero(w)), (w, zero(w))
    else:  # A operands split in registers by rounding, the scores' B a plane beside its lo plane
        x_reg, w_pl, w_reg = _terms(xp), _plane_terms(table), _terms(table)
    s = torch.zeros((nl, v), dtype=torch.float32)
    for c0 in range(0, d, box):  # a box's fresh sums, joined to s by a round-to-nearest add
        c = slice(c0, c0 + box)
        s = s + _x3((x_reg[0][:, c], x_reg[1][:, c]), (w_pl[0][:, c].T, w_pl[1][:, c].T))
    if bias is not None:
        s = s + bias
    vrows = torch.arange(v)
    s = torch.where((vrows >= row_offset) & (vrows < row_offset + num_valid), s, torch.full_like(s, k.NEG_BIG))
    a = dn[:, None] * (torch.exp(s - lz[:, None]) - (vrows[None] == lb[:, None]).float())
    ab = a.to(torch.bfloat16).float() if bf16 else a
    a_pl = (ab, zero(ab)) if bf16 else _plane_terms(ab)
    # the dx pass: per vocab split, per 64-row vocab tile one group into
    # fresh sums joined to the split's; the partials added in split order
    splits, per = k.ce_dx_splits(n, v, d)
    dxp = torch.zeros((nl, d), dtype=torch.float32)
    for sp in range(splits):
        part = torch.zeros((nl, d), dtype=torch.float32)
        for t0 in range(sp * per * ROWS, min(v, (sp + 1) * per * ROWS), ROWS):
            t = slice(t0, t0 + ROWS)
            part = part + _x3((w_reg[0][t].T, w_reg[1][t].T), (a_pl[0][:, t].T, a_pl[1][:, t].T)).T
        dxp = dxp + part
    # the dW pass: per tile of 64 packed rows one group, joined in order
    dw = torch.zeros((v, d), dtype=torch.float32)
    for r0 in range(0, nl, ROWS):
        r = slice(r0, r0 + ROWS)
        dw = dw + _x3((x_reg[0][r].T, x_reg[1][r].T), (a_pl[0][r], a_pl[1][r])).T
    p = torch.from_numpy(pos)
    dx = torch.where((p >= 0)[:, None], dxp[p.clamp(min=0)] if nl else torch.zeros((n, d)), torch.zeros((n, d)))
    return dx.to(x.dtype), dw, (a.sum(dim=0) if bias is not None else None)


def _case(n, v, d, wide, seed, with_bias):
    """x, a table whose logits spread ~1.5 (ordinary) or ~30 (wide), a
    bias, labels (a fifth LABEL_PAD, row 1's outside the window), dnll (0
    on the LABEL_PAD rows), the window (OFF, nv): 10 rows blinded before it
    and 7 after."""
    nv = v - OFF - 7
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    table = (rng.normal(size=(v, d)) * (30.0 if wide else 1.5) / np.sqrt(d)).astype(np.float32)
    bias = rng.normal(size=(v,)).astype(np.float32) if with_bias else None
    labels = rng.integers(0, nv, size=(n,)).astype(np.int32)
    labels[::5] = LABEL_PAD
    labels[1] = nv + 3  # a row outside the window (blinded)
    dnll = ((rng.random(n) + 0.5) * (labels != LABEL_PAD) / n).astype(np.float32)
    return x, table, bias, labels, dnll, nv


def _held(got, want, rel):
    got, want = got.float().numpy().astype(np.float64), np.asarray(want, np.float64)
    top = np.abs(want).max()
    assert np.isfinite(got).all() and np.abs(got - want).max() <= rel * top, (np.abs(got - want).max(), top)


def _args(x, table, bias, labels, dnll, nv, dtype=torch.float32):
    tx, tt = torch.from_numpy(x).to(dtype), torch.from_numpy(table)
    tb = None if bias is None else torch.from_numpy(bias)
    lab = tce._labels_model(torch.from_numpy(labels), OFF)
    m, l = k.ce_stats_reference(tx, tt, tb, OFF, nv)
    return (tx, tt, tb, lab, m + torch.log(l), torch.from_numpy(dnll), OFF, nv)


def _jax_bwd(x, table, bias, labels, dnll, nv, logz, bf16=False):
    jx = jnp.asarray(x).astype(jnp.bfloat16 if bf16 else jnp.float32)
    return jce._bwd(jx, jnp.asarray(table), jce._labels_model(jnp.asarray(labels), OFF), jnp.asarray(logz.numpy()),
                    jnp.asarray(dnll), OFF, nv, bias=None if bias is None else jnp.asarray(bias).reshape(1, -1))


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("wide", [False, True], ids=["ordinary", "wide"])
@pytest.mark.parametrize("d", [264, 384, 520, 1024])
def test_emulated_f32_pair_holds_against_jax_and_plain(d, wide, with_bias):
    """The emulated tf32 x3 passes against JAX ``_bwd`` (interpret mode)
    and the plain versions: dx, dW and db within 1e-4 of the largest
    magnitude. N = 100 (80 live rows: one whole tile of packed rows and a
    ragged one), V = 300 (five vocab tiles, the last ragged, in five vocab
    splits)."""
    n, v = 100, 300
    x, table, bias, labels, dnll, nv = _case(n, v, d, wide, seed=d + 2 * wide + with_bias, with_bias=with_bias)
    args = _args(x, table, bias, labels, dnll, nv)
    got = _emulated_pair(*args)
    plain = (k.ce_backward_dx_reference(*args), *k.ce_backward_dw_reference(*args))
    want = _jax_bwd(x, table, bias, labels, dnll, nv, args[4])
    if wide:
        assert k.ce_stats_reference(*args[:3], OFF, nv)[0].abs().max() > 50  # the spread this case is for
    assert k.ce_dx_splits(n, v, d)[0] == 5  # the split order is exercised
    for i in range(3 if with_bias else 2):
        _held(got[i], plain[i].numpy(), CE_GRAD_REL)
        _held(got[i], np.asarray(want[i]).reshape(plain[i].shape), CE_GRAD_REL)
    assert got[2] is None or with_bias
    assert (got[0][labels == LABEL_PAD] == 0).all()  # rows not walked: dx exactly 0
    # blinded rows get exactly 0, but for the one row 1 is labelled with
    blinded = np.setdiff1d(np.r_[0:OFF, OFF + nv : v], [OFF + nv + 3])
    assert (got[1][OFF + nv + 3] != 0).any()
    assert (got[1][blinded] == 0).all() and (with_bias is False or (got[2][blinded] == 0).all())


@pytest.mark.parametrize("d", [264, 384])
def test_emulated_bf16_pair_holds_against_jax_and_plain(d):
    """bf16 x: W rounded to bf16, A rounded once, one exact product a
    k-step, against JAX ``_bwd`` on bf16 x and the plain versions: within
    2e-2 of the largest magnitude (an A entry may round to the other bf16
    neighbour, dx rounds once to bf16; the JAX dx kernel rounds once per
    vocab tile)."""
    n, v = 100, 300
    x, table, bias, labels, dnll, nv = _case(n, v, d, True, seed=40 + d, with_bias=True)
    args = _args(x, table, bias, labels, dnll, nv, torch.bfloat16)
    got = _emulated_pair(*args)
    plain = (k.ce_backward_dx_reference(*args), *k.ce_backward_dw_reference(*args))
    want = _jax_bwd(x, table, bias, labels, dnll, nv, args[4], bf16=True)
    for i in range(3):
        _held(got[i], plain[i].float().numpy(), 2e-2)
        _held(got[i], np.asarray(want[i].astype(jnp.float32)).reshape(plain[i].shape), 2e-2)


def test_one_tf32_product_misses_the_gradients():
    """Why each product runs three terms: with one tf32 product (hi . hi)
    in all three products the gradients miss 1e-4 of their largest
    magnitude at wide logits, where the emulation above holds them."""
    n, v, d = 100, 300, 384
    x, table, bias, labels, dnll, nv = _case(n, v, d, True, seed=5, with_bias=True)
    args = _args(x, table, bias, labels, dnll, nv)
    plain = (k.ce_backward_dx_reference(*args), k.ce_backward_dw_reference(*args)[0])
    xs, ws = _tf32(args[0]), _tf32(args[1])
    a = k._adjoint(xs, ws, args[2], args[3], args[4], args[5], OFF, nv)
    one = (_tf32(a) @ ws, _tf32(a).T @ xs)
    missed = [np.abs(g.numpy() - p.numpy()).max() / np.abs(p.numpy()).max() for g, p in zip(one, plain)]
    assert max(missed) > CE_GRAD_REL


def _slices(d: int) -> tuple[int, int]:
    """(slices, m-tiles a slice) as the C entry cuts D: the fewest slices of
    at most kTpWideTiles m-tiles of 64 columns, evenly."""
    mtiles = -(-d // 64)
    slices = -(-mtiles // _constant("kTpWideTiles"))
    return slices, -(-mtiles // slices)


def _unit(u, n_stat, splits, per, n_vtiles, n_xtiles, slice_mt, mtiles, dx):
    """tp_unit: (stationary tile, split, streamed tiles [t0, t1), first
    column, m-tiles)."""
    slices = -(-mtiles // slice_mt)
    split = 0
    if dx:  # stationary tiles fastest, then the vocab split, then the slice
        tile, rest = u % n_stat, u // n_stat
        split, slice_ = rest % splits, rest // splits
        t0, t1 = split * per, min(n_vtiles, split * per + per)
    else:  # the slices of one table tile side by side
        slice_, tile = u % slices, u // slices
        t0, t1 = 0, n_xtiles
    return tile, split, t0, t1, slice_ * slice_mt * 64, min(slice_mt, mtiles - slice_ * slice_mt)


@pytest.mark.parametrize("n,live,v,d", [(2560, 2061, 55_296, 384), (2560, 2061, 55_296, 1024), (130, 1, 700, 713),
                                         (100, 80, 300, 264), (64, 64, 64, 520), (2560, 0, 1000, 384)])
def test_units_cover_every_live_row_and_table_row_once(n, live, v, d):
    """Both passes' persistent walks on 132 blocks (block b takes units b, b +
    132, ...; the grid sized by the host from N, the dx pass's units counted
    on the device from the live rows): the dx pass covers every (tile of
    live rows, vocab tile, m-tile of output columns) once, so that each
    split's partial of every live row and column is written once; the dW
    pass covers every (table tile, m-tile) once and walks every tile of
    live rows in each unit. The blocks' unit counts differ by at most one."""
    sms = 132
    slices, slice_mt = _slices(d)
    mtiles = -(-d // 64)
    assert slices == k.two_pass_slices(d) and slice_mt <= _constant("kTpWideTiles")
    n_vtiles, n_xtiles = -(-v // ROWS), -(-live // ROWS)
    splits, per = k.ce_dx_splits(n, v, d)
    assert splits * per >= n_vtiles and (splits - 1) * per < n_vtiles
    for dx in (True, False):
        n_stat = n_xtiles if dx else n_vtiles
        units = n_stat * (splits if dx else 1) * slices
        grid = max(1, min((-(-max(n, 1) // ROWS) if dx else n_vtiles) * (splits if dx else 1) * slices, sms))
        walk = {b: list(range(b, units, grid)) for b in range(grid)}
        counts = [len(w) for w in walk.values()]
        assert sum(counts) == units and max(counts) - min(counts) <= 1
        # (stationary tile, streamed tile, m-tile), counted in tiles
        covered = np.zeros((n_stat, n_vtiles if dx else 1, mtiles), np.int32)
        for u in range(units):
            tile, split, t0, t1, d0, n_mt = _unit(u, n_stat, splits, per, n_vtiles, n_xtiles, slice_mt, mtiles, dx)
            assert 0 < n_mt <= slice_mt and d0 % 64 == 0 and split < (splits if dx else 1)
            if dx:
                covered[tile, t0:t1, d0 // 64 : d0 // 64 + n_mt] += 1
            else:
                assert (t0, t1) == (0, n_xtiles)
                covered[tile, 0, d0 // 64 : d0 // 64 + n_mt] += 1
        assert (covered == 1).all(), dx
    assert n_vtiles * ROWS >= v and n_xtiles * ROWS >= live


def _layout(bf16: bool) -> dict:
    """TpLayout: the bytes of a stage and an A plane, and of the whole
    shared memory, of the kernel's instance for f32 or bf16 x."""
    box = ROWS * 128
    score = (2 if bf16 else 3) * box  # x's box and the table's (f32 x: beside its lo plane)
    grad = (1 if bf16 else 2) * box  # an m-tile of the streamed operand: 64 columns
    slot = max(score, grad)
    stages = _constant("kTpStages")
    p_term = ROWS * ROWS * (2 if bf16 else 4)
    p_buf = (1 if bf16 else 2) * p_term
    smem = stages * slot + 2 * p_buf + 4 * ROWS * 4 + 2 * stages * 8 + 1024
    return dict(slot=slot, p_term=p_term, smem=smem)


def test_the_constants_fit_the_card():
    """Each instance's shared memory fits one block; its stages and planes
    start on 1,024-byte boundaries (the 128-byte swizzle is a function of
    the address); the block is two consumer warpgroups and a producer warp,
    whose nine warps take the register file as twelve do (it is given out
    by 4 warps): 168 a thread, which hold a consumer thread's running sums
    (6 m-tiles x 16) beside a group's fresh sums and one box's fragments (hi
    and lo terms of 4 k-steps); the ring holds a few stages."""
    threads = _constant("kTpThreads")
    assert threads == 2 * 128 + 32 and ROWS == 64 and _constant("kTpStages") >= 4
    assert "__launch_bounds__(kTpThreads, 1)" in SOURCE.read_text()
    warps = -(-threads // 32 // 4) * 4  # the register file is given out by 4 warps
    per_thread = min(255, REGISTERS // (warps * 32) // 8 * 8)
    assert per_thread == 168
    assert _constant("kTpSliceTiles") * 16 + 16 + 32 <= per_thread - 24
    assert _constant("kTpSliceTiles") * 64 >= 384  # the wide path's row in one slice
    for bf16 in (False, True):
        lay = _layout(bf16)
        assert lay["smem"] <= MAX_SMEM, (bf16, lay)
        assert lay["slot"] % 1024 == 0 and lay["p_term"] % 1024 == 0


def test_the_two_pass_route_launches_only_the_new_kernels():
    """The dx and dW wrappers and the pair reach the one C entry
    ``b4cp_ce_bwd_two_pass`` (which packs the live rows and launches
    ``ce_bwd_two_pass_kernel``, built on TMA loads, mbarriers and wgmma);
    the ``mma.sync`` pair, its header and its entries are gone; the route
    is the shape's alone."""
    text = SOURCE.read_text()
    assert "ce_bwd_two_pass_kernel" in text and "tma_load_2d" in text and "ss_box" in text
    assert "pack_live_rows" in text and "ce_dx_combine_kernel" in text
    assert not (CSRC / "fused_ce_mma.cuh").exists()
    assert "ce_table_aux_kernel" in text and "wgmma_bf16_m64n32k16_ss" in text
    for gone in ("ce_bwd_dx_mma_kernel", "ce_bwd_dw_mma_kernel", "tc::mma_tf32", "cp_async", "kDxNumerics"):
        for src in CSRC.glob("fused_ce*"):
            assert gone not in src.read_text(), (gone, src.name)
    entries = [name for name in _build.SIGNATURES if name.startswith("b4cp_ce_bwd")]
    assert entries == ["b4cp_ce_bwd", "b4cp_ce_bwd_two_pass"]
    assert not hasattr(k, "DX_TARGET_BLOCKS")
    wrapper = Path(k.__file__).read_text()
    assert wrapper.count("lib.b4cp_ce_bwd_two_pass(") == 1 and "b4cp_ce_bwd_dx" not in wrapper
    assert [k.ce_backward_route(d) for d in (256, 257, 384, 1024)] == ["merged", "two_pass", "two_pass", "two_pass"]
