"""The card's merged CE backward, its arithmetic and its schedule, emulated on the CPU.

``ce_bwd_merged_wgmma_kernel`` (``bert4clickpath_torch/csrc/fused_ce.cu``)
runs only on the card. What it decides is held here instead:

* **Numerics.** A plain-PyTorch emulation of its f32 arithmetic at its own
  granularity: the live rows packed in order; the scores S = x . W^T with
  x split in registers by rounding (``cvt.rna.tf32.f32``: hi = round(v),
  lo = round(v - hi)) and the table's planes truncated (the raw tile is
  the hi term, lo = w - trunc(w), each read as its top 19 bits by the
  product), three products a k-step summed exactly and rounded once per
  32-column box, the boxes joined by round-to-nearest f32 adds; A =
  dnll (exp(s (+ b) - logz) - onehot) in f32, written to shared memory
  as raw f32 (truncated by the product) with a truncated lo term; dW^T =
  x^T . A with x^T split by rounding, its three products summed exactly
  and rounded once per stage of 64 rows, the stages joined by
  round-to-nearest adds; dx^T = W^T . A^T with W^T split by rounding,
  rounded once per unit of table rows and summed across units in f32 (the
  kernel's reduce-adds, in another order each run); db the f32 sum of the
  unrounded A. It is held against the JAX merged backward ``_bwd_fused``
  (interpret mode, as ``tests/test_torch_two_pass.py`` runs it) and the
  port's ``ce_backward_reference``: dx, dW and db within 1e-4 of the
  largest magnitude (``CE_GRAD_REL``), at D in {8, 72, 128, 200, 256},
  ordinary and wide logits, LABEL_PAD rows, a label outside the window,
  a window that blinds rows at both ends. bf16 x: W rounded to bf16, A
  rounded once, one exact product (64-column boxes, 64-row units); within
  2e-2.
* **The walk.** The persistent grid's units cover every table tile once
  (the real row list is held on the card, ``tests/test_torch_cuda.py``).
* **The constants fit the card.** Each instance's shared memory (the
  table tile's two planes, the four A planes, the ring of x stages, the
  db scratch, barriers and alignment) within 232,448 bytes; the
  setmaxnreg split within 65,536 registers.

The kernel itself is held on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``, ``examples/long_context/ce_bwd_probe.py``).
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
from bert4clickpath_torch.ops.kernels import fused_ce as k

torch.set_num_threads(1)

SOURCE = Path(k.__file__).resolve().parents[2] / "csrc" / "fused_ce.cu"
OFF = 10  # the window's first row
BOX = 32  # f32 columns of a 128-byte box
SMS = 132  # the H100's SMs: the persistent grid's size
MAX_SMEM = 232_448  # the most dynamic shared memory one block can have on sm_90
CE_GRAD_REL = 1e-4  # chip_smoke.py: f32 gradients, of the largest magnitude


def _text() -> str:
    return SOURCE.read_text()


def _constant(name: str) -> int:
    found = re.search(rf"constexpr int {name} = (\d+);", _text())
    assert found, name
    return int(found.group(1))


def _per_instance(name: str, dp: int) -> int:
    """A per-instance constant of the form ``DP > 128 ? a : b``."""
    found = re.search(rf"constexpr int {name} = DP > 128 \? (\d+) : (\d+);", _text())
    assert found, name
    return int(found.group(1) if dp > 128 else found.group(2))


ROWS = _constant("kCeBwdRows")  # rows of packed x a stage
INSTANCES = (128, 256)


def _instance(d: int) -> int:
    return next(p for p in INSTANCES if d <= p)


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


def _emulated_merged(x, table, bias, lab, logz, dnll, row_offset, num_valid):
    """(dx, dW, db) as the card computes them for f32 x (tf32 x3), or for
    bf16 x (one exact bf16 product, W and A rounded to bf16)."""
    n, d = x.shape
    v = table.shape[0]
    bf16 = x.dtype == torch.bfloat16
    tv = ROWS if bf16 else _per_instance("kCeBwdTv", _instance(d))  # bf16 x: 64-row units
    group = 64 if bf16 else BOX  # columns of a 128-byte box: a group of the scores' fresh sums
    rows = torch.from_numpy(np.nonzero(dnll.numpy())[0])  # packed in order
    pos = np.full(n, -1, np.int64)  # each row's place in the packed list
    pos[rows.numpy()] = np.arange(rows.shape[0])
    xp = x[rows].float()  # the packed rows, and their (logz, dnll, label)
    lz, dn, lb = logz[rows], dnll[rows], lab[rows].long()
    nl = rows.shape[0]
    if bf16:  # exact products of the rounded operands
        w = table.to(torch.bfloat16).float()
        x_reg = x_pl = (xp, torch.zeros_like(xp))
        w_pl = w_reg = (w, torch.zeros_like(w))
    else:
        x_reg, w_pl, w_reg = _terms(xp), _plane_terms(table), _terms(table)
    s = torch.zeros((nl, v), dtype=torch.float32)
    for c0 in range(0, d, group):  # a group's fresh sums, joined to s by a round-to-nearest add
        c = slice(c0, c0 + group)
        s = s + _x3((x_reg[0][:, c], x_reg[1][:, c]), (w_pl[0][:, c].T, w_pl[1][:, c].T))
    if bias is not None:
        s = s + bias
    vrows = torch.arange(v)
    s = torch.where((vrows >= row_offset) & (vrows < row_offset + num_valid), s, torch.full_like(s, k.NEG_BIG))
    a = dn[:, None] * (torch.exp(s - lz[:, None]) - (vrows[None] == lb[:, None]).float())
    ab = a.to(torch.bfloat16).float() if bf16 else a
    a_pl = (ab, torch.zeros_like(ab)) if bf16 else _plane_terms(ab)
    dw = torch.zeros((v, d), dtype=torch.float32)
    for r0 in range(0, nl, ROWS):  # dW^T = x^T . A, a stage's fresh sums joined by round-to-nearest adds
        r = slice(r0, r0 + ROWS)
        dw = dw + _x3((x_reg[0][r].T, x_reg[1][r].T), (a_pl[0][r], a_pl[1][r])).T
    dxp = torch.zeros((nl, d), dtype=torch.float32)
    for u0 in range(0, v, tv):  # dx^T = W^T . A^T, a unit's sums added into the packed f32 dx
        u = slice(u0, u0 + tv)
        dxp = dxp + _x3((w_reg[0][u].T, w_reg[1][u].T), (a_pl[0][:, u].T, a_pl[1][:, u].T)).T
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


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("wide", [False, True], ids=["ordinary", "wide"])
@pytest.mark.parametrize("d", [8, 72, 128, 200, 256])
def test_emulated_f32_backward_holds_against_jax_and_plain(d, wide, with_bias):
    """The emulated tf32 x3 kernel against JAX ``_bwd_fused`` (interpret
    mode) and the plain version: dx, dW and db within 1e-4 of the largest
    magnitude. N = 100 (80 live rows: one whole stage and a ragged one), V
    = 300 (several units, the last ragged)."""
    n, v = 100, 300
    x, table, bias, labels, dnll, nv = _case(n, v, d, wide, seed=d + 2 * wide + with_bias, with_bias=with_bias)
    tx, tt = torch.from_numpy(x), torch.from_numpy(table)
    tb = None if bias is None else torch.from_numpy(bias)
    lab = tce._labels_model(torch.from_numpy(labels), OFF)
    m, l = k.ce_stats_reference(tx, tt, tb, OFF, nv)
    logz = m + torch.log(l)
    args = (tx, tt, tb, lab, logz, torch.from_numpy(dnll), OFF, nv)
    got = _emulated_merged(*args)
    plain = k.ce_backward_reference(*args)
    want = jce._bwd_fused(jnp.asarray(x), jnp.asarray(table), jce._labels_model(jnp.asarray(labels), OFF),
                          jnp.asarray(logz.numpy()), jnp.asarray(dnll), OFF, nv,
                          bias=None if bias is None else jnp.asarray(bias).reshape(1, -1))
    if wide:
        assert m.abs().max() > 50  # the spread this case is for
    for i in range(3 if with_bias else 2):
        _held(got[i], plain[i].numpy(), CE_GRAD_REL)
        _held(got[i], np.asarray(want[i]).reshape(plain[i].shape), CE_GRAD_REL)
    assert got[2] is None or with_bias
    assert (got[0][labels == LABEL_PAD] == 0).all()  # rows not walked: dx exactly 0
    # blinded rows get exactly 0, but for the one row 1 is labelled with
    # (its one-hot: -dnll, as in the JAX kernel)
    blinded = np.setdiff1d(np.r_[0:OFF, OFF + nv : v], [OFF + nv + 3])
    assert (got[1][OFF + nv + 3] != 0).any()
    assert (got[1][blinded] == 0).all() and (with_bias is False or (got[2][blinded] == 0).all())


@pytest.mark.parametrize("d", [72, 256])
def test_emulated_bf16_backward_holds_against_jax_and_plain(d):
    """bf16 x: W rounded to bf16, A rounded once, one exact product a
    k-step, against JAX ``_bwd_fused`` on bf16 x and the plain version:
    within 2e-2 of the largest magnitude (an A entry may round to the other
    bf16 neighbour, dx rounds once to bf16)."""
    n, v = 100, 300
    x, table, bias, labels, dnll, nv = _case(n, v, d, True, seed=40 + d, with_bias=True)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tt, tb = torch.from_numpy(table), torch.from_numpy(bias)
    lab = tce._labels_model(torch.from_numpy(labels), OFF)
    m, l = k.ce_stats_reference(tx, tt, tb, OFF, nv)
    logz = m + torch.log(l)
    args = (tx, tt, tb, lab, logz, torch.from_numpy(dnll), OFF, nv)
    got = _emulated_merged(*args)
    plain = k.ce_backward_reference(*args)
    want = jce._bwd_fused(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(table),
                          jce._labels_model(jnp.asarray(labels), OFF), jnp.asarray(logz.numpy()),
                          jnp.asarray(dnll), OFF, nv, bias=jnp.asarray(bias).reshape(1, -1))
    for i in range(3):
        _held(got[i], plain[i].float().numpy(), 2e-2)
        _held(got[i], np.asarray(want[i].astype(jnp.float32)).reshape(plain[i].shape), 2e-2)


def test_one_tf32_product_misses_the_gradients():
    """Why each product runs three terms: with one tf32 product (hi . hi)
    in all three products the gradients miss 1e-4 of their largest
    magnitude at wide logits, where the emulation above holds them."""
    n, v, d = 100, 300, 256
    x, table, bias, labels, dnll, nv = _case(n, v, d, True, seed=5, with_bias=True)
    tx, tt, tb = torch.from_numpy(x), torch.from_numpy(table), torch.from_numpy(bias)
    lab = tce._labels_model(torch.from_numpy(labels), OFF)
    m, l = k.ce_stats_reference(tx, tt, tb, OFF, nv)
    args = (tx, tt, tb, lab, m + torch.log(l), torch.from_numpy(dnll), OFF, nv)
    plain = k.ce_backward_reference(*args)
    xs, ws = _tf32(tx), _tf32(tt)
    a = k._adjoint(xs, ws, tb, lab, args[4], args[5], OFF, nv)
    one = (_tf32(a) @ ws, _tf32(a).T @ xs)
    missed = [np.abs(g.numpy() - p.numpy()).max() / np.abs(p.numpy()).max() for g, p in zip(one, plain)]
    assert max(missed) > CE_GRAD_REL


def _units(v: int, dp: int, sms: int = SMS) -> dict:
    """Block b's units, as the kernel's loop takes them: b, b + grid, ...;
    unit u is table rows u Tv .. (u + 1) Tv."""
    tv = _per_instance("kCeBwdTv", dp)
    units = -(-v // tv)
    grid = min(units, sms)
    return {b: list(range(b, units, grid)) for b in range(grid)}, tv


def test_units_cover_every_table_row_once():
    """At each instance's unit size: every table row in exactly one unit of
    one block, the blocks' unit counts within one of each other; the rows
    past V of the last unit are the ones the kernel masks (A = 0)."""
    for dp in INSTANCES:
        for v in (1, 31, 64, 65, 300, 20_480, 55_296, 10_000_384):
            walk, tv = _units(v, dp)
            covered = np.zeros(-(-v // tv) * tv, np.int8)
            for units in walk.values():
                for u in units:
                    covered[u * tv : (u + 1) * tv] += 1
            assert (covered == 1).all() and covered.size - v < tv, (v, dp)
            counts = [len(u) for u in walk.values()]
            assert max(counts) - min(counts) <= 1, (v, dp)


def test_the_constants_fit_the_card():
    """Each instance's shared memory fits one block; its planes and boxes
    start on 1,024-byte boundaries (the 128-byte swizzle is a function of
    the address); the setmaxnreg split fits the register file; a consumer
    thread's accumulators leave room for its fragments."""
    threads, converters = _constant("kCeBwdThreads"), _constant("kCeBwdConverters")
    producer, consumer = _constant("kCeBwdProducerRegs"), _constant("kCeBwdConsumerRegs")
    assert ROWS == 64 and threads == 384 and converters == 96
    assert 128 * producer + 256 * consumer <= 65536 and producer % 8 == 0 and consumer % 8 == 0 and producer >= 24
    for dp in INSTANCES:
        tv, stages = _per_instance("kCeBwdTv", dp), _per_instance("kCeBwdStages", dp)
        boxes = dp // BOX
        w_plane, x_stage, a_plane = boxes * tv * 128, boxes * ROWS * 128, tv * ROWS * 4
        smem = 2 * w_plane + 4 * a_plane + stages * x_stage + 4 * tv * 4 + (3 + 2 * stages) * 8 + 1024
        assert smem <= MAX_SMEM, (dp, smem)
        # bf16 x: 64-row units; the raw f32 tile, its bf16 plane, two bf16 A
        # planes, bf16 stages; the raw tile is dx's staging (64 x dp f32)
        raw = boxes * ROWS * 128
        bf16 = raw + raw // 2 + 2 * ROWS * ROWS * 2 + stages * x_stage // 2 + 4 * ROWS * 4 + (3 + 2 * stages) * 8 + 1024
        assert bf16 <= MAX_SMEM and raw == ROWS * dp * 4, (dp, bf16)
        assert all(size % 1024 == 0 for size in (tv * 128, ROWS * 128, a_plane, x_stage, tv // 2 * 128))
        assert stages >= 2 and tv % 32 == 0 and tv // 2 in (16, 32)
        # f32 values a consumer thread holds at most: the running dW^T (its
        # m-tiles x tv / 2), then the largest phase: the scores (running and
        # fresh, and one box's fragments), dW^T's fresh sums and 8 k-steps
        # of fragments, or dx^T's sums and tv / 8 k-steps of fragments
        m_tiles = dp // 128
        phases = (2 * (tv // 4) + 4 * 8, tv // 2 + 8 * 8, ROWS // 2 + tv // 8 * 8)
        assert m_tiles * tv // 2 + max(phases) <= consumer - 48, dp


def test_the_merged_route_takes_the_new_kernel_only():
    """f32 and bf16 x take ce_bwd_merged_wgmma_kernel through the packed
    rows (the C entry's width check is the route's: D <= MAX_D); nothing of
    the mma.sync merged backward it replaced is left, and the two-pass pair
    above MAX_D is the TMA + wgmma kernel of fused_ce_two_pass.cu, which
    shares the row packing (fused_ce_common.cuh)."""
    text = _text()
    assert "ce_bwd_merged_wgmma_kernel" in text and "bwd_merged(" in text and "launch_dw_mma" not in text
    assert not (SOURCE.parent / "fused_ce_mma.cuh").exists()
    common = (SOURCE.parent / "fused_ce_common.cuh").read_text()
    for gone in ("mrg_dx_product", "add_dx", "kMrgOutChunks", "kMrgDxReduce", "copy_row", "bool DX"):
        assert gone not in text and gone not in common, gone
    assert "ce_live_rows_kernel" in common and "pack_live_rows(" in text
    two_pass = (SOURCE.parent / "fused_ce_two_pass.cu").read_text()
    assert "ce_bwd_two_pass_kernel" in two_pass and "pack_live_rows(" in two_pass and "ce_bwd_dw_mma_kernel" not in two_pass
    assert k.MAX_D == 256 and k.ce_backward_route(256) == "merged" and k.ce_backward_route(257) == "two_pass"
