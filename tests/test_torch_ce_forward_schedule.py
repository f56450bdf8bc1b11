"""The card's CE forward, its arithmetic and its schedule, emulated on the CPU.

``ce_fwd_wgmma_kernel`` (``bert4clickpath_torch/csrc/fused_ce.cu``) runs
only on the card. Two things it decides are held here instead:

* **Numerics.** A plain-PyTorch emulation of its f32 arithmetic: x and the
  table each split into tf32 terms the way the kernel splits them, the
  table by truncation (its chunk as loaded is the hi term, because a tf32
  product reads an f32's top 19 bits; lo = w - trunc(w), exact in f32, is
  truncated by the product in turn), x in registers by rounding
  (``cvt.rna.tf32.f32``: hi = round(v), lo = round(v - hi), to nearest with
  ties away from zero at the 13th mantissa bit), three products per
  32-column stage (lo . hi, hi . lo, hi . hi) summed exactly
  and rounded once to f32 (the stage's fresh sums), joined to the running
  logits by an f32 add that rounds to nearest, the bias added after, the
  window blinded, and the online (m, l) taken per 128-row vocab tile. It is
  held against the JAX ``_fwd_kernel`` (through ``_fwd_stats``, in
  interpret mode as ``tests/test_fused_ce.py`` runs it) and against the
  port's plain ``ce_stats_reference``, logz within abs 1e-4 (PERF.md
  section 2), at D in {64, 128, 256, 384} with ordinary logits and wide ones
  (a spread of ~30: each row's largest 110-125), a window that blinds rows
  at both ends. One tf32 product
  alone misses that tolerance at wide logits: the lo terms are needed.
  bf16 x: the table rounded to bf16 and one exact product.
* **Schedule.** The persistent grid's walk over units of (row tile of
  ``FWD_ROWS`` rows, vocab split), mirrored from ``CeFwdUnit``: one block
  an SM, block b taking units b, b + grid, ... with row tiles fastest.
  Every (row tile, vocab tile) pair is covered exactly once at a spread of
  (N, V), and the units that run side by side (one round of the grid) span
  few splits, so their blocks read the same table rows and share them
  through L2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert4clickpath_tpu.ops.pallas import fused_ce as jce
from bert4clickpath_torch.ops.kernels import fused_ce as k

torch.set_num_threads(1)

OFF = 10  # the window's first row
CHUNK = 32  # columns a stage (csrc/fused_ce.cu kCeFwdChunk)
SMS = 132  # the H100's SMs: the persistent grid's size


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """f32 rounded to tf32 as cvt.rna.tf32.f32 does: to nearest, ties away
    from zero, keeping 10 mantissa bits (the bits are sign and magnitude,
    so adding half an ulp to the integer rounds the magnitude)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _trunc(a: torch.Tensor) -> torch.Tensor:
    """f32 as a tf32 product reads it: its top 19 bits."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _terms(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x's split, in the consumers' registers: rounded to nearest."""
    hi = _tf32(a)
    return hi, _tf32(a - hi)


def _table_terms(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The table's split: raw f32 as hi (truncated by the product), lo the
    exact rest (truncated by the product too)."""
    hi = _trunc(a)
    return hi, _trunc(a - hi)


def _emulated_stats(x, table, bias, row_offset, num_valid, terms=3):
    """(m, l) as the kernel computes them for f32 x (one vocab split).
    ``terms``: 3 is the kernel's tf32 x3; 1 is one tf32 product (hi . hi)."""
    n, d = x.shape
    v = table.shape[0]
    xh, xl = _terms(x)
    wh, wl = _table_terms(table)
    s = torch.zeros((n, v), dtype=torch.float32)
    for c0 in range(0, d, CHUNK):
        c = slice(c0, c0 + CHUNK)
        prod = xh[:, c].double() @ wh[:, c].double().T
        if terms == 3:
            prod = prod + xl[:, c].double() @ wh[:, c].double().T + xh[:, c].double() @ wl[:, c].double().T
        s = s + prod.float()  # the stage's fresh sums joined with a round-to-nearest add
    if bias is not None:
        s = s + bias
    rows = torch.arange(v)
    s = torch.where((rows >= row_offset) & (rows < row_offset + num_valid), s, torch.full_like(s, k.NEG_BIG))
    m = torch.full((n,), k.NEG_BIG, dtype=torch.float32)
    l = torch.zeros(n, dtype=torch.float32)
    for j0 in range(0, v, k.FWD_VOCAB):
        tile = s[:, j0 : j0 + k.FWD_VOCAB]
        m_new = torch.maximum(m, tile.max(dim=1).values)
        l = l * torch.exp(m - m_new) + torch.exp(tile - m_new[:, None]).sum(dim=1)
        m = m_new
    return m, l


def _inputs(n, v, d, wide, seed, with_bias=True):
    """x and a table whose logits have a spread of ~1.5 (ordinary) or ~30
    (wide: the largest ~110-125), and a bias."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    spread = 30.0 if wide else 1.5
    table = (rng.normal(size=(v, d)) * spread / np.sqrt(d)).astype(np.float32)
    bias = rng.normal(size=(v,)).astype(np.float32) if with_bias else None
    return x, table, bias


def _jax_logz(x, table, bias, nv, bf16=False):
    jx = jnp.asarray(x).astype(jnp.bfloat16 if bf16 else jnp.float32)
    jm, jl = jce._fwd_stats(jx, jnp.asarray(table), jnp.asarray(0, jnp.int32), OFF, nv,
                            bias=None if bias is None else jnp.asarray(bias).reshape(1, -1))
    return np.asarray(jm).reshape(-1) + np.log(np.asarray(jl).reshape(-1))


@pytest.mark.parametrize("wide", [False, True], ids=["ordinary", "wide"])
@pytest.mark.parametrize("d", [64, 128, 256, 384])
def test_forward_numerics_hold_logz(d, wide):
    """The emulated tf32 x3 arithmetic against the JAX forward (interpret
    mode) and the plain version: logz within abs 1e-4. V = 300 spans three
    vocab tiles (the last ragged), N = 40 rows, the window blinds 10 rows
    before it and 7 after."""
    n, v = 40, 300
    nv = v - OFF - 7
    x, table, bias = _inputs(n, v, d, wide, seed=d + int(wide))
    tx, tt, tb = torch.from_numpy(x), torch.from_numpy(table), torch.from_numpy(bias)
    m, l = _emulated_stats(tx, tt, tb, OFF, nv)
    logz = (m + torch.log(l)).numpy()
    assert np.isfinite(logz).all()
    if wide:
        assert np.abs(m.numpy()).max() > 100  # the spread this case is for
    wm, wl = k.ce_stats_reference(tx, tt, tb, OFF, nv)
    np.testing.assert_allclose(logz, (wm + torch.log(wl)).numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(logz, _jax_logz(x, table, bias, nv), rtol=0, atol=1e-4)


@pytest.mark.parametrize("d", [128, 256])
def test_one_tf32_product_misses_wide_logits(d):
    """Why the kernel runs three products: one tf32 product (hi . hi) errs
    by ~|s| 2^-11 per logit and misses 1e-4 on logz at wide logits, where
    the three-product emulation holds it (previous test)."""
    n, v = 40, 300
    nv = v - OFF - 7
    x, table, bias = _inputs(n, v, d, True, seed=7 + d)
    tx, tt, tb = torch.from_numpy(x), torch.from_numpy(table), torch.from_numpy(bias)
    want = _jax_logz(x, table, bias, nv)
    m1, l1 = _emulated_stats(tx, tt, tb, OFF, nv, terms=1)
    m3, l3 = _emulated_stats(tx, tt, tb, OFF, nv, terms=3)
    assert np.abs((m1 + torch.log(l1)).numpy() - want).max() > 1e-4
    assert np.abs((m3 + torch.log(l3)).numpy() - want).max() <= 1e-4


@pytest.mark.parametrize("d", [128, 384])
def test_bf16_forward_is_one_exact_product(d):
    """bf16 x: the kernel rounds the table to bf16 (the JAX kernel's
    w.astype(x.dtype)) and runs one bf16 product whose terms are exact in
    f32; emulated with f64 products over the same rounded operands, rounded
    once a stage, against the JAX forward on bf16 x: logz within 1e-4."""
    n, v = 40, 300
    nv = v - OFF - 7
    x, table, bias = _inputs(n, v, d, True, seed=11 + d)
    xb = torch.from_numpy(x).to(torch.bfloat16).double()
    wb = torch.from_numpy(table).to(torch.bfloat16).double()
    s = torch.zeros((n, v), dtype=torch.float32)
    for c0 in range(0, d, CHUNK):
        s = s + (xb[:, c0 : c0 + CHUNK] @ wb[:, c0 : c0 + CHUNK].T).float()
    s = s + torch.from_numpy(bias)
    s[:, :OFF] = k.NEG_BIG
    s[:, OFF + nv :] = k.NEG_BIG
    logz = torch.logsumexp(s.double(), dim=1).numpy()
    np.testing.assert_allclose(logz, _jax_logz(x, table, bias, nv, bf16=True), rtol=0, atol=1e-4)


def _walk(n, v, sms=SMS):
    """The kernel's units, as CeFwdUnit and the block loop compute them:
    [(block, round, row tile, split, j0, j1)]."""
    splits, per = k.ce_splits(n, v)
    row_tiles = -(-n // k.FWD_ROWS)
    units = row_tiles * splits
    grid = min(units, sms)
    n_vtiles = -(-v // k.FWD_VOCAB)
    out = []
    for b in range(grid):
        for r, u in enumerate(range(b, units, grid)):
            split = u // row_tiles
            j0 = split * per
            out.append((b, r, u % row_tiles, split, j0, min(n_vtiles, j0 + per)))
    return out, row_tiles, n_vtiles, grid


@pytest.mark.parametrize(
    "n,v",
    [(2560, 55296), (160, 20480), (1, 1), (1, 64), (70000, 64), (5, 100000), (130, 700), (64, 65),
     (2560, 10_000_384)],
)
def test_forward_units_cover_every_tile_pair_once(n, v):
    """Every (row tile, vocab tile) pair exactly once over the blocks'
    units, at the spread of (N, V) of the split rule's test and the large
    catalog; no block idles while another holds two units more than it;
    each round of the grid spans at most grid / row tiles + 2 splits (the
    units that run side by side read the same table rows)."""
    walk, row_tiles, n_vtiles, grid = _walk(n, v)
    per_row = {}
    for _, _, rt, _, j0, j1 in walk:
        assert j0 < j1, (n, v)  # no empty unit
        per_row.setdefault(rt, []).append((j0, j1))
    assert sorted(per_row) == list(range(row_tiles))
    for ranges in per_row.values():
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == n_vtiles
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))  # contiguous, no overlap
    counts = np.bincount([b for b, *_ in walk], minlength=grid)
    assert counts.max() - counts.min() <= 1
    rounds = {}
    for _, r, _, split, _, _ in walk:
        rounds.setdefault(r, set()).add(split)
    assert max(len(s) for s in rounds.values()) <= grid // row_tiles + 2
