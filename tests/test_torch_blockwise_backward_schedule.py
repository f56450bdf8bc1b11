"""The card's bf16 blockwise attention backward (dq and dk/dv), its
arithmetic, its schedule and its operand rules, emulated on the CPU.

``bmha_dq_wgmma_kernel`` and ``bmha_dkv_wgmma_kernel``
(``bert4clickpath_torch/csrc/attention_blockwise.cu``) run only on the card.
What they decide is held here instead:

* **Numerics.** A plain-PyTorch emulation of their steps at their stage
  granularity: dq walks stages of 128 keys, dk/dv stages of ``kDkvWalk``
  query rows (128; 64 at the 128-wide head instance); in each, the scores'
  f32 sums of exact bf16 products, s = fma(q . k, scale, bias), p =
  exp(s - lse) in f32, ds = p (dp - delta) scale from that f32 p rounded to
  bf16, p rounded to bf16 before dv, the stage's products added to f32
  sums, one rounding at the end. It is held against the JAX ``_bmha_bwd``
  kernels on the same residuals (out, lse) and inputs, in interpret mode,
  forced onto small tiles as ``tests/test_torch_long_context.py`` forces
  them, and against the port's plain ``blockwise_dq_reference`` /
  ``blockwise_dkv_reference``, within the bound ``chip_smoke.py`` holds the
  kernels to (BLOCKWISE_BWD_TOL, bf16: 2e-3 of the largest gradient floored
  at 1e-2, plus 2^-6 of the reference; the fully padded batch row against
  its own largest magnitude). The JAX kernels run in f32 on the same
  bf16-valued inputs: in bf16 they round every tile pair's partial gradient
  to bf16 as they add it (``tests/test_torch_long_context.py`` holds the
  plain version to them at abs 2e-2 there), so in f32 they give the
  gradient that the port's roundings of p and ds are measured from. Head
  widths 16, 24, 32, 64 and 128 (24 lies in the 32-wide instance), L = 70
  (one ragged stage) and 129 (a second stage of one key) against both,
  L = 1000 against the plain version. Each batch holds a fully padded row
  and, where L > 128, a row whose first stage is all padding.
* **Rows past seq_len.** The last stage's boxes reach past a batch row's
  end: dq's bias box holds the next batch row's bias there, and a box over
  the (B, L, H) lse and delta would hold the next row's. With a next row
  that is fully padded (lse -1e9) or a current one that is, p = exp(+1e9)
  would be inf and the gradients NaN: the kernels mask such keys (bias
  -inf) and such query rows (lse +inf, delta 0, copied by a producer warp
  with plain loads: one head's rows are H floats apart, which no TMA box
  describes), so their p is exactly 0.
* **Schedule.** Both kernels' persistent walk over units of 128 rows
  (query rows in dq, keys in dk/dv) of one (head, batch row), mirrored from
  ``FwdUnit``: every unit exactly once, and each unit's stages covering
  every key (dq) or query row (dk/dv) once.
* **Constants.** Each instance's shared memory (rings, buffers, bias
  boxes, lse and delta rows, barriers) within one block's 232,448 bytes,
  the setmaxnreg split within the 65,536 registers of an SM, and the
  accumulators a consumer thread holds within its share.
* **Tensor-map operands.** The backward reads q, k, v and do through
  ``_tma_operands`` like the forward, counting its copies under
  ``blockwise_bwd``: strided projection slices and a contiguous do pass as
  they are; a misaligned input is copied; a head width off 16 bytes pads
  all four.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bert4clickpath_tpu.ops.pallas.attention as jattn
from bert4clickpath_torch.ops.kernels import _build
from bert4clickpath_torch.ops.kernels import attention as attn

torch.set_num_threads(1)

SOURCE = Path(attn.__file__).resolve().parents[2] / "csrc" / "attention_blockwise.cu"
SMS = 132  # the H100's SMs: the persistent grid's size
SHARE, FLOOR, RTOL = 2e-3, 1e-2, 2.0**-6  # chip_smoke.py BLOCKWISE_BWD_TOL, bf16


def _text() -> str:
    return SOURCE.read_text()


def _constant(name: str) -> int:
    """A constexpr int of the kernel's source: a literal, or a sum of
    literals and other such constants."""
    found = re.search(rf"constexpr int {name} = ([\w +]+);", _text())
    assert found, name
    return sum(int(term) if term.isdigit() else _constant(term) for term in found.group(1).split(" + "))


def _per_width(name: str, dhp: int) -> int:
    """A per-instance constant of the form ``DHP == 128 ? a : b`` or a
    literal, at head-width instance ``dhp``."""
    found = re.search(rf"constexpr int {name} = (?:DHP == (\d+) \? (\d+) : )?(\d+);", _text())
    assert found, name
    at, then, other = found.groups()
    return int(then) if at is not None and dhp == int(at) else int(other)


ROWS = _constant("kBwdRows")  # rows a unit owns
KEYS = _constant("kFwdKeys")  # keys of a dq stage (the forward's stage)
INSTANCES = (16, 32, 64, 128)


def _instance(dh: int) -> int:
    return next(p for p in INSTANCES if dh <= p)


def _walk(dh: int) -> int:
    """Query rows of a dk/dv stage at head width dh."""
    return _per_width("kDkvWalk", _instance(dh))


def _case(b, l, dh, heads, seed):
    """bf16 q, k, v, do (B, L, dh * heads) and a (B, 1, 1, L) f32 bias: row
    0 fully padded, row 1 with its first stage all padding then one real key
    (L > 128; ragged otherwise), the others ragged."""
    rng = np.random.default_rng(seed)
    d = dh * heads
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, l, d), dtype=np.float32)).bfloat16() for _ in range(4))
    bias = np.zeros((b, 1, 1, l), np.float32)
    for i, n in enumerate(rng.integers(1, l + 1, size=b)):
        bias[i, ..., n:] = -1e9
    bias[0] = -1e9
    if b > 1 and l > KEYS:
        bias[1] = -1e9
        bias[1, ..., l - 1] = 0.0
    return q, k, v, do, torch.from_numpy(bias)


def _split(t, heads):
    return t.unflatten(-1, (heads, t.shape[-1] // heads)).double()


def _rows(x):
    """(B, L, H) -> (B, H, L, 1)"""
    return x.transpose(1, 2).unsqueeze(-1)


def _p_ds(s, bias, lse, dp, delta, scale):
    """p and ds of the kernels from f32 dot products s and dp: s = fma(s,
    scale, bias) (one rounding), p = exp(s - lse) and ds = (p (dp - delta))
    scale in f32, ds rounded to bf16."""
    s = (s.double() * scale + bias.double()).float()
    p = torch.exp(s - lse)
    return p, (p * (dp - delta) * scale).bfloat16()


def _emulated_dq(q, k, v, bias, lse, do, delta, heads):
    """dq as the dq kernel computes it, stage by stage of KEYS keys."""
    b, l, d = q.shape
    scale = float(np.float32(1.0 / (d // heads) ** 0.5))  # the kernels' f32 argument
    qf, kf, vf, dof = (_split(t, heads) for t in (q, k, v, do))
    acc = torch.zeros((b, heads, l, d // heads))
    for k0 in range(0, l, KEYS):
        ks = slice(k0, k0 + KEYS)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, ks]).float()
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf[:, ks]).float()
        _, ds = _p_ds(s, bias[..., ks], _rows(lse), dp, _rows(delta), scale)
        acc = acc + torch.einsum("bhqk,bkhd->bhqd", ds.double(), kf[:, ks]).float()
    return acc.transpose(1, 2).reshape(b, l, d).bfloat16()


def _emulated_dkv(q, k, v, bias, lse, do, delta, heads, walk):
    """(dk, dv) as the dk/dv kernel computes them, stage by stage of
    ``walk`` query rows (the transposed products are the same sums)."""
    b, l, d = q.shape
    scale = float(np.float32(1.0 / (d // heads) ** 0.5))
    qf, kf, vf, dof = (_split(t, heads) for t in (q, k, v, do))
    acc_k = torch.zeros((b, heads, l, d // heads))
    acc_v = torch.zeros_like(acc_k)
    for q0 in range(0, l, walk):
        qs = slice(q0, q0 + walk)
        s = torch.einsum("bqhd,bkhd->bhqk", qf[:, qs], kf).float()
        dp = torch.einsum("bqhd,bkhd->bhqk", dof[:, qs], vf).float()
        p, ds = _p_ds(s, bias, _rows(lse)[:, :, qs], dp, _rows(delta)[:, :, qs], scale)
        acc_v = acc_v + torch.einsum("bhqk,bqhd->bhkd", p.bfloat16().double(), dof[:, qs]).float()
        acc_k = acc_k + torch.einsum("bhqk,bqhd->bhkd", ds.double(), qf[:, qs]).float()
    out = lambda a: a.transpose(1, 2).reshape(b, l, d).bfloat16()  # noqa: E731
    return out(acc_k), out(acc_v)


def _used(got, want) -> float:
    """The largest share of BLOCKWISE_BWD_TOL that got uses about want;
    batch row 0 (fully padded) against its own largest magnitude."""
    diff = (got.double() - want.double()).abs()
    used = 0.0
    for part in (slice(0, 1), slice(1, None)):
        w = want[part].double().abs()
        atol = SHARE * max(w.max().item(), FLOOR)
        used = max(used, (diff[part] / (atol + RTOL * w)).max().item())
    return used


def _residuals(q, k, v, bias, do, heads):
    """out (f32), lse and delta (B, L, H) from the JAX forward in f32 on the
    bf16 values, as both sides take them."""
    as_jax = lambda t: jnp.asarray(t.float().numpy())  # noqa: E731
    jout, jlse = jattn._bmha_fwd(as_jax(q), as_jax(k), as_jax(v), jnp.asarray(bias.numpy()), heads)
    out = torch.from_numpy(np.array(jout))
    lse = torch.from_numpy(np.array(jlse)[..., :heads].copy())
    return out, lse, attn.attention_delta(do, out, heads), (jout, jlse)


def _divisor_tile(l):
    """The JAX kernels' tiles must divide L: the largest divisor of L up to
    48 (several tiles: L = 70 walks 5 of 14, L = 129 walks 3 of 43)."""
    return max(t for t in range(1, 49) if l % t == 0)


@pytest.mark.parametrize("l", [70, 129])
@pytest.mark.parametrize("dh,heads", [(16, 2), (24, 2), (32, 2), (64, 2), (128, 2)])
def test_emulated_backward_holds_against_jax_and_plain(monkeypatch, dh, heads, l):
    """The emulation against the JAX dq and dk/dv kernels (interpret mode,
    small tiles, f32 on the bf16 values, the same residuals) and the port's
    plain versions, at the kernels' bound."""
    tile = _divisor_tile(l)
    monkeypatch.setattr(jattn, "_bmha_blocks", lambda l_, d_, itemsize=2: (tile, tile))
    monkeypatch.setattr(jattn, "fused_mha_supported", lambda *a, **k: False)
    q, k, v, do, bias = _case(3, l, dh, heads, seed=dh + l)
    out, lse, delta, (jout, jlse) = _residuals(q, k, v, bias, do, heads)
    got = (_emulated_dq(q, k, v, bias, lse, do, delta, heads),
           *_emulated_dkv(q, k, v, bias, lse, do, delta, heads, _walk(dh)))
    assert all(torch.isfinite(g.float()).all() for g in got)
    args = (q, k, v, bias, lse, do, delta, heads)
    plain = (attn.blockwise_dq_reference(*args), *attn.blockwise_dkv_reference(*args))
    as_jax = lambda t: jnp.asarray(t.float().numpy())  # noqa: E731
    jgrads = jattn._bmha_bwd(heads, (as_jax(q), as_jax(k), as_jax(v), jnp.asarray(bias.numpy()), jout, jlse),
                             (as_jax(do), None))[:3]
    for name, g, p, j in zip(("dq", "dk", "dv"), got, plain, jgrads):
        assert _used(g, p) <= 1.0, f"{name} against the plain version: {_used(g, p):.3f} of the bound"
        j = torch.from_numpy(np.array(j))
        assert _used(g, j) <= 1.0, f"{name} against the JAX kernel: {_used(g, j):.3f} of the bound"


@pytest.mark.parametrize("dh,heads", [(16, 2), (24, 2), (32, 2), (64, 2), (128, 2)])
def test_emulated_backward_holds_at_l_1000(dh, heads):
    """Eight dq stages, the last ragged (1000 = 7 x 128 + 104), and 8 or 16
    dk/dv stages, against the plain versions; batch row 0 fully padded, row
    1 with its first stage all padding and its last key real."""
    q, k, v, do, bias = _case(2, 1000, dh, heads, seed=dh)
    out, lse = attn.blockwise_mha_reference(q, k, v, bias, heads)
    delta = attn.attention_delta(do, out, heads)
    args = (q, k, v, bias, lse, do, delta, heads)
    got = (_emulated_dq(*args), *_emulated_dkv(*args, _walk(dh)))
    plain = (attn.blockwise_dq_reference(*args), *attn.blockwise_dkv_reference(*args))
    for name, g, p in zip(("dq", "dk", "dv"), got, plain):
        assert torch.isfinite(g.float()).all(), name
        assert _used(g, p) <= 1.0, f"{name}: {_used(g, p):.3f} of the bound"


def test_stage_walk_moves_the_sums_only_within_the_bound():
    """The stage walk changes where the f32 sums round, not what is
    computed: the emulation and the plain version (one product over all
    keys) differ in some bits, within the bound."""
    q, k, v, do, bias = _case(2, 300, 64, 2, seed=1)
    bias.zero_()
    out, lse = attn.blockwise_mha_reference(q, k, v, bias, 2)
    args = (q, k, v, bias, lse, do, attn.attention_delta(do, out, 2), 2)
    got, plain = _emulated_dq(*args), attn.blockwise_dq_reference(*args)
    assert not torch.equal(got, plain) and _used(got, plain) <= 1.0


# -- rows past seq_len -------------------------------------------------------------


def _box_case(full_row: int):
    """B = 2, L = 70 (one ragged stage), 2 heads of 32: batch row
    ``full_row`` fully padded, the other's keys all real; out, lse, delta from
    the plain forward."""
    q, k, v, do, _ = _case(2, 70, 32, 2, seed=5)
    bias = torch.zeros((2, 1, 1, 70))
    bias[full_row] = -1e9
    out, lse = attn.blockwise_mha_reference(q, k, v, bias, 2)
    return q, k, v, do, bias, lse, attn.attention_delta(do, out, 2)


def _padded_rows(t, rows):
    """t (B, L, D) with zero rows appended up to ``rows``: what TMA fills
    past seq_len within a batch row."""
    b, l, d = t.shape
    return torch.cat([t, t.new_zeros((b, rows - l, d))], dim=1)


def test_dq_masks_the_next_rows_bias_past_seq_len():
    """dq's one stage of 128 keys at L = 70: the bias box starts at b L and
    its keys 70-127 hold the next batch row's bias (here 0: real keys), the
    K and V rows there are zeros. For the fully padded batch row 0 (lse
    -1e9) p = exp(0 + 1e9) is inf there and dq NaN unless those keys get
    -inf as the kernel gives them; masked, the stage equals the one over
    the 70 keys, bit for bit."""
    q, k, v, do, bias, lse, delta = _box_case(full_row=0)
    flat = bias.flatten()
    box = flat[0:KEYS].view(1, 1, 1, KEYS)  # batch row 0's box: rows 0's 70 values, then row 1's
    q0, k0, v0, do0 = (t[:1] for t in (q, k, v, do))
    kk, vv = _padded_rows(k0, KEYS), _padded_rows(v0, KEYS)
    raw = _emulated_dq_stage(q0, kk, vv, box, lse[:1], do0, delta[:1])
    assert not torch.isfinite(raw.float()).all()
    masked = box.clone()
    masked[..., 70:] = -torch.inf
    got = _emulated_dq_stage(q0, kk, vv, masked, lse[:1], do0, delta[:1])
    assert torch.equal(got, _emulated_dq(q0, k0, v0, bias[:1], lse[:1], do0, delta[:1], 2))


def _emulated_dq_stage(q, k, v, bias, lse, do, delta):
    """_emulated_dq with the key axis as long as the stage (keys past L
    included), 2 heads."""
    b, l, d = q.shape
    scale = float(np.float32(1.0 / (d // 2) ** 0.5))
    qf, kf, vf, dof = (_split(t, 2) for t in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf).float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf).float()
    _, ds = _p_ds(s, bias, _rows(lse), dp, _rows(delta), scale)
    acc = torch.einsum("bhqk,bkhd->bhqd", ds.double(), kf).float()
    return acc.transpose(1, 2).reshape(b, l, d).bfloat16()


def _copier_rows(x, b, j, walk, seq_len, past):
    """A dk/dv stage's lse (or delta) rows of batch row b, head 0, as the
    producer warp copies them: rows j walk + r below seq_len from x (B, L,
    H), ``past`` beyond."""
    rows = torch.full((walk,), past)
    n = max(0, min(walk, seq_len - j * walk))
    rows[:n] = x[b, j * walk : j * walk + n, 0]
    return rows


def test_dkv_masks_query_rows_past_seq_len():
    """dk/dv's stage of 128 query rows at L = 70: a box over the (B L) rows
    of lse would hold batch row 1's lse in rows 70-127, here -1e9 (row 1
    fully padded), so p = exp(bias + 1e9) would be inf there and dv NaN
    (inf times the zero do rows). The producer warp's rule, lse +inf and
    delta 0 past seq_len, gives p = 0 there: the stage equals the one over
    the 70 rows, bit for bit."""
    q, k, v, do, bias, lse, delta = _box_case(full_row=1)
    walk = 128
    scale = float(np.float32(1.0 / 32**0.5))
    qq, dd = (_padded_rows(t[:1], walk) for t in (q, do))
    kf, vf = _split(k[:1], 2)[:, :, :1], _split(v[:1], 2)[:, :, :1]  # head 0
    qf, dof = _split(qq, 2)[:, :, :1], _split(dd, 2)[:, :, :1]

    def dv_of(lse_rows, delta_rows):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf).float()
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf).float()
        p, _ = _p_ds(s, bias[:1], lse_rows.view(1, 1, walk, 1), dp, delta_rows.view(1, 1, walk, 1), scale)
        return torch.einsum("bhqk,bqhd->bhkd", p.bfloat16().double(), dof).float()

    raw = dv_of(lse[..., 0].flatten()[:walk], delta[..., 0].flatten()[:walk])
    assert lse[1, 0, 0] < -1e8 and not torch.isfinite(raw).all()
    got = dv_of(_copier_rows(lse, 0, 0, walk, 70, torch.inf), _copier_rows(delta, 0, 0, walk, 70, 0.0))
    _, want = _emulated_dkv(q[:1], k[:1], v[:1], bias[:1], lse[:1], do[:1], delta[:1], 2, walk)
    assert torch.equal(got.transpose(1, 2).reshape(1, 70, 32).bfloat16(), want.unflatten(-1, (2, 32))[..., 0, :])


def test_fully_padded_row_keeps_p_one():
    """s - lse stays a subtraction after s = fma(q . k, scale, bias): in a
    fully padded row (bias -1e9 at every key, lse -1e9) every p is exactly 1,
    as in the plain version; a fold into one exponent of log2 units would
    give 2^(q . k scale log2 e) instead."""
    q, k, v, do, bias, lse, delta = _box_case(full_row=0)
    assert torch.all(lse[0] == -1e9)
    s = torch.einsum("bqhd,bkhd->bhqk", _split(q[:1], 2), _split(k[:1], 2)).float()
    scale = float(np.float32(1.0 / 32**0.5))
    p, _ = _p_ds(s, bias[:1], _rows(lse[:1]), s, _rows(delta[:1]), scale)
    assert torch.all(p == 1.0)
    folded = torch.exp2((s.double() * scale * np.log2(np.e) + 0.0).float())
    assert not torch.all(folded == 1.0)


# -- the schedule -----------------------------------------------------------------


def _units(b, l, heads, sms=SMS):
    """Both kernels' units as FwdUnit and the block loops compute them:
    [(block, row0, head, batch row)]."""
    tiles = -(-l // ROWS)
    units = tiles * heads * b
    grid = min(units, sms)
    return [(blk, (u % tiles) * ROWS, (u // tiles) % heads, u // tiles // heads)
            for blk in range(grid) for u in range(blk, units, grid)], tiles, grid


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize(
    "b,l,heads,dh",
    [(16, 1024, 4, 64), (8, 1024, 4, 64), (8, 100, 8, 32), (8, 100, 2, 128), (1, 1, 1, 16), (2, 129, 2, 128),
     (3, 1000, 6, 24), (8, 1000, 2, 128)],
)
def test_units_and_stages_cover_every_row_once(kernel, b, l, heads, dh):
    """Every (128-row tile, head, batch row) exactly once, the blocks within
    one unit of each other; in each unit the stages (dq: 128 keys; dk/dv:
    kDkvWalk query rows) cover [0, L) once, and the block's running stage
    count, which sets each stage's ring slot and phase, advances by the
    same number in every unit."""
    walk, tiles, grid = _units(b, l, heads)
    seen = sorted((r, h, bi) for _, r, h, bi in walk)
    assert seen == sorted((t * ROWS, h, bi) for t in range(tiles) for h in range(heads) for bi in range(b))
    counts = np.bincount([blk for blk, *_ in walk], minlength=grid)
    assert counts.max() - counts.min() <= 1
    step = KEYS if kernel == "dq" else _walk(dh)
    stages = [(j * step, min(l, (j + 1) * step)) for j in range(-(-l // step))]
    covered = np.zeros(l, int)
    for lo, hi in stages:
        covered[lo:hi] += 1
    assert (covered == 1).all() and stages[-1][0] < l


def test_the_mirrored_constants_fit_the_card():
    """At every instance: dq's Q + dO buffers, K/V stages and bias boxes, and
    dk/dv's K + V buffers, Q/dO stages and lse/delta rows, with their
    barriers and the 1,024 bytes of alignment, fit one block's shared
    memory; the boxes are 64 rows (a 128-row tile is two) and a dk/dv stage
    is whole boxes; the setmaxnreg split fits the register file; and a
    consumer thread's accumulators (two score tiles and the gradients)
    leave it room."""
    box_rows = _constant("kBwdBoxRows")
    slot, box = _constant("kFwdBiasSlot"), _constant("kFwdBiasBox")
    producer, consumer = _constant("kBwdProducerRegs"), _constant("kBwdConsumerRegs")
    assert ROWS == KEYS == 128 and box_rows == 64 and box * 4 <= slot
    for dhp in INSTANCES:
        row_bytes = 2 * min(dhp, 64)
        tile = lambda rows: rows * dhp * 2  # noqa: E731
        assert box_rows * row_bytes % 1024 == 0
        stages, qbufs = _per_width("kDqStages", dhp), _per_width("kDqQBuffers", dhp)
        dq = qbufs * 2 * tile(ROWS) + stages * (2 * tile(KEYS) + slot) + (2 * qbufs + 2 * stages) * 8 + 1024
        walk, dstages, kvbufs = _per_width("kDkvWalk", dhp), _per_width("kDkvStages", dhp), _per_width(
            "kDkvKvBuffers", dhp)
        dkv = kvbufs * 2 * tile(ROWS) + dstages * (2 * tile(walk) + 2 * walk * 4) + (2 * kvbufs + 2 * dstages) * 8 + 1024
        assert stages >= 2 and dstages >= 2 and dq <= attn.MAX_SHARED_BYTES, (dhp, dq)
        assert dkv <= attn.MAX_SHARED_BYTES, (dhp, dkv)
        assert walk % box_rows == 0 and walk % 32 == 0 and walk in (64, 128)
        # f32 values a consumer thread holds: S and dP (64 x 128 / 128
        # threads each), dQ; S^T and dP^T (64 x walk), dK and dV
        assert 64 + 64 + dhp // 2 <= consumer - 24 and walk + dhp <= consumer - 24, dhp
    assert 128 * producer + 256 * consumer <= 65536 and producer % 8 == 0 and consumer % 8 == 0 and producer >= 24


def test_no_mma_sync_backward_is_left():
    """The bf16 backward is the two TMA + wgmma kernels: no mma.sync
    backward kernel or its constants remain in the source."""
    text = _text()
    assert "bmha_dq_wgmma_kernel" in text and "bmha_dkv_wgmma_kernel" in text
    for gone in ("bmha_dq_mma_kernel", "bmha_dkv_mma_kernel", "kDqWarps", "kDkvPass", "kFragmentsResident",
                 "mma_smem_bytes", "constexpr int kWalk = 64"):
        assert gone not in text, gone


# -- the tensor-map operands ---------------------------------------------------------


def _copies():
    counts = _build.copy_counts()
    return counts["blockwise_fwd"], counts["blockwise_bwd"]


def test_strided_slices_and_contiguous_do_pass_uncopied():
    """q, k, v as column slices of one (B, L, 3D) bf16 projection and a
    contiguous do, as the long-session step hands them over: no copy."""
    qkv = torch.zeros((2, 100, 3 * 256), dtype=torch.bfloat16)
    q, k, v = qkv[..., :256], qkv[..., 256:512], qkv[..., 512:]
    do = torch.zeros((2, 100, 256), dtype=torch.bfloat16)
    bias = torch.zeros((2, 1, 1, 100))
    before = _copies()
    got = attn._tma_operands(q, k, v, bias, 4, do, counter="blockwise_bwd")
    assert all(a is b for a, b in zip(got, (q, k, v, do, bias))) and got[5] == 64
    assert _copies() == before


def test_misaligned_do_is_copied_and_counted_as_the_backwards():
    """A do whose base is one element into a wider tensor is copied
    (contiguous, same values) and counted under blockwise_bwd, not the
    forward's counter."""
    rng = np.random.default_rng(0)
    wide = torch.from_numpy(rng.standard_normal((2, 50, 65), dtype=np.float32)).bfloat16()
    do = wide[..., 1:]
    v = torch.from_numpy(rng.standard_normal((2, 50, 64), dtype=np.float32)).bfloat16()
    before = _copies()
    got = attn._tma_operands(v, v, v, torch.zeros((2, 1, 1, 50)), 2, do, counter="blockwise_bwd")
    assert _copies() == (before[0], before[1] + 1)
    assert got[3].is_contiguous() and got[3].data_ptr() % 16 == 0 and torch.equal(got[3], do)
    assert all(t is v for t in got[:3])


@pytest.mark.parametrize("dh,padded", [(20, 24), (6, 8), (12, 16)])
def test_head_width_off_16_bytes_pads_all_four(dh, padded):
    """A head row off 16 bytes: q, k, v and do all become (B, L, H, dh')
    copies, zero past dh, and the head stride is dh'."""
    heads = 3
    rng = np.random.default_rng(dh)
    d = dh * heads
    qkv = torch.from_numpy(rng.standard_normal((2, 9, 3 * d), dtype=np.float32)).bfloat16()
    do = torch.from_numpy(rng.standard_normal((2, 9, d), dtype=np.float32)).bfloat16()
    q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
    before = _copies()
    *got, _, head_stride = attn._tma_operands(q, k, v, torch.zeros((2, 1, 1, 9)), heads, do, counter="blockwise_bwd")
    assert head_stride == padded and _copies() == (before[0], before[1] + 4)
    for src, t in zip((q, k, v, do), got):
        split = t.unflatten(-1, (heads, padded))
        assert torch.equal(split[..., :dh], src.unflatten(-1, (heads, dh))) and not split[..., dh:].any()


def test_lse_and_delta_rows_are_no_tma_box():
    """Why a producer warp copies lse and delta: a TMA box's inner extent is
    a multiple of 16 bytes, and one head's lse column of a (B, L, H) f32
    tensor is one 4-byte float a row (H floats apart); a box over all heads
    works only where 4 H is a multiple of 16, which H = 2 (dh = 128 at
    D = 256) does not meet. The copier's rows equal lse's column below
    seq_len."""
    assert 4 % attn.TMA_ALIGN != 0
    assert [h for h in (1, 2, 3, 4, 6, 8) if (4 * h) % attn.TMA_ALIGN == 0] == [4, 8]
    lse = torch.arange(2 * 70 * 3, dtype=torch.float32).view(2, 70, 3)
    rows = _copier_rows(lse, 1, 0, 128, 70, torch.inf)
    assert torch.equal(rows[:70], lse[1, :, 0]) and torch.isinf(rows[70:]).all()
