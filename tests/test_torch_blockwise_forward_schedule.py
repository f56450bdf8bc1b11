"""The card's bf16 blockwise attention forward, its arithmetic, its schedule
and its operand rule, emulated on the CPU.

``bmha_fwd_wgmma_kernel`` (``bert4clickpath_torch/csrc/attention_blockwise.cu``)
runs only on the card. Three things it decides are held here instead:

* **Numerics.** A plain-PyTorch emulation of its steps: the online softmax
  over steps of 128 keys (one stage), s = fma(q . k, scale, bias) in f32,
  the un-normalised p = exp(s - m_running) rounded to bf16 before p . v
  (f32 sums), l summed from the unrounded p, one division by l at the end,
  lse = m + log l. It is held against the JAX ``_bmha_fwd`` kernel (in
  interpret mode, forced onto small key tiles as
  ``tests/test_torch_long_context.py`` forces it, so that its own online
  softmax walks several tiles) and against the port's plain
  ``blockwise_mha_reference`` (one step over all keys), at the bound
  ``chip_smoke.py`` holds the kernel to (BLOCKWISE_TOL bf16: abs 2e-3 + two
  bf16 ulps of the reference; lse relative 1e-5), at head widths 16, 24,
  32, 64 and 128 (24 lies in the 32-wide instance, its pad columns zero),
  L = 70 (one ragged stage) and 129 (a second stage of one key) against
  both, and L = 1000 against the plain version alone. Each batch holds a
  fully padded row and, where L > 128, a row whose first stage is all
  padding.
* **Schedule.** The persistent grid's walk over units of (128-row query
  tile, head, batch row), mirrored from ``FwdUnit``: one block an SM,
  block b taking units b, b + grid, ...: every unit exactly once, the
  blocks within one unit of each other, and the units of one round reading
  few (head, batch row) pairs' K and V.
* **Tensor-map rule.** ``_tma_operands``: strided slices of one (B, L, 3D)
  projection pass as they are; a base, row or batch stride that is not a
  multiple of 16 bytes gets a contiguous copy, a head width that is not
  gets zero-padded copies of all three, a bias whose base is not gets a
  copy; each copy is counted.
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
ATOL, RTOL = 2e-3, 2.0**-6  # chip_smoke.py BLOCKWISE_TOL, bf16
LSE_RTOL = 1e-5


def _constant(name: str) -> int:
    """A constexpr int of the kernel's source: a literal, or a sum of
    literals and other such constants."""
    found = re.search(rf"constexpr int {name} = ([\w +]+);", SOURCE.read_text())
    assert found, name
    return sum(int(term) if term.isdigit() else _constant(term) for term in found.group(1).split(" + "))


ROWS = _constant("kFwdRows")  # query rows of a unit: two consumer warpgroups of 64
KEYS = _constant("kFwdKeys")  # keys of a stage: one step of the online softmax


def _case(b, l, dh, heads, seed):
    """bf16 q, k, v (B, L, dh * heads) and a (B, 1, 1, L) f32 bias: row 0
    fully padded, row 1 with its first stage all padding then one real key
    (L > 128; ragged otherwise), the others ragged."""
    rng = np.random.default_rng(seed)
    d = dh * heads
    q, k, v = (torch.from_numpy(rng.standard_normal((b, l, d), dtype=np.float32)).bfloat16() for _ in range(3))
    bias = np.zeros((b, 1, 1, l), np.float32)
    for i, n in enumerate(rng.integers(1, l + 1, size=b)):
        bias[i, ..., n:] = -1e9
    bias[0] = -1e9
    if b > 1 and l > KEYS:
        bias[1] = -1e9
        bias[1, ..., l - 1] = 0.0
    return q, k, v, torch.from_numpy(bias)


def _emulated_forward(q, k, v, bias, heads):
    """(out bf16, lse f32) as the kernel computes them: steps of KEYS keys,
    the scores' f32 sums of exact bf16 products scaled and biased with one
    rounding (fmaf), p rounded to bf16 against the running maximum for p . v,
    l from the unrounded p."""
    b, l, d = q.shape
    dh = d // heads
    scale = float(np.float32(1.0 / dh**0.5))  # the kernel's f32 argument
    qf, kf, vf = (t.unflatten(-1, (heads, dh)).double() for t in (q, k, v))
    m = torch.full((b, heads, l), -torch.inf)
    lsum = torch.zeros((b, heads, l))
    acc = torch.zeros((b, heads, l, dh))
    for k0 in range(0, l, KEYS):
        ks = slice(k0, k0 + KEYS)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, ks]).float()
        s = (s.double() * scale + bias[..., ks].double()).float()
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)  # 0 on the first step
        p = torch.exp(s - m_new[..., None])
        lsum = lsum * alpha + p.sum(-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.bfloat16().double(), vf[:, ks]).float()
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = (acc / lsum[..., None]).transpose(1, 2).reshape(b, l, d).bfloat16()
    return out, (m + torch.log(lsum)).transpose(1, 2).contiguous()


def _held(got, got_lse, want, want_lse, what):
    got, want = got.float(), want.float()
    used = ((got - want).abs() / (ATOL + RTOL * want.abs())).max().item()
    assert used <= 1.0, f"{what}: out at {used:.3f} of the bound"
    lse_err = ((got_lse - want_lse).abs() / want_lse.abs().clamp(min=1.0)).max().item()
    assert lse_err <= LSE_RTOL, f"{what}: lse relative error {lse_err:.3e}"


def _divisor_tile(l):
    """The JAX kernel's tiles must divide L: the largest divisor of L up to
    48 (several tiles: L = 70 walks 5 of 14, L = 129 walks 3 of 43)."""
    return max(t for t in range(1, 49) if l % t == 0)


@pytest.mark.parametrize("l", [70, 129])
@pytest.mark.parametrize("dh,heads", [(16, 2), (24, 2), (32, 2), (64, 2), (128, 2)])
def test_emulated_forward_holds_against_jax_and_plain(monkeypatch, dh, heads, l):
    """The emulation against the JAX kernel (interpret mode, small tiles)
    and the port's plain version, at the kernel's bound."""
    tile = _divisor_tile(l)
    monkeypatch.setattr(jattn, "_bmha_blocks", lambda l_, d_, itemsize=2: (tile, tile))
    monkeypatch.setattr(jattn, "fused_mha_supported", lambda *a, **k: False)
    q, k, v, bias = _case(3, l, dh, heads, seed=dh + l)
    got, got_lse = _emulated_forward(q, k, v, bias, heads)
    assert torch.isfinite(got.float()).all() and torch.isfinite(got_lse).all()
    want, want_lse = attn.blockwise_mha_reference(q, k, v, bias, heads)
    _held(got, got_lse, want, want_lse, "against the plain version")
    as_jax = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    jout, jlse = jattn._bmha_fwd(as_jax(q), as_jax(k), as_jax(v), jnp.asarray(bias.numpy()), heads)
    jout = torch.from_numpy(np.array(jout.astype(jnp.float32)))
    jlse = torch.from_numpy(np.array(jlse))[..., :heads]
    _held(got, got_lse, jout, jlse, "against the JAX kernel")


@pytest.mark.parametrize("dh,heads", [(16, 2), (24, 2), (32, 2), (64, 2), (128, 2)])
def test_emulated_forward_holds_at_l_1000(dh, heads):
    """Eight stages, the last ragged (1000 = 7 x 128 + 104), against the
    plain version at B = 1; the batch row's first stage is padding and its
    last key real, so the first stage is rescaled away."""
    q, k, v, bias = _case(1, 1000, dh, heads, seed=dh)
    bias[0] = 0.0
    bias[0, ..., :KEYS] = -1e9
    got, got_lse = _emulated_forward(q, k, v, bias, heads)
    want, want_lse = attn.blockwise_mha_reference(q, k, v, bias, heads)
    _held(got, got_lse, want, want_lse, "against the plain version")


def test_step_size_moves_the_roundings():
    """What the bound absorbs: p is rounded against the running maximum, so
    the emulation over 128-key steps and the plain version (one step) round
    some p differently and give different bits, within the bound."""
    q, k, v, bias = _case(2, 300, 64, 2, seed=1)
    bias.zero_()
    got, got_lse = _emulated_forward(q, k, v, bias, 2)
    want, want_lse = attn.blockwise_mha_reference(q, k, v, bias, 2)
    assert not torch.equal(got, want)
    _held(got, got_lse, want, want_lse, "against the plain version")


# -- the schedule ---------------------------------------------------------------


def _walk(b, l, heads, sms=SMS):
    """The kernel's units as FwdUnit and the block loop compute them:
    [(block, round, q0, head, batch row)]."""
    q_tiles = -(-l // ROWS)
    units = q_tiles * heads * b
    grid = min(units, sms)
    out = []
    for blk in range(grid):
        for r, u in enumerate(range(blk, units, grid)):
            out.append((blk, r, (u % q_tiles) * ROWS, (u // q_tiles) % heads, u // q_tiles // heads))
    return out, q_tiles, grid


@pytest.mark.parametrize(
    "b,l,heads",
    [(16, 1024, 4), (8, 1024, 4), (8, 100, 8), (8, 100, 2), (1, 1, 1), (2, 129, 2), (256, 53, 4), (3, 1000, 6)],
)
def test_units_cover_every_query_tile_once(b, l, heads):
    """Every (query tile, head, batch row) exactly once; no block holds two
    units more than another; the units of one round read K and V of at most
    grid / q_tiles + 2 (head, batch row) pairs (they share them through
    L2)."""
    walk, q_tiles, grid = _walk(b, l, heads)
    assert q_tiles * ROWS >= l > (q_tiles - 1) * ROWS
    seen = sorted((q0, h, bi) for _, _, q0, h, bi in walk)
    assert seen == sorted((t * ROWS, h, bi) for t in range(q_tiles) for h in range(heads) for bi in range(b))
    counts = np.bincount([blk for blk, *_ in walk], minlength=grid)
    assert counts.max() - counts.min() <= 1
    rounds = {}
    for _, r, _, h, bi in walk:
        rounds.setdefault(r, set()).add((h, bi))
    assert max(len(pairs) for pairs in rounds.values()) <= grid // q_tiles + 2


def test_the_mirrored_constants_fit_the_card():
    """The stage and the instruction agree (128 keys is the N of m64n128),
    two warpgroups of 64 rows make the unit, the ring fits one block's
    shared memory at every instance (Q buffers, stages of K, V and the bias
    box) and the setmaxnreg split fits the register file."""
    assert ROWS == 128 and KEYS == 128
    stages = re.search(r"constexpr int kFwdStages = DHP == 128 \? (\d+) : (\d+);", SOURCE.read_text())
    qbufs = _constant("kFwdQBuffers")
    for dhp in (16, 32, 64, 128):
        n = int(stages.group(1) if dhp == 128 else stages.group(2))
        tile = 128 * dhp * 2
        smem = qbufs * tile + n * (2 * tile + _constant("kFwdBiasSlot")) + (2 * qbufs + 2 * n) * 8 + 1024
        assert n >= 2 and smem <= attn.MAX_SHARED_BYTES, (dhp, smem)
    producer, consumer = _constant("kFwdProducerRegs"), _constant("kFwdConsumerRegs")
    assert 128 * producer + 256 * consumer <= 65536 and producer % 8 == 0 and consumer % 8 == 0 and producer >= 24


@pytest.mark.parametrize("b,l", [(16, 1024), (8, 100), (3, 129), (2, 70), (5, 13), (1, 1)])
def test_bias_box_covers_each_stage(b, l):
    """Each stage's bias comes as one box of the (B L) bias row that starts
    on a 16-byte boundary (a TMA box start must): at b L + k0 rounded down
    to a multiple of 4, kFwdBiasBox values long; the consumers read it from
    the shift (b L) mod 4, and every key of the stage lies in the box."""
    box = _constant("kFwdBiasBox")
    for bi in range(b):
        for k0 in range(0, l, KEYS):
            first = bi * l + k0
            start = first & ~3
            assert start * 4 % 16 == 0 and first - start == ((bi * l) & 3)
            assert first + min(KEYS, l - k0) <= start + box
    assert box * 4 % 16 == 0 and box * 4 <= _constant("kFwdBiasSlot") and _constant("kFwdBiasSlot") % 128 == 0


# -- the tensor-map rule --------------------------------------------------------


def _copies():
    return _build.copy_counts()["blockwise_fwd"]


@pytest.mark.parametrize(
    "ptr,strides,ok",
    [(0, (128, 1536, 1572864), True), (2, (128, 1536, 1572864), False), (0, (48, 96, 960), True),
     (0, (40, 80, 800), False), (0, (128, 1538, 1574912), False), (0, (128, 1536, 0), False),
     (256, (16, 16, 16), True)],
)
def test_tma_describable(ptr, strides, ok):
    """Base and each stride a positive multiple of 16 bytes."""
    assert attn.tma_describable(ptr, strides) is ok


def test_strided_projection_slices_pass_uncopied():
    """q, k, v as column slices of one (B, L, 3D) bf16 projection, as the
    long-session model makes them: no copy, the tensors themselves."""
    qkv = torch.zeros((2, 100, 3 * 256), dtype=torch.bfloat16)
    q, k, v = qkv[..., :256], qkv[..., 256:512], qkv[..., 512:]
    bias = torch.zeros((2, 1, 1, 100))
    before = _copies()
    got = attn._tma_operands(q, k, v, bias, 4)
    assert got[0] is q and got[1] is k and got[2] is v and got[3] is bias and got[4] == 64
    assert _copies() == before


def test_misaligned_inputs_are_copied_and_counted():
    """A base one element into a wider tensor, and a row stride of 3D + 1
    elements: each such input is copied (contiguous, same values), the
    aligned one is not, and each copy counts once."""
    rng = np.random.default_rng(0)
    wide = torch.from_numpy(rng.standard_normal((2, 50, 3 * 64 + 8), dtype=np.float32)).bfloat16()
    q, k = wide[..., 1:65], wide[..., 65:129]  # q's base 2 bytes off; k 130 bytes off
    v = torch.from_numpy(rng.standard_normal((2, 50, 64), dtype=np.float32)).bfloat16()
    bias = torch.zeros((2, 1, 1, 50))
    before = _copies()
    got = attn._tma_operands(q, k, v, bias, 2)
    assert _copies() == before + 2
    assert got[2] is v and got[3] is bias and got[4] == 32
    for src, t in zip((q, k), got[:2]):
        assert t.is_contiguous() and t.data_ptr() % 16 == 0 and torch.equal(t, src)
    odd = torch.zeros((2, 50, 3 * 64 + 1), dtype=torch.bfloat16)[..., :64]  # row stride 193 elements
    before = _copies()
    got = attn._tma_operands(odd, odd, odd, bias, 2)
    assert _copies() == before + 3 and all(t.stride(1) == 64 for t in got[:3])
    # a bias whose base is off 16 bytes: one copy more, the same values
    wide_bias = torch.zeros(2 * 50 + 1)
    wide_bias[1:] = torch.arange(100.0)
    off = wide_bias[1:].view(2, 1, 1, 50)
    before = _copies()
    got = attn._tma_operands(v, v, v, off, 2)
    assert _copies() == before + 1 and got[3].data_ptr() % 16 == 0 and torch.equal(got[3], off)


@pytest.mark.parametrize("dh,padded", [(20, 24), (6, 8), (25, 32), (12, 16)])
def test_head_width_off_16_bytes_pads_all_three(dh, padded):
    """A head row that is not a multiple of 16 bytes: all three inputs
    become (B, L, H, dh') copies with dh' rounded up to 16 bytes, zero past
    dh, and the head stride is dh'."""
    heads = 3
    rng = np.random.default_rng(dh)
    qkv = torch.from_numpy(rng.standard_normal((2, 9, 3 * dh * heads), dtype=np.float32)).bfloat16()
    d = dh * heads
    q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
    before = _copies()
    *got, _, head_stride = attn._tma_operands(q, k, v, torch.zeros((2, 1, 1, 9)), heads)
    assert head_stride == padded and _copies() == before + 3
    for src, t in zip((q, k, v), got):
        assert t.shape == (2, 9, heads * padded) and t.stride(1) == heads * padded
        split = t.unflatten(-1, (heads, padded))
        assert torch.equal(split[..., :dh], src.unflatten(-1, (heads, dh)))
        assert not split[..., dh:].any()
        assert attn.tma_describable(t.data_ptr(), (padded * 2, t.stride(1) * 2, t.stride(0) * 2))
