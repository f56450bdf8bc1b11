"""The port's long-session path against the JAX package's, on the CPU.

Blockwise attention: the JAX side runs its Pallas kernels in interpret mode
with ``_bmha_blocks`` forced to (16, 16), so that L=48 walks 3 x 3 tiles
(the online softmax and the accumulating backward grids really run); the
port runs its plain versions, which compute the same function densely.
Fused dropout: both packages satisfy the same properties (the bits differ:
neither the TPU core's generator nor ``jax.random`` can be reproduced), and
the port's Philox is held to the published known-answer vectors. The path
as a whole: the long-context configuration at 2 layers, d_model 32, 2 heads,
L=48, 50 items, f32, both sides forced onto the blockwise family. Inputs and
weights are made with numpy from a seed. Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bert4clickpath_tpu.ops.pallas.attention as jattn
from bert4clickpath_tpu.config import ModelConfig as JModelConfig
from bert4clickpath_tpu.config import TrainConfig as JTrainConfig
from bert4clickpath_tpu.models.model import ClickstreamModel as JModel
from bert4clickpath_tpu.training import schedules as jsched
from bert4clickpath_tpu.training import train_state as jts
from bert4clickpath_torch.config import TrainConfig
from bert4clickpath_torch.convert import flax_from_state_dict, state_dict_from_flax
from bert4clickpath_torch.data.synthetic import long_context_config, seeded_state_dict, synthetic_batch
from bert4clickpath_torch.models.model import ClickstreamModel
from bert4clickpath_torch.ops.kernels import _build
from bert4clickpath_torch.ops.kernels import attention as attn
from bert4clickpath_torch.ops.kernels.dropout import (
    dropout_bits,
    fused_dropout,
    fused_dropout_reference,
    philox4x32_10,
)
from bert4clickpath_torch.training import schedules
from bert4clickpath_torch.training import train_state as tts

torch.set_num_threads(1)


@pytest.fixture
def multiblock(monkeypatch):
    """The JAX blockwise kernels on 16 x 16 tiles, and its model's
    ``attn_impl="pallas"`` sent to them whatever the length."""
    monkeypatch.setattr(jattn, "_bmha_blocks", lambda l, d, itemsize=2: (16, 16))
    monkeypatch.setattr(jattn, "fused_mha_supported", lambda *a, **k: False)


@pytest.fixture
def forced_blockwise(monkeypatch):
    """The port's dispatch sent to the blockwise family whatever the length."""
    monkeypatch.setattr(attn, "attention_family", lambda *a: "blockwise")


def _qkv_bias(b, l, d, pad):
    """q, k, v (B, L, D) f32 and a (B, 1, 1, L) padding bias: ragged tails,
    and (``pad="full_row"``) the last batch row padded entirely."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(b, l, d)).astype(np.float32) for _ in range(3))
    bias = np.zeros((b, 1, 1, l), np.float32)
    if pad:
        for i in range(b):
            bias[i, ..., l - 5 - 7 * i :] = -1e9
    if pad == "full_row":
        bias[-1] = -1e9
    return q, k, v, bias


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


# -- blockwise attention ------------------------------------------------------


@pytest.mark.parametrize(
    "shape,heads,pad",
    [((2, 48, 32), 2, "full_row"), ((2, 48, 32), 2, "ragged"), ((1, 16, 48), 4, None)],
    ids=["multiblock_full_pad_row", "multiblock_ragged", "single_block_4_heads"],
)
def test_blockwise_forward_matches_jax(multiblock, shape, heads, pad):
    """blockwise_mha (plain version on the CPU) vs the JAX kernel in
    interpret mode, f32: atol/rtol 2e-5, the JAX test's own tolerance (f32
    sums in another order). lse against the kernel's residual likewise."""
    q, k, v, bias = _qkv_bias(*shape, pad)
    want, want_lse = jattn._bmha_fwd(*(jnp.asarray(a) for a in (q, k, v, bias)), heads)
    tq, tk, tv, tb = _torch((q, k, v, bias))
    got, lse = attn.blockwise_mha_forward(tq, tk, tv, tb, heads)
    assert got.dtype == torch.float32 and got.shape == shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., :heads], rtol=2e-5, atol=2e-5)
    # the differentiable wrapper and the dispatch return the same output
    assert torch.equal(attn.blockwise_mha(tq, tk, tv, tb, heads), got)


@pytest.mark.parametrize("l", [37, 64, 65, 130])
def test_blockwise_reference_at_any_length(l):
    """The plain blockwise version against the whole-row one (the port's
    dense oracle) at lengths no 16- or 64-row tile divides, f32: atol 1e-5
    (p is normalised after the PV product, not before)."""
    q, k, v, bias = _torch(_qkv_bias(2, l, 24, "ragged"))
    got, lse = attn.blockwise_mha_reference(q, k, v, bias, 2)
    torch.testing.assert_close(got, attn.mha_reference(q, k, v, bias, 2), atol=1e-5, rtol=0)
    assert lse.shape == (2, l, 2)


@pytest.mark.parametrize("dtype,tol", [("float32", 5e-4), ("bfloat16", 2e-2)], ids=["f32", "bf16"])
def test_blockwise_gradients_match_jax(multiblock, dtype, tol):
    """dq, dk, dv under the JAX test's loss sum(o * cos(o)), against the JAX
    dq and dk/dv kernels on 3 x 3 tiles. f32: atol/rtol 5e-4 as there (one
    batch row fully padded). bf16: 2e-2 absolute: the TPU kernels round each
    tile pair's partial gradient to bf16 as they add it, the port sums in
    f32 and rounds once, and p and ds round at other places in the walk."""
    q, k, v, bias = _qkv_bias(2, 48, 32, "full_row" if dtype == "float32" else "ragged")
    jdt = getattr(jnp, dtype)

    def jloss(q, k, v):
        o = jattn.blockwise_mha(q, k, v, jnp.asarray(bias), 2)
        return jnp.sum(o * jnp.cos(o.astype(jnp.float32)))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a, jdt) for a in (q, k, v)))
    tq, tk, tv = (t.requires_grad_() for t in _torch((q, k, v), getattr(torch, dtype)))
    o = attn.blockwise_mha(tq, tk, tv, torch.from_numpy(bias), 2)
    got = torch.autograd.grad((o * torch.cos(o.float())).sum(), (tq, tk, tv))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(w, np.float32), rtol=tol if dtype == "float32" else 0,
            atol=tol, err_msg=name,
        )


def test_blockwise_backward_reference_matches_whole_row():
    """With lse from the forward, the blockwise plain backward equals the
    whole-row plain backward on rows that hold a real key (f32, 1e-5)."""
    q, k, v, bias = _torch(_qkv_bias(2, 37, 24, "ragged"))
    do = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 37, 24)).astype(np.float32))
    out, lse = attn.blockwise_mha_forward(q, k, v, bias, 2)
    got = attn.blockwise_mha_backward(q, k, v, bias, out, lse, do, 2)
    want = attn.mha_backward_reference(q, k, v, bias, do, 2)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def _tiled_forward(q, k, v, bias, heads, tile=64):
    """The bf16 tensor-core forward's walk written out: key tiles of ``tile``
    with a running maximum m and sum l per query row; in each tile the
    un-normalised p = exp(s - m_new) is summed unrounded into l and rounded to
    bf16 for p . v, the accumulated output and l are rescaled by
    alpha = exp(m_prev - m_new), and the output is divided by l once."""
    b, l, d = q.shape
    qf, kf, vf = (attn._split_heads(t, heads) for t in (q, k, v))
    scale = 1.0 / (d // heads) ** 0.5
    m = torch.full((b, heads, l, 1), -float("inf"))
    lsum = torch.zeros(b, heads, l, 1)
    acc = torch.zeros(b, heads, l, d // heads)
    for k0 in range(0, l, tile):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, k0 : k0 + tile]) * scale + bias[..., k0 : k0 + tile]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
        lsum = lsum * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vf[:, k0 : k0 + tile])
        m = m_new
    out = (acc / lsum).transpose(1, 2).reshape(b, l, d).to(q.dtype)
    return out, (m + torch.log(lsum)).squeeze(-1).transpose(1, 2)


@pytest.mark.parametrize("l", [37, 65, 130, 200])
def test_blockwise_forward_sums_l_unrounded_and_multiplies_the_rounded_p(l):
    """What the bf16 forward kernel relies on: l sums the unrounded f32 p
    while p . v takes p rounded to bf16 (bit for bit against the formula
    written out, and not against either other choice), and a walk over
    64-key tiles with a running maximum stays inside the kernel's tolerance
    of the plain version (abs 2e-3 + two bf16 ulps; lse relative 1e-5), a
    first tile that is all padding included."""
    q, k, v, bias = _torch(_qkv_bias(2, l, 32, "ragged"))
    if l > 70:
        bias[1, ..., :70] = -1e9  # a first key tile that is all padding ...
        bias[1, ..., l - 1] = 0.0  # ... then a real key
    q, k, v = (t.bfloat16() for t in (q, k, v))
    out, lse = attn.blockwise_mha_reference(q, k, v, bias, 2)
    qf, kf, vf = (attn._split_heads(t, 2) for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (1.0 / 16**0.5) + bias
    p = torch.exp(s - s.amax(-1, keepdim=True))
    assert not torch.equal(p, p.bfloat16().float())

    def formula(p_product, p_sum):
        o = torch.einsum("bhqk,bkhd->bqhd", p_product, vf) / p_sum.sum(-1).transpose(1, 2).unsqueeze(-1)
        return o.reshape(q.shape).bfloat16()

    rounded = p.bfloat16().float()
    assert torch.equal(out, formula(rounded, p))
    assert not torch.equal(out, formula(rounded, rounded)) and not torch.equal(out, formula(p, p))
    tiled, tiled_lse = _tiled_forward(q, k, v, bias, 2)
    diff = (tiled.float() - out.float()).abs()
    assert bool((diff <= 2e-3 + 2.0**-6 * out.float().abs()).all()), float(diff.max())
    torch.testing.assert_close(tiled_lse, lse, atol=1e-4, rtol=1e-5)


def _backward_case(dtype, l=48, seed=4):
    """(q, k, v, bias, out, lse, do, delta) for the backward's plain
    versions: out and lse from the port's plain forward, 2 heads of 16."""
    q, k, v, bias = _torch(_qkv_bias(2, l, 32, "ragged"))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    do = torch.from_numpy(np.random.default_rng(seed).normal(size=(2, l, 32)).astype(np.float32)).to(dtype)
    out, lse = attn.blockwise_mha_forward(q, k, v, bias, 2)
    return q, k, v, bias, out, lse, do, attn.attention_delta(do, out, 2)


def test_blockwise_dkv_reference_rounds_p_where_the_kernel_does():
    """In bf16 dv = round_bf16(p)^T . do with f32 sums, rounded once: what
    the tensor-core kernel computes (its p operand is bf16). dk and dq take
    ds from the unrounded f32 p, as before. Bit for bit against the formula
    written out, and not the formula with the unrounded p."""
    q, k, v, bias, _, lse, do, delta = _backward_case(torch.bfloat16)
    dk, dv = attn.blockwise_dkv_reference(q, k, v, bias, lse, do, delta, 2)
    p, ds, qf, kf, dof = attn._recompute_p_ds(q, k, v, bias, lse, do, delta, 2)
    assert p.dtype == torch.float32 and not torch.equal(p, p.bfloat16().float())
    rounded = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), dof).reshape(q.shape).bfloat16()
    unrounded = torch.einsum("bhqk,bqhd->bkhd", p, dof).reshape(q.shape).bfloat16()
    assert torch.equal(dv, rounded) and not torch.equal(dv, unrounded)
    assert torch.equal(dk, torch.einsum("bhqk,bqhd->bkhd", ds, qf).reshape(q.shape).bfloat16())
    scale = 1.0 / 16**0.5
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, attn._split_heads(v, 2))
    want_ds = (p * (dp - delta.transpose(1, 2).unsqueeze(-1)) * scale).bfloat16().float()
    assert torch.equal(ds, want_ds)  # ds from the f32 p, rounded once
    dq = attn.blockwise_dq_reference(q, k, v, bias, lse, do, delta, 2)
    assert torch.equal(dq, torch.einsum("bhqk,bkhd->bqhd", ds, kf).reshape(q.shape).bfloat16())


def test_blockwise_f32_backward_is_unchanged_by_the_p_rounding():
    """Rounding p to the input dtype is the identity in f32: dq, dk and dv
    are bit-identical to the formulas with the unrounded p, as before the
    rounding was introduced (seeded input, L=37: no tile divides it)."""
    q, k, v, bias, _, lse, do, delta = _backward_case(torch.float32, l=37)
    dq, dk, dv = attn.blockwise_mha_backward_reference(q, k, v, bias, lse, do, delta, 2)
    p, ds, qf, kf, dof = attn._recompute_p_ds(q, k, v, bias, lse, do, delta, 2)
    assert torch.equal(dv, torch.einsum("bhqk,bqhd->bkhd", p, dof).reshape(q.shape))
    assert torch.equal(dk, torch.einsum("bhqk,bqhd->bkhd", ds, qf).reshape(q.shape))
    assert torch.equal(dq, torch.einsum("bhqk,bkhd->bqhd", ds, kf).reshape(q.shape))
    # and the values this input gave before the change (bit-identical where
    # they were pinned; 1e-5 relative leaves room for another BLAS's sum order)
    got = [float(dq.double().sum()), float(dv.double().sum()), float(dv[1, 5, 7]), float(dk[0, 30, 20])]
    np.testing.assert_allclose(got, F32_BACKWARD_PINNED, rtol=1e-5, atol=0)


# sum(dq), sum(dv), dv[1, 5, 7], dk[0, 30, 20] of _backward_case(float32, l=37)
F32_BACKWARD_PINNED = [6.442384021444013, 2.2224247853537236, -0.8357424736022949, -0.027618777006864548]


def test_bf16_dv_from_the_rounded_p_is_within_the_chosen_bound():
    """The dv decision: p rounded once to bf16 is kept as long as its dv
    error (rms against a dense f64 dv) stays below 1.5x the error that
    rounding the exact dv to the bf16 output causes anyway; two independent
    roundings of like size give sqrt(2). Element by element, the rounded p
    moves the f32 sum by at most 2^-9 sum_q p |do| (half a bf16 ulp of each
    p), plus 2e-6 of that sum for the f32 products' own rounding."""
    q, k, v, bias, _, lse, do, delta = _backward_case(torch.bfloat16)
    p, _, _, _, dof = attn._recompute_p_ds(q, k, v, bias, lse, do, delta, 2)
    exact = torch.einsum("bhqk,bqhd->bkhd", p.double(), dof.double())
    sum_a = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), dof)
    sum_f32 = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    envelope = torch.einsum("bhqk,bqhd->bkhd", p, dof.abs())
    assert bool(((sum_a - sum_f32).abs() <= (2.0**-9 + 2e-6) * envelope).all())
    rms = lambda t: float((t.bfloat16().double() - exact).square().mean().sqrt())  # noqa: E731
    output_only, a = rms(exact), rms(sum_a)
    assert output_only < a < 1.5 * output_only, (a, output_only)
    _, dv = attn.blockwise_dkv_reference(q, k, v, bias, lse, do, delta, 2)
    assert torch.equal(dv, sum_a.reshape(q.shape).bfloat16())


@pytest.mark.parametrize("dtype,tol", [("float32", 5e-4), ("bfloat16", 2e-2)], ids=["f32", "bf16"])
def test_blockwise_backward_matches_jax_kernels_on_the_same_residuals(multiblock, dtype, tol):
    """The plain dq and dk/dv versions against the JAX dq and dk/dv kernels
    (interpret mode, 3 x 3 tiles of 16) given the same out, lse and do. f32:
    atol/rtol 5e-4, the JAX test's own. bf16: abs 2e-2, kept as it was: the
    JAX kernel takes dv from the f32 p where the port rounds p to bf16 first
    (2^-9 relative per term, far inside), and it rounds every tile pair's
    partial gradient to bf16 as it adds it, which is what the 2e-2 covers."""
    q, k, v, bias = _qkv_bias(2, 48, 32, "ragged")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    do = np.random.default_rng(4).normal(size=(2, 48, 32)).astype(np.float32)
    jout, jlse = jattn._bmha_fwd(jq, jk, jv, jnp.asarray(bias), 2)
    want = jattn._bmha_bwd(2, (jq, jk, jv, jnp.asarray(bias), jout, jlse), (jnp.asarray(do, jdt), None))[:3]
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    out = torch.from_numpy(np.array(jout, np.float32)).to(tdt)
    lse = torch.from_numpy(np.asarray(jlse)[..., :2].copy())
    got = attn.blockwise_mha_backward(tq, tk, tv, torch.from_numpy(bias), out, lse, tdo, 2)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(w, np.float32), rtol=tol if dtype == "float32" else 0,
            atol=tol, err_msg=name,
        )


@pytest.mark.parametrize(
    "l,needs_grad,family",
    [
        (53, False, "whole_row"), (53, True, "whole_row"),
        (141, False, "whole_row"), (141, True, "blockwise"),
        (418, False, "blockwise"), (418, True, "blockwise"),
        (1024, False, "blockwise"), (1024, True, "blockwise"),
    ],
)
def test_attention_family_rule(l, needs_grad, family):
    """The dispatch at Dh = 64 follows the whole-row kernels' shared memory:
    the forward fits one block up to L=417, the backward up to L=116."""
    assert attn.attention_family(l, 64, needs_grad) == family
    assert (attn.mha_smem_bytes(l, 64) <= attn.MAX_SHARED_BYTES) == (l <= 417)
    assert (attn.mha_bwd_smem_bytes(l, 64) <= attn.MAX_SHARED_BYTES) == (l <= 116)


def test_mha_dispatch_refuses_no_length(monkeypatch):
    """``mha`` calls the family ``attention_family`` names (needs-grad from
    the inputs and the grad mode), takes any L, and a forced family holds."""
    calls = []
    real = attn.attention_family

    def spy(l, dh, needs_grad):
        calls.append((l, dh, needs_grad, real(l, dh, needs_grad)))
        return calls[-1][-1]

    monkeypatch.setattr(attn, "attention_family", spy)
    for l in (53, 141, 418, 1500):
        x = torch.zeros(1, l, 64, requires_grad=True)
        bias = torch.zeros(1, 1, 1, l)
        out = attn.mha(x, x, x, bias, 1)
        assert out.shape == (1, l, 64) and out.requires_grad
        with torch.no_grad():
            attn.mha(x, x, x, bias, 1)
    assert calls == [
        (53, 64, True, "whole_row"), (53, 64, False, "whole_row"),
        (141, 64, True, "blockwise"), (141, 64, False, "whole_row"),
        (418, 64, True, "blockwise"), (418, 64, False, "blockwise"),
        (1500, 64, True, "blockwise"), (1500, 64, False, "blockwise"),
    ]
    # both families agree where both run (f32, 1e-5), and a forced family is taken
    q, k, v, bias = _torch(_qkv_bias(2, 20, 32, "ragged"))
    want = attn.fused_mha(q, k, v, bias, 2)
    monkeypatch.setattr(attn, "attention_family", lambda *a: "blockwise")
    monkeypatch.setattr(attn, "mha_reference", None)  # the whole-row family is not touched
    torch.testing.assert_close(attn.mha(q, k, v, bias, 2), want, atol=1e-5, rtol=0)


def test_blockwise_wrapper_checks_inputs():
    x = torch.zeros(2, 8, 32)
    bias = torch.zeros(2, 1, 1, 8)
    with pytest.raises(ValueError, match="bias"):
        attn.blockwise_mha(x, x, x, torch.zeros(2, 8), 2)
    with pytest.raises(ValueError, match="divisible"):
        attn.blockwise_mha(x, x, x, bias, 5)
    out, lse = attn.blockwise_mha_forward(x, x, x, bias, 2)
    with pytest.raises(ValueError, match="do must be"):
        attn.blockwise_mha_backward(x, x, x, bias, out, lse, torch.zeros(2, 8, 16), 2)
    before = _build.launch_counts()
    attn.blockwise_mha(x.requires_grad_(), x, x, bias, 2).sum().backward()
    assert _build.launch_counts() == before  # CPU tensors launch nothing


# -- fused dropout ------------------------------------------------------------


@pytest.mark.parametrize(
    "counter,key,want",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ],
    ids=["zeros", "ones", "pi_digits"],
)
def test_philox_known_answers(counter, key, want):
    """Philox-4x32-10 against Random123's known-answer vectors."""
    as_t = lambda words: tuple(torch.tensor([w], dtype=torch.int64) for w in words)  # noqa: E731
    got = philox4x32_10(as_t(counter), as_t(key))
    assert tuple(int(w) for w in got) == want


def test_dropout_rate_zero_is_identity():
    x = torch.ones(4, 16)
    assert fused_dropout(x, 3, 0.0) is x
    assert fused_dropout(x, torch.tensor([3], dtype=torch.int32), -1.0) is x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_rate_and_scaling(rate, dtype):
    """Over 2**18 elements the kept share is within 4 sigma of 1 - rate, and
    a kept value is x * (1 / (1 - rate)) rounded once to the dtype: within
    one ulp of x / (1 - rate) (the JAX kernel multiplies, its CPU fallback
    divides)."""
    n = 1 << 18
    x = torch.from_numpy(np.random.default_rng(0).uniform(0.5, 2.0, size=(n // 256, 256)).astype(np.float32)).to(dtype)
    y = fused_dropout(x, 7, rate)
    assert y.dtype == dtype and y.shape == x.shape
    kept = y != 0
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(kept.float().mean().item() - (1 - rate)) < 4 * sigma
    ulp = 2.0**-8 if dtype == torch.bfloat16 else 2.0**-24
    want = x.float()[kept] / (1 - rate)
    assert ((y.float()[kept] - want).abs() <= 2 * ulp * want).all()  # ulp <= 2 * 2**-p * |value|
    assert torch.equal(y[kept], (x.float()[kept] * torch.tensor(1 / (1 - rate), dtype=torch.float32)).to(dtype))


def test_dropout_is_a_function_of_seed_and_element():
    """Same seed, same mask; another seed, another mask; the mask does not
    depend on the shape the elements are presented in, nor on how many
    follow; an int seed and its int32 tensor agree."""
    x = torch.ones(64, 32)
    a = fused_dropout(x, 5, 0.5)
    assert torch.equal(a, fused_dropout(x, torch.tensor([5], dtype=torch.int32), 0.5))
    assert not torch.equal(a, fused_dropout(x, 6, 0.5))
    assert torch.equal(fused_dropout(x.reshape(256, 8), 5, 0.5).reshape(64, 32), a)
    assert torch.equal(fused_dropout(x.reshape(-1)[:1001], 5, 0.5), a.reshape(-1)[:1001])
    assert fused_dropout(torch.ones(2, 16, 32), 1, 0.5).shape == (2, 16, 32)
    bits = dropout_bits(torch.tensor([5], dtype=torch.int32), 2048)
    assert bits.dtype == torch.int64 and bits.min() >= 0 and bits.max() < 2**32
    assert torch.equal(bits > 2**31, a.reshape(-1) != 0)
    # a negative seed is its 32-bit pattern: key (0xFFFFFFFF, 0), counter 0
    word = lambda w: torch.tensor([w], dtype=torch.int64)  # noqa: E731
    want = philox4x32_10((word(0),) * 4, (word(0xFFFFFFFF), word(0)))
    assert torch.equal(dropout_bits(torch.tensor([-1], dtype=torch.int32), 4), torch.cat(want))


def test_dropout_backward_regenerates_the_mask():
    """The gradient of sum(y * w) is w through the forward's mask, scaled by
    1 / (1 - rate): the backward is the forward on g with the same seed."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.uniform(1.0, 2.0, size=(64, 32)).astype(np.float32))
    seed = torch.tensor([11], dtype=torch.int32)
    y = fused_dropout(x, seed, 0.4)
    (dx,) = torch.autograd.grad((y * w).sum(), x)
    assert torch.equal(y != 0, dx != 0)
    assert torch.equal(dx, fused_dropout_reference(w, seed, 0.4))
    torch.testing.assert_close(dx[dx != 0], (w / 0.6)[dx != 0], rtol=1e-6, atol=0)


def test_dropout_wrapper_checks_inputs():
    x = torch.ones(4, 8)
    with pytest.raises(ValueError, match="rate"):
        fused_dropout(x, 1, 1.0)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fused_dropout(x.double(), 1, 0.1)
    with pytest.raises(ValueError, match="seed"):
        fused_dropout(x, torch.tensor([1, 2], dtype=torch.int32), 0.1)
    with pytest.raises(ValueError, match="seed"):
        fused_dropout(x, torch.tensor([1]), 0.1)  # int64
    with pytest.raises(ValueError, match="unsupported device"):
        fused_dropout(x.to("meta"), 1, 0.1)
    before = _build.launch_counts()
    fused_dropout(x, 1, 0.1)
    assert _build.launch_counts() == before


def test_apply_dropout_back_ends():
    """Both back ends draw from the generator they are given; the fused one
    draws a single int32 seed per site; an unknown back end is refused."""
    from bert4clickpath_torch.models.encoder import Encoder, apply_dropout

    x = torch.ones(200, 50)
    for impl in ("mask", "fused"):
        assert apply_dropout(x, 0.1, None, impl) is x
        assert apply_dropout(x, 0.0, torch.Generator().manual_seed(0), impl) is x
        a, b, c = (apply_dropout(x, 0.1, torch.Generator().manual_seed(s), impl) for s in (0, 0, 1))
        assert torch.equal(a, b) and not torch.equal(a, c)
        kept = a[a != 0]
        torch.testing.assert_close(kept, torch.full_like(kept, 1 / 0.9))
        assert 0.87 < kept.numel() / x.numel() < 0.93
    gen = torch.Generator().manual_seed(0)
    seed = torch.randint(0, 2**31 - 1, (1,), generator=torch.Generator().manual_seed(0), dtype=torch.int32)
    assert torch.equal(apply_dropout(x, 0.1, gen, "fused"), fused_dropout(x, seed, 0.1))
    with pytest.raises(ValueError, match="dropout_impl"):
        apply_dropout(x, 0.1, gen, "pallas")
    with pytest.raises(ValueError, match="dropout_impl"):
        Encoder(1, 8, 2, 16, 0.1, torch.float32, dropout_impl="xla", device="cpu")


# -- the path as a whole --------------------------------------------------------

N_ITEMS, SEQ, B, P = 50, 48, 4, 10


def _small_config(dropout=0.0):
    return long_context_config(seq_len=SEQ, items=N_ITEMS, d_model=32, layers=2, heads=2,
                               dropout=dropout, dtype="float32")


def _batches(n):
    rng = np.random.default_rng(0)
    return [synthetic_batch(rng, B, SEQ - 3, P, N_ITEMS) for _ in range(n)]


def _jax_batch(b):
    return jax.tree_util.tree_map(jnp.asarray, b)


def _torch_batch(b):
    return {
        "features": {k: torch.from_numpy(v) for k, v in b["features"].items()},
        "head_positions": torch.from_numpy(b["head_positions"]),
        "labels": torch.from_numpy(b["labels"]),
    }


def _seeded_flax_params(cfg):
    """Seeded weights (N(0, 0.1), LayerNorm scales near 1) in the flax tree."""
    rng = np.random.default_rng(1)
    sd = {}
    for key, t in seeded_state_dict(cfg, 0).items():
        base = 1.0 if t.dim() == 1 and bool((t == 1).all()) else 0.0
        sd[key] = torch.from_numpy((base + rng.normal(scale=0.1, size=tuple(t.shape))).astype(np.float32))
    return flax_from_state_dict(cfg, sd)


def test_synthetic_batch_matches_the_jax_example():
    """The port's numpy copy of ``synthetic_batch`` draws the same batch."""
    from examples.large_catalog.stress import synthetic_batch as jbatch

    want = jbatch(np.random.default_rng(5), 6, 45, 10, 50)
    got = synthetic_batch(np.random.default_rng(5), 6, 45, 10, 50)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    cfg = long_context_config()
    assert (cfg.features["items"].vocab_rows, cfg.max_len, cfg.positional, cfg.ffn_dim) == (20_480, 1024, "learned", 1024)
    assert JModelConfig.from_json(cfg.to_json()).to_json() == cfg.to_json()


def test_long_context_head_inputs_match_jax(multiblock, forced_blockwise):
    """``gather_head_inputs`` of the small long-context model, both sides on
    their blockwise family (the JAX kernels on 3 x 3 tiles), f32: 1e-4."""
    cfg = _small_config()
    jmodel = JModel(JModelConfig.from_json(cfg.to_json()), attn_impl="pallas")
    params = _seeded_flax_params(cfg)
    b = _batches(1)[0]
    jb = _jax_batch(b)
    want = jmodel.apply(params, jb["features"], jb["head_positions"], method=jmodel.gather_head_inputs)
    model = ClickstreamModel(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(cfg, params))
    tb = _torch_batch(b)
    with torch.no_grad():
        got = model.gather_head_inputs(tb["features"], tb["head_positions"])
    assert got.shape == (B, P, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_long_context_trajectory_matches_jax(multiblock, forced_blockwise):
    """3 steps of ``make_train_step`` (fused CE, dropout 0, f32, bf16 Adam
    first moment, LR 1e-3) on both blockwise families: losses rtol 1e-4.
    Params: Adam with eps 1e-9 turns a gradient that is noise on both sides
    (the key bias's, which the softmax cancels in exact arithmetic) into a
    full +-lr step, so wk's bias is bounded by 2 * lr * steps; every other
    leaf agrees to 1e-3 relative (atol 1e-4)."""
    cfg = _small_config()
    jmodel = JModel(JModelConfig.from_json(cfg.to_json()), attn_impl="pallas")
    params = _seeded_flax_params(cfg)
    model = ClickstreamModel(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(cfg, params))
    jtx = jts.make_optimizer(JTrainConfig(), mu_dtype=jnp.bfloat16)
    jstep = jts.make_train_step(jmodel, jtx, jsched.constant(1e-3), fused_ce_num_valid=N_ITEMS, donate=False)
    jstate = jts.TrainState.create(params, jtx)
    ttx = tts.make_optimizer(TrainConfig(), mu_dtype=torch.bfloat16)
    tstep = tts.make_train_step(model, ttx, schedules.constant(1e-3), fused_ce_num_valid=N_ITEMS)
    tstate = tts.TrainState.create(dict(model.named_parameters()), ttx)
    jlosses, tlosses = [], []
    for b in _batches(3):
        jstate, jl = jstep(jstate, _jax_batch(b), jax.random.PRNGKey(0))
        tstate, tl = tstep(tstate, _torch_batch(b))
        jlosses.append(float(jl))
        tlosses.append(tl.item())
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    flat_got = dict(jax.tree_util.tree_flatten_with_path(flax_from_state_dict(cfg, tstate.params))[0])
    for path, w in jax.tree_util.tree_flatten_with_path(jstate.params)[0]:
        name = jax.tree_util.keystr(path)
        if "wk" in name and path[-1].key == "bias":
            np.testing.assert_allclose(flat_got[path], np.asarray(w), rtol=0, atol=2 * 1e-3 * 3, err_msg=name)
        else:
            np.testing.assert_allclose(flat_got[path], np.asarray(w), rtol=1e-3, atol=1e-4, err_msg=name)


def test_fused_dropout_step_is_deterministic_in_the_seed(forced_blockwise):
    """With dropout 0.1 through the fused back end (the port alone: the bits
    cannot match JAX's), a train step is a function of the generator's
    seed: the same seed gives the same loss and params, another seed others;
    and the mask back end draws other masks from the same seed."""
    cfg = _small_config(dropout=0.1)
    sd = seeded_state_dict(cfg, 0)
    batch = _torch_batch(_batches(1)[0])

    def run(seed, impl="fused"):
        model = ClickstreamModel(cfg, device="cpu", dropout_impl=impl)
        model.load_state_dict(sd)
        tx = tts.make_optimizer(TrainConfig(), mu_dtype=torch.bfloat16)
        state = tts.TrainState.create(dict(model.named_parameters()), tx)
        step = tts.make_train_step(model, tx, schedules.constant(1e-3), fused_ce_num_valid=N_ITEMS)
        gen = torch.Generator().manual_seed(seed)
        for _ in range(2):
            state, loss = step(state, batch, gen)
        return loss, {k: p.detach().clone() for k, p in state.params.items()}

    (l0, p0), (l1, p1), (l2, p2) = run(0), run(0), run(1)
    assert torch.isfinite(l0) and torch.equal(l0, l1) and not torch.equal(l0, l2)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert any(not torch.equal(p0[k], p2[k]) for k in p0)
    assert not torch.equal(l0, run(0, impl="mask")[0])
