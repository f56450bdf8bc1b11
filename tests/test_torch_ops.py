"""The port's ops and kernels' plain versions vs the JAX package.

Inputs are made with numpy from a seed and go through the JAX function
(the Pallas kernels in interpret mode on the CPU) and its counterpart in
bert4clickpath_torch. Each test states its tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert4clickpath_torch.ops.kernels import _build

torch.set_num_threads(1)

B, L, D, H = 3, 13, 32, 4


def _bias(rng, b, l, full_pad_row=None):
    """(B, 1, 1, L) f32 padding bias with ragged padding; one row all pad."""
    bias = np.where(rng.random((b, 1, 1, l)) < 0.3, -1e9, 0.0).astype(np.float32)
    if full_pad_row is not None:
        bias[full_pad_row] = -1e9
    return bias


# -- attention --------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["separate", "qkv_slices"])
def test_mha_reference_matches_fused_mha(dtype, layout):
    """mha_reference (and the CPU wrapper) vs fused_mha in interpret mode.
    Tolerance: f32 atol 1e-5 (sums in another order); bf16 atol 2e-2 (one
    bf16 ulp of an O(1) output, from p or o rounding the other way)."""
    from bert4clickpath_tpu.ops.pallas.attention import fused_mha
    from bert4clickpath_torch.ops.kernels.attention import mha, mha_reference

    rng = np.random.default_rng(0)
    qkv = rng.normal(size=(B, L, 3 * D)).astype(np.float32)
    bias = _bias(rng, B, L, full_pad_row=1)
    tdt = getattr(torch, dtype)
    if layout == "qkv_slices":
        t = torch.from_numpy(qkv).to(tdt)
        q, k, v = t[..., :D], t[..., D : 2 * D], t[..., 2 * D :]
        assert q.stride(1) == 3 * D and not q.is_contiguous()
    else:
        q, k, v = (torch.from_numpy(np.ascontiguousarray(qkv[..., i * D : (i + 1) * D])).to(tdt) for i in range(3))
    jq, jk, jv = (jnp.asarray(qkv[..., i * D : (i + 1) * D], getattr(jnp, dtype)) for i in range(3))
    want = np.asarray(fused_mha(jq, jk, jv, jnp.asarray(bias), H), np.float32)

    got = mha_reference(q, k, v, torch.from_numpy(bias), H)
    assert got.dtype == tdt and got.shape == (B, L, D)
    atol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)
    # the fully padded row softmaxes to a uniform distribution, not NaN
    assert np.isfinite(got.float().numpy()).all()
    # the wrapper takes the plain version on CPU tensors
    torch.testing.assert_close(mha(q, k, v, torch.from_numpy(bias), H), got, rtol=0, atol=0)


def test_mha_fully_padded_row_is_uniform():
    """A row whose keys are all [PAD] averages v over every key (exact up to
    f32 rounding, atol 1e-6)."""
    from bert4clickpath_torch.ops.kernels.attention import mha_reference

    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, L, D)).astype(np.float32)) for _ in range(3))
    bias = torch.full((1, 1, 1, L), -1e9)
    got = mha_reference(q, k, v, bias, H)
    want = v.mean(dim=1, keepdim=True).expand(1, L, D)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_mha_wrapper_checks_inputs():
    from bert4clickpath_torch.ops.kernels.attention import mha

    x = torch.zeros(B, L, D)
    bias = torch.zeros(B, 1, 1, L)
    with pytest.raises(ValueError, match="bias"):
        mha(x, x, x, torch.zeros(B, L), H)
    with pytest.raises(ValueError, match="divisible"):
        mha(x, x, x, bias, 5)
    with pytest.raises(ValueError, match="bfloat16 or all float32"):
        mha(x, x, x.double(), bias, H)
    with pytest.raises(ValueError, match="unsupported device"):
        mha(x.to("meta"), x.to("meta"), x.to("meta"), bias.to("meta"), H)
    # differentiable now: a gradient reaches q, and no grad is asked without one
    w = torch.zeros(B, L, D, requires_grad=True)
    mha(w, x, x, bias, H).sum().backward()
    assert w.grad is not None and w.grad.shape == (B, L, D)
    with torch.no_grad():
        assert not mha(w, x, x, bias, H).requires_grad


def test_mha_smem_budget_names_long_sequences():
    from bert4clickpath_torch.ops.kernels.attention import MAX_SHARED_BYTES, mha_smem_bytes

    # the serving shape fits one block with room to spare; very long rows do not
    assert mha_smem_bytes(53, 64) < 48 * 1024
    assert mha_smem_bytes(4096, 64) > MAX_SHARED_BYTES


# -- fused gather -----------------------------------------------------------


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_gather_reference_matches_pallas(out_dtype):
    """gather_scale_pos_reference vs fused_gather_scale_pos (interpret).
    The JAX kernel needs B*L to tile by 8, so it runs on L=16 and the port
    on the first 13 positions (B*L=13, not a multiple of 8). Tolerance:
    f32 rtol 1e-6; bf16 within one bf16 ulp (rtol 2**-8): both round the
    same f32 value once."""
    from bert4clickpath_tpu.ops.pallas.gather import fused_gather_scale_pos
    from bert4clickpath_torch.ops.kernels.gather import gather_scale_pos, gather_scale_pos_reference

    rng = np.random.default_rng(2)
    v, l_jax, l = 300, 16, 13
    table = rng.normal(size=(v, D)).astype(np.float32)
    ids = rng.integers(0, v, size=(1, l_jax)).astype(np.int32)
    ids[0, 0], ids[0, 1] = 0, v - 1
    pos = rng.normal(size=(l_jax, D)).astype(np.float32)
    scale = float(np.sqrt(D))
    want = fused_gather_scale_pos(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(pos), scale,
        out_dtype=getattr(jnp, out_dtype), tile=16,
    )
    want = np.asarray(want, np.float32)[:, :l]
    tdt = getattr(torch, out_dtype)
    args = (torch.from_numpy(table), torch.from_numpy(ids[:, :l].copy()), torch.from_numpy(pos[:l].copy()), scale, tdt)
    got = gather_scale_pos_reference(*args)
    assert got.dtype == tdt and got.shape == (1, l, D)
    rtol = 1e-6 if out_dtype == "float32" else 2.0**-8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=1e-6)
    # the wrapper takes the plain version on CPU tensors
    torch.testing.assert_close(gather_scale_pos(*args), got, rtol=0, atol=0)


def test_gather_wrapper_checks_inputs():
    from bert4clickpath_torch.ops.kernels.gather import gather_scale_pos

    table = torch.zeros(10, D)
    ids = torch.zeros(2, 5, dtype=torch.int32)
    pos = torch.zeros(5, D)
    with pytest.raises(ValueError, match="int32"):
        gather_scale_pos(table, ids.long(), pos, 1.0)
    with pytest.raises(ValueError, match="pos"):
        gather_scale_pos(table, ids, torch.zeros(4, D), 1.0)
    with pytest.raises(ValueError, match="out_dtype"):
        gather_scale_pos(table, ids, pos, 1.0, torch.float16)
    with pytest.raises(ValueError, match="unsupported device"):
        gather_scale_pos(table.to("meta"), ids.to("meta"), pos.to("meta"), 1.0)
    # differentiable now: the table gets the scatter-add of the output grad
    gather_scale_pos(table.requires_grad_(), ids, pos, 1.0).sum().backward()
    assert table.grad[0].sum() == 10 * D and table.grad[1:].abs().sum() == 0


def test_cpu_path_launches_no_kernel():
    """CPU tensors take the plain versions: no launch is counted."""
    from bert4clickpath_torch.ops.kernels.attention import mha
    from bert4clickpath_torch.ops.kernels.gather import gather_scale_pos

    before = _build.launch_counts()
    gather_scale_pos(torch.zeros(10, D), torch.zeros(2, 5, dtype=torch.int32), torch.zeros(5, D), 1.0)
    x = torch.zeros(2, 5, D)
    mha(x, x, x, torch.zeros(2, 1, 1, 5), H)
    assert _build.launch_counts() == before


# -- masking, positions, padding, chunked scan --------------------------------


def test_masking_matches_jax():
    from bert4clickpath_tpu.ops import masking as jm
    from bert4clickpath_torch.ops import masking as tm

    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 6, size=(4, L)).astype(np.int32)
    t = torch.from_numpy(tokens)
    got = tm.padding_bias(t)
    assert got.shape == (4, 1, 1, L) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm.padding_bias(jnp.asarray(tokens))))
    np.testing.assert_array_equal(tm.valid_token_mask(t).numpy(), np.asarray(jm.valid_token_mask(jnp.asarray(tokens))))
    np.testing.assert_array_equal(tm.segment_ids(t, 4).numpy(), np.asarray(jm.segment_ids(jnp.asarray(tokens), 4)))


@pytest.mark.parametrize("shape", [(53, 256), (13, 32), (7, 6)])
def test_sinusoidal_positions_identical(shape):
    from bert4clickpath_tpu.models.positional import sinusoidal_positions as jax_sin
    from bert4clickpath_torch.models.positional import sinusoidal_positions

    np.testing.assert_array_equal(sinusoidal_positions(*shape), jax_sin(*shape))


def test_padded_rows_and_pick_chunk_match_jax():
    from bert4clickpath_tpu.ops.chunked_eval import pick_chunk as jax_pick
    from bert4clickpath_tpu.ops.pallas.fused_ce import padded_rows as jax_padded
    from bert4clickpath_torch.ops.chunked_eval import pick_chunk
    from bert4clickpath_torch.ops.fused_ce import padded_rows

    for v in (1, 127, 128, 300, 4096, 4097, 54_553, 55_296, 1_000_001, 10_000_011):
        assert padded_rows(v) == jax_padded(v), v
    for v, rows in ((55_296, 1), (55_296, 64), (384, 0), (65536 * 31, 8), (1 << 20, 8192), (300, 0)):
        assert pick_chunk(v, rows=rows) == jax_pick(v, rows=rows), (v, rows)
    with pytest.raises(ValueError):
        pick_chunk(10_001)


@pytest.mark.parametrize("with_bias", [False, True])
def test_chunked_scores_matches_jax(with_bias):
    """chunked_scores vs the JAX scan, with blinded rows, labels (one in a
    later chunk, one pad) and an optional bias. f32 throughout: rtol/atol
    1e-5. Top-k ids compared where neighbouring scores differ by > 1e-4
    (torch.topk and lax.top_k order exact ties differently)."""
    from bert4clickpath_tpu.ops import chunked_eval as jce
    from bert4clickpath_torch.ops import chunked_eval as tce

    rng = np.random.default_rng(4)
    v, d, k, chunk, row_offset, num_valid = 512, 16, 7, 128, 10, 480
    x = rng.normal(size=(3, 2, d)).astype(np.float32)
    table = rng.normal(size=(v, d)).astype(np.float32)
    labels = np.array([[0, 300], [-1, 479], [5, 200]], np.int32)
    bias = rng.normal(size=(v,)).astype(np.float32) if with_bias else None
    want = jce.chunked_scores(
        jnp.asarray(x), jnp.asarray(table), jnp.asarray(labels), k, row_offset, num_valid, chunk,
        bias=None if bias is None else jnp.asarray(bias),
    )
    got = tce.chunked_scores(
        torch.from_numpy(x), torch.from_numpy(table), torch.from_numpy(labels), k, row_offset, num_valid, chunk,
        bias=None if bias is None else torch.from_numpy(bias),
    )
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    vals = got[2].numpy()
    gap_ok = np.diff(vals, axis=-1) < -1e-4
    separated = np.concatenate([gap_ok[..., :1], gap_ok[..., 1:] & gap_ok[..., :-1], gap_ok[..., -1:]], axis=-1)
    np.testing.assert_array_equal(got[3].numpy()[separated], np.asarray(want[3])[separated])
    # blinded rows never rank
    rows = got[3].numpy()
    assert ((rows >= row_offset) & (rows < row_offset + num_valid)).all()

    stats_t = tce.ranking_sums_from_topk(got[0], got[1], got[3] - row_offset, torch.from_numpy(labels), (1, 5))
    stats_j = jce.ranking_sums_from_topk(want[0], want[1], want[3] - row_offset, jnp.asarray(labels), (1, 5))
    assert set(stats_t) == set(stats_j)
    for key in stats_j:
        np.testing.assert_allclose(float(stats_t[key]), float(stats_j[key]), rtol=1e-5, atol=1e-5, err_msg=key)


# -- fused softmax CE ---------------------------------------------------------

CE_N, CE_D, CE_V, CE_VALID, CE_OFF = 24, 16, 256, 200, 10


def _ce_inputs(seed=0):
    from bert4clickpath_torch.constants import LABEL_PAD

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(CE_N, CE_D)).astype(np.float32)
    table = rng.normal(size=(CE_V, CE_D)).astype(np.float32)
    bias = rng.normal(size=CE_V).astype(np.float32)
    labels = rng.integers(0, CE_VALID, size=CE_N).astype(np.int32)
    labels[::5] = LABEL_PAD
    labels[1] = CE_VALID + 20  # OOV: a blinded padding row of the table
    g = rng.normal(size=CE_N).astype(np.float32)
    return x, table, bias, labels, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_fused_ce_matches_jax(dtype, with_bias):
    """nll and the x / table / bias grads of the port's fused CE (plain
    versions) against fused_softmax_ce(_bias) in interpret mode, LABEL_PAD
    rows and an OOV label included. Tolerances as tests/test_fused_ce.py:
    f32 rtol 1e-5 / atol 1e-6 on nll, rtol 1e-4 / atol 1e-6 on grads; bf16
    x rtol 5e-2 / atol 1e-2 (bf16 rounds x, W and A)."""
    import jax

    from bert4clickpath_tpu.ops.pallas import fused_ce as jce
    from bert4clickpath_torch.ops import fused_ce as tce

    x, table, bias, labels, g = _ce_inputs()
    jx = jnp.asarray(x, getattr(jnp, dtype))
    if with_bias:
        f = lambda a, t, b: jce.fused_softmax_ce_bias(a, t, b, jnp.asarray(labels), CE_OFF, CE_VALID)  # noqa: E731
        jnll, vjp = jax.vjp(f, jx, jnp.asarray(table), jnp.asarray(bias))
    else:
        f = lambda a, t: jce.fused_softmax_ce(a, t, jnp.asarray(labels), CE_OFF, CE_VALID)  # noqa: E731
        jnll, vjp = jax.vjp(f, jx, jnp.asarray(table))
    jgrads = [np.asarray(t, np.float32) for t in vjp(jnp.asarray(g))]

    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    tl = torch.from_numpy(labels)
    if with_bias:
        nll = tce.fused_softmax_ce_bias(tx, tt, tb, tl, CE_OFF, CE_VALID)
        inputs = (tx, tt, tb)
    else:
        nll = tce.fused_softmax_ce(tx, tt, tl, CE_OFF, CE_VALID)
        inputs = (tx, tt)
    grads = torch.autograd.grad(nll, inputs, torch.from_numpy(g))

    f32 = dtype == "float32"
    rtol, atol = (1e-5, 1e-6) if f32 else (5e-2, 1e-2)
    keep = np.arange(CE_N) != 1
    np.testing.assert_allclose(nll.detach().numpy()[keep], np.asarray(jnll)[keep], rtol=rtol, atol=atol)
    assert nll[1].item() > 1e29 and float(jnll[1]) > 1e29  # the OOV label fails loudly
    assert (nll.detach().numpy()[::5] == 0).all()  # LABEL_PAD rows
    grtol, gatol = (1e-4, 1e-6) if f32 else (5e-2, 1e-2)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=grtol, atol=gatol)
    # blinded rows get exactly zero table grad, but for the OOV label's row
    blinded = np.ones(CE_V, bool)
    blinded[CE_OFF : CE_OFF + CE_VALID] = False
    blinded[CE_OFF + labels[1]] = False
    assert (grads[1].numpy()[blinded] == 0).all()


def test_fused_ce_blinded_rows_get_zero_probability():
    """softmax over the window only: the dense oracle over the window's rows
    agrees with the fused op whatever the blinded rows hold (1e3 logits
    there would dominate if they leaked); f32 rtol 1e-5."""
    from bert4clickpath_torch.ops.fused_ce import dense_softmax_ce, fused_masked_softmax_cross_entropy

    x, table, _, labels, _ = _ce_inputs(1)
    labels[1] = 3
    table[:CE_OFF] = table[CE_OFF + CE_VALID :][:CE_OFF] = 1e3 * x[0]
    tx, tt, tl = torch.from_numpy(x), torch.from_numpy(table), torch.from_numpy(labels)
    got = fused_masked_softmax_cross_entropy(tx[None], tt, tl[None], CE_OFF, CE_VALID)
    want = dense_softmax_ce(tx, tt, tl, CE_OFF, CE_VALID)
    np.testing.assert_allclose(got.item(), (want.sum() / (tl != -1).sum()).item(), rtol=1e-5)


def test_fused_masked_ce_sums_matches_jax():
    """(sum, count) over (B, P) labels vs the JAX op; f32 rtol 1e-5."""
    from bert4clickpath_tpu.ops.pallas.fused_ce import fused_masked_ce_sums as jsums
    from bert4clickpath_torch.ops.fused_ce import fused_masked_ce_sums as tsums

    x, table, bias, labels, _ = _ce_inputs(2)
    labels[1] = 0
    xb, lb = x.reshape(6, 4, CE_D), labels.reshape(6, 4)
    jt, jc = jsums(jnp.asarray(xb), jnp.asarray(table), jnp.asarray(lb), CE_OFF, CE_VALID, bias=jnp.asarray(bias))
    tt, tc = tsums(torch.from_numpy(xb), torch.from_numpy(table), torch.from_numpy(lb), CE_OFF, CE_VALID,
                   bias=torch.from_numpy(bias))
    np.testing.assert_allclose(tt.item(), float(jt), rtol=1e-5)
    assert tc.item() == float(jc)


def test_ce_kernel_plain_versions_split_the_op():
    """ce_stats_reference gives logz = logsumexp over the window (f32 rtol
    1e-6), and ce_backward_reference's dx / dW / db equal autograd through
    the dense oracle (rtol 1e-4, atol 1e-6)."""
    from bert4clickpath_torch.ops.fused_ce import _labels_model, dense_softmax_ce
    from bert4clickpath_torch.ops.kernels.fused_ce import ce_backward_reference, ce_stats_reference

    x, table, bias, labels, g = _ce_inputs(3)
    labels[1] = 7
    tx, tt, tb = (torch.from_numpy(a).requires_grad_() for a in (x, table, bias))
    tl = torch.from_numpy(labels)
    m, l = ce_stats_reference(tx.detach(), tt.detach(), tb.detach(), CE_OFF, CE_VALID)
    want_logz = torch.logsumexp(tx.detach() @ tt.detach()[CE_OFF : CE_OFF + CE_VALID].T + tb.detach()[CE_OFF : CE_OFF + CE_VALID], -1)
    np.testing.assert_allclose((m + torch.log(l)).numpy(), want_logz.numpy(), rtol=1e-6)
    dnll = torch.from_numpy(g) * (tl != -1).float()
    got = ce_backward_reference(tx.detach(), tt.detach(), tb.detach(), _labels_model(tl, CE_OFF),
                                m + torch.log(l), dnll, CE_OFF, CE_VALID)
    nll = dense_softmax_ce(tx, tt, tl, CE_OFF, CE_VALID, tb)
    want = torch.autograd.grad(nll, (tx, tt, tb), torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)


# -- attention backward and the gather VJP -------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_backward_matches_jax_vjp(dtype):
    """mha's gradients (plain backward, via autograd) vs jax.vjp(fused_mha)
    in interpret mode, ragged padding and a fully padded row included.
    Tolerance: f32 atol 1e-5; bf16 atol 2e-2 (one bf16 ulp of an O(1)
    gradient, from ds or the output rounding the other way)."""
    import jax

    from bert4clickpath_tpu.ops.pallas.attention import fused_mha
    from bert4clickpath_torch.ops.kernels.attention import mha

    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(B, L, D)).astype(np.float32) for _ in range(3))
    do = rng.normal(size=(B, L, D)).astype(np.float32)
    bias = _bias(rng, B, L, full_pad_row=2)
    jdt = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda a, b_, c: fused_mha(a, b_, c, jnp.asarray(bias), H),
                     *(jnp.asarray(t, jdt) for t in (q, k, v)))
    want = [np.asarray(t, np.float32) for t in vjp(jnp.asarray(do, jdt))]

    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(t).to(tdt).requires_grad_() for t in (q, k, v))
    out = mha(tq, tk, tv, torch.from_numpy(bias), H)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do).to(tdt))
    atol = 1e-5 if dtype == "float32" else 2e-2
    for name, g_, w in zip(("dq", "dk", "dv"), got, want):
        assert g_.dtype == tdt and np.isfinite(g_.float().numpy()).all()
        np.testing.assert_allclose(g_.float().numpy(), w, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("l", [13, 53, 116])
def test_mha_backward_dv_from_f32_p_equals_two_bf16_terms(l):
    """What the bf16 whole-row backward kernel relies on: its plain version
    takes dv from the unrounded f32 p (bit for bit against the formula), and
    p as two bf16 terms, hi = round(p) and lo = round(p - hi), each
    multiplied into the same f32 sums, gives that dv to 2^-16 of
    sum_q p |do| (lo's own rounding is 2^-18 of p), where p rounded once is
    off by up to 2^-9 of it; after the bf16 output rounding the two-term dv
    is as close to a dense f64 dv as the f32-p dv is."""
    from bert4clickpath_torch.ops.kernels.attention import _split_heads, mha_backward_reference

    rng = np.random.default_rng(9)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, l, D)).astype(np.float32)).bfloat16() for _ in range(4))
    bias = torch.from_numpy(_bias(rng, B, l))
    _, _, dv = mha_backward_reference(q, k, v, bias, do, H)
    qf, kf, dof = (_split_heads(t, H) for t in (q, k, do))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (1.0 / (D // H) ** 0.5) + bias, dim=-1)
    sums = lambda t: torch.einsum("bhqk,bqhd->bkhd", t, dof)  # noqa: E731
    from_f32 = sums(p)
    assert torch.equal(dv, from_f32.reshape(q.shape).bfloat16())
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    two_terms = sums(hi) + sums(lo)
    envelope = torch.einsum("bhqk,bqhd->bkhd", p, dof.abs())
    slop = 4e-6 * envelope  # the f32 products' and sums' own rounding, in another order
    assert bool(((two_terms - from_f32).abs() <= 2.0**-16 * envelope + slop).all())
    assert bool(((sums(hi) - from_f32).abs() > 2.0**-16 * envelope + slop).any())  # one term is not enough
    exact = torch.einsum("bhqk,bqhd->bkhd", p.double(), dof.double())
    rms = lambda t: float((t.bfloat16().double() - exact).square().mean().sqrt())  # noqa: E731
    assert rms(two_terms) <= 1.001 * rms(from_f32) < rms(sums(hi))


def test_mha_backward_through_qkv_slices():
    """Gradients through q, k, v as column slices of one (B, L, 3D) tensor
    land in the right columns (f32, atol 1e-6 against separate tensors)."""
    from bert4clickpath_torch.ops.kernels.attention import mha

    rng = np.random.default_rng(6)
    qkv = torch.from_numpy(rng.normal(size=(B, L, 3 * D)).astype(np.float32)).requires_grad_()
    bias = torch.from_numpy(_bias(rng, B, L))
    mha(qkv[..., :D], qkv[..., D : 2 * D], qkv[..., 2 * D :], bias, H).square().sum().backward()
    parts = [qkv.detach()[..., i * D : (i + 1) * D].clone().requires_grad_() for i in range(3)]
    mha(*parts, bias, H).square().sum().backward()
    np.testing.assert_allclose(qkv.grad.numpy(), torch.cat([p.grad for p in parts], -1).numpy(), atol=1e-6)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_gather_vjp_matches_jax(out_dtype):
    """d_table (scatter-add of g * scale, repeated ids included) and d_pos
    vs jax.vjp(fused_embed_scale_pos); f32 rtol 1e-5 / atol 1e-5 (sums in
    another order)."""
    import jax

    from bert4clickpath_tpu.ops.pallas.gather import fused_embed_scale_pos
    from bert4clickpath_torch.ops.kernels.gather import gather_scale_pos

    rng = np.random.default_rng(7)
    v, b, l = 40, 4, 16  # B*L = 64: one JAX tile
    table = rng.normal(size=(v, D)).astype(np.float32)
    ids = rng.integers(0, v, size=(b, l)).astype(np.int32)
    ids[0, :4] = 3  # repeated rows sum
    pos = rng.normal(size=(l, D)).astype(np.float32)
    g = rng.normal(size=(b, l, D)).astype(np.float32)
    scale = D**0.5
    jdt = getattr(jnp, out_dtype)
    _, vjp = jax.vjp(lambda t, p: fused_embed_scale_pos(t, jnp.asarray(ids), p, scale, jdt, 64),
                     jnp.asarray(table), jnp.asarray(pos))
    jd_table, jd_pos = (np.asarray(t) for t in vjp(jnp.asarray(g, jdt)))

    tt, tp = torch.from_numpy(table).requires_grad_(), torch.from_numpy(pos).requires_grad_()
    out = gather_scale_pos(tt, torch.from_numpy(ids), tp, scale, getattr(torch, out_dtype))
    d_table, d_pos = torch.autograd.grad(out, (tt, tp), torch.from_numpy(g).to(out.dtype))
    np.testing.assert_allclose(d_table.numpy(), jd_table, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d_pos.numpy(), jd_pos, rtol=1e-5, atol=1e-5)
    assert d_table.dtype == torch.float32 and (d_table.numpy()[np.setdiff1d(np.arange(v), ids)] == 0).all()


# -- losses ------------------------------------------------------------------


def _loss_inputs(kind, seed=8):
    rng = np.random.default_rng(seed)
    if kind == "softmax":
        logits = rng.normal(size=(4, 5, 30)).astype(np.float32) * 3
        labels = rng.integers(0, 30, size=(4, 5)).astype(np.int32)
    else:
        logits = rng.normal(size=(6, 7)).astype(np.float32) * 3
        labels = rng.integers(0, 2, size=(6, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[2] = -1
    return logits, labels


@pytest.mark.parametrize(
    "name,kind,kwargs",
    [
        ("masked_softmax_cross_entropy", "softmax", {}),
        ("softmax_ce_items", "softmax", {}),
        ("masked_binary_cross_entropy", "binary", {}),
        ("masked_binary_cross_entropy", "binary", {"pos_weight": 3.0}),
        ("masked_multilabel_cross_entropy", "binary", {}),
    ],
)
def test_losses_match_jax(name, kind, kwargs):
    """Each ported loss and its gradient vs ops/losses.py; f32 rtol 1e-5,
    atol 1e-6."""
    import jax

    from bert4clickpath_tpu.ops import losses as jl
    from bert4clickpath_torch.ops import losses as tl

    logits, labels = _loss_inputs(kind)
    jf = lambda z: getattr(jl, name)(z, jnp.asarray(labels), **kwargs)  # noqa: E731
    want = np.asarray(jf(jnp.asarray(logits)))
    wgrad = np.asarray(jax.grad(lambda z: jnp.sum(jf(z)))(jnp.asarray(logits)))
    z = torch.from_numpy(logits).requires_grad_()
    got = getattr(tl, name)(z, torch.from_numpy(labels), **kwargs)
    (grad,) = torch.autograd.grad(got.sum(), z)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grad.numpy(), wgrad, rtol=1e-5, atol=1e-6)


def test_masked_mean_and_binary_items_match_jax():
    """masked_mean with weights, binary_ce_items' (nll, weights, scale), and
    the all-pad mean (0, not NaN); f32 rtol 1e-6."""
    from bert4clickpath_tpu.ops import losses as jl
    from bert4clickpath_torch.ops import losses as tl

    logits, labels = _loss_inputs("binary", 9)
    w = np.random.default_rng(9).random(labels.shape).astype(np.float32)
    np.testing.assert_allclose(
        tl.masked_mean(torch.from_numpy(logits), torch.from_numpy(labels), weights=torch.from_numpy(w)).item(),
        float(jl.masked_mean(jnp.asarray(logits), jnp.asarray(labels), weights=jnp.asarray(w))), rtol=1e-6,
    )
    jn, jw, js = jl.binary_ce_items(jnp.asarray(logits), jnp.asarray(labels), pos_weight=2.0)
    tn, tw, ts = tl.binary_ce_items(torch.from_numpy(logits), torch.from_numpy(labels), pos_weight=2.0)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    assert ts == js
    pads = torch.full((3, 4), -1, dtype=torch.int32)
    assert tl.masked_softmax_cross_entropy(torch.zeros(3, 4, 5), pads).item() == 0.0


def test_backward_wrappers_check_inputs():
    """The backward wrappers refuse what their kernels would read out of
    bounds: a do of another shape, per-row vectors of another length."""
    from bert4clickpath_torch.ops.kernels.attention import mha_backward
    from bert4clickpath_torch.ops.kernels.fused_ce import ce_backward

    x = torch.zeros(B, L, D)
    with pytest.raises(ValueError, match="do must be"):
        mha_backward(x, x, x, torch.zeros(B, 1, 1, L), torch.zeros(B, L - 1, D), H)
    xs, table, rows = torch.zeros(6, 8), torch.zeros(20, 8), torch.zeros(6)
    with pytest.raises(ValueError, match="logz"):
        ce_backward(xs, table, None, torch.zeros(6, dtype=torch.int32), torch.zeros(5), rows, 0, 20)
    with pytest.raises(ValueError, match="float32"):
        ce_backward(xs, table.double(), None, torch.zeros(6, dtype=torch.int32), rows, rows, 0, 20)
