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
    w = torch.zeros(B, L, D, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        mha(w, x, x, bias, H)
    with torch.no_grad():
        mha(w, x, x, bias, H)  # fine without grad


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
    with pytest.raises(RuntimeError, match="forward-only"):
        gather_scale_pos(table.requires_grad_(), ids, pos, 1.0)


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
