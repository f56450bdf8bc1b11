"""The port's CE backward routes against the JAX package's, on the CPU.

``ce_backward_two_pass`` (the plain versions of the dx and dW kernels on CPU
tensors) against ``_bwd`` of ``bert4clickpath_tpu/ops/pallas/fused_ce.py``
(its two Pallas kernels in interpret mode), and ``ce_backward_merged``
against ``_bwd_fused`` (the merged Pallas kernel), called directly as the
JAX tests call them, on the same numpy inputs: a window with a row offset,
LABEL_PAD rows, an OOV label, with and without a bias, f32 and bf16, D =
256, 384 and 768 (wider than any whole tile the card's kernels once held:
they stream such rows, so no width is refused). Each test states its
tolerance.
"""

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

N, V, OFF, NV = 24, 384, 10, 300  # 3 vocab tiles of 128 in the JAX kernels


def _case(d, seed=0, oov=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, d)).astype(np.float32)
    table = (rng.normal(size=(V, d)) / np.sqrt(d)).astype(np.float32)
    bias = rng.normal(size=(V,)).astype(np.float32)
    labels = rng.integers(0, NV, size=(N,)).astype(np.int32)
    labels[::5] = LABEL_PAD
    if oov:
        labels[1] = NV + 20  # a row outside the window (blinded)
    dnll = (rng.random(N).astype(np.float32) + 0.5) * (labels != LABEL_PAD)
    return x, table, bias, labels, dnll


def _logz(x, table, bias, dtype):
    m, l = k.ce_stats_reference(torch.from_numpy(x).to(dtype), torch.from_numpy(table),
                                None if bias is None else torch.from_numpy(bias), OFF, NV)
    return (m + torch.log(l)).numpy()


def _both(x, table, bias, labels, dnll, dtype):
    """(port two-pass, JAX _bwd) on the same arrays, x in ``dtype``."""
    logz = _logz(x, table, bias, dtype)
    tx = torch.from_numpy(x).to(dtype)
    tb = None if bias is None else torch.from_numpy(bias)
    lab = tce._labels_model(torch.from_numpy(labels), OFF)
    got = k.ce_backward_two_pass(tx, torch.from_numpy(table), tb, lab, torch.from_numpy(logz),
                                 torch.from_numpy(dnll), OFF, NV)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = jce._bwd(
        jx, jnp.asarray(table), jce._labels_model(jnp.asarray(labels), OFF), jnp.asarray(logz),
        jnp.asarray(dnll), OFF, NV, bias=None if bias is None else jnp.asarray(bias).reshape(1, -1),
    )
    return got, want


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("d,oov", [(32, False), (32, True), (384, False), (768, False)])
def test_two_pass_matches_jax_bwd_f32(d, oov, with_bias):
    """f32: rtol 1e-5 / atol 1e-6 of the JAX kernels (sums in another
    order). The OOV label's one-hot fires on a blinded row in both."""
    x, table, bias, labels, dnll = _case(d, oov=oov)
    got, want = _both(x, table, bias if with_bias else None, labels, dnll, torch.float32)
    assert len(want) == (3 if with_bias else 2)
    for g, w, name in zip(got, want, ("dx", "dW", "db")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(g.shape), rtol=1e-5, atol=1e-6, err_msg=name)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.float32
    if not with_bias:
        assert got[2] is None
    if not oov:  # blinded rows get exactly zero dW
        assert (got[1][:OFF] == 0).all() and (got[1][OFF + NV :] == 0).all()


@pytest.mark.parametrize("with_bias", [False, True])
def test_two_pass_matches_jax_bwd_bf16(with_bias):
    """bf16 x: the JAX dx kernel adds each of its 3 vocab tiles' products
    into a bf16 output (a rounding per tile), the port sums in f32 and
    rounds once: dx within 4 bf16 ulps (4 * 2^-8) of the largest |dx|. dW
    and db are f32 sums of the same bf16-rounded A in both: rtol 1e-4."""
    x, table, bias, labels, dnll = _case(384, seed=1)
    got, want = _both(x, table, bias if with_bias else None, labels, dnll, torch.bfloat16)
    assert got[0].dtype == torch.bfloat16
    dx, jdx = got[0].float().numpy(), np.asarray(want[0].astype(jnp.float32))
    assert np.abs(dx - jdx).max() <= 4 * 2.0**-8 * np.abs(jdx).max()
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4, atol=1e-6, err_msg="dW")
    if with_bias:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]).reshape(-1), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_pass_equals_merged(dtype):
    """The pair and the merged backward compute the same three results: on
    the CPU their plain versions agree to f32 rounding (1e-6)."""
    x, table, bias, labels, dnll = _case(64, seed=2)
    logz = torch.from_numpy(_logz(x, table, bias, dtype))
    args = (torch.from_numpy(x).to(dtype), torch.from_numpy(table), torch.from_numpy(bias),
            tce._labels_model(torch.from_numpy(labels), OFF), logz, torch.from_numpy(dnll), OFF, NV)
    for g, w in zip(k.ce_backward_two_pass(*args), k.ce_backward_merged(*args)):
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), rtol=1e-6, atol=1e-7)
    dx = k.ce_backward_dx(*args)
    dw, db = k.ce_backward_dw(*args)
    assert torch.equal(dx, k.ce_backward_dx_reference(*args))
    assert torch.equal(dw, k.ce_backward_dw_reference(*args)[0]) and db is not None


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merged_matches_jax_bwd_fused(dtype, with_bias):
    """``ce_backward_merged`` (its plain version, on CPU tensors) against
    the JAX merged backward ``_bwd_fused`` (interpret mode) on the same
    arrays, D = 256, N = 100 and V = 300 (off the card kernel's 64-row
    tiles; one whole-table tile in the JAX kernel), a window of 250 rows at
    offset 10, LABEL_PAD rows and an OOV label. f32: rtol 1e-5 / atol 1e-6
    (sums in another order). bf16 x: A rounds to bf16 before the products,
    and an f32 exp that differs in its last bit can round an entry to the
    other neighbour, so dW and db are held to 1e-3 of their largest
    magnitude (measured: 6.5e-5) and dx, which both round once from an f32
    sum, to that plus one bf16 ulp of each value (2^-7 of it)."""
    n, v, d, nv = 100, 300, 256, 250
    rng = np.random.default_rng(8)
    x = rng.normal(size=(n, d)).astype(np.float32)
    table = (rng.normal(size=(v, d)) / np.sqrt(d)).astype(np.float32)
    bias = rng.normal(size=(v,)).astype(np.float32) if with_bias else None
    labels = rng.integers(0, nv, size=(n,)).astype(np.int32)
    labels[::5] = LABEL_PAD
    labels[1] = nv + 20  # a row outside the window (blinded)
    dnll = (rng.random(n).astype(np.float32) + 0.5) * (labels != LABEL_PAD)
    tx = torch.from_numpy(x).to(dtype)
    tb = None if bias is None else torch.from_numpy(bias)
    m, l = k.ce_stats_reference(tx, torch.from_numpy(table), tb, OFF, nv)
    logz = (m + torch.log(l)).numpy()
    got = k.ce_backward_merged(tx, torch.from_numpy(table), tb, tce._labels_model(torch.from_numpy(labels), OFF),
                               torch.from_numpy(logz), torch.from_numpy(dnll), OFF, nv)
    want = jce._bwd_fused(
        jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32), jnp.asarray(table),
        jce._labels_model(jnp.asarray(labels), OFF), jnp.asarray(logz), jnp.asarray(dnll), OFF, nv,
        bias=None if bias is None else jnp.asarray(bias).reshape(1, -1),
    )
    assert len(want) == (3 if with_bias else 2) and got[0].dtype == dtype
    dx, jdx = got[0].float().numpy(), np.asarray(want[0].astype(jnp.float32))
    pairs = [(got[1].numpy(), np.asarray(want[1]))]
    if with_bias:
        pairs.append((got[2].numpy(), np.asarray(want[2]).reshape(-1)))
    else:
        assert got[2] is None
    if dtype == torch.float32:
        for g, w in [(dx, jdx), *pairs]:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    else:
        assert (np.abs(dx - jdx) <= 1e-3 * np.abs(jdx).max() + 2.0**-7 * np.abs(jdx)).all()
        for g, w in pairs:
            assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max()


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,v", [(77, 300), (N, V)])
def test_forward_stats_match_jax_fwd_stats(n, v, dtype, with_bias):
    """``ce_stats`` (its plain version, on CPU tensors) against the JAX
    forward ``_fwd_stats`` (``_fwd_kernel`` in interpret mode) on the same
    arrays: m and l themselves, not only logz. N = 77 and V = 300 lie off
    the card kernel's 64-row tiles (one whole-table tile in the JAX kernel),
    the window blinds rows at both ends. x in f32 or bf16 (the table rounded
    to bf16 by both, so the products are exact and only the order of the f32
    sums differs): m within rtol 1e-6 / atol 1e-6, l within rtol 1e-5."""
    nv = v - OFF - 7
    rng = np.random.default_rng(n + v)
    x = rng.normal(size=(n, 64)).astype(np.float32)
    table = (rng.normal(size=(v, 64)) / 4).astype(np.float32)
    bias = rng.normal(size=(v,)).astype(np.float32) if with_bias else None
    tx = torch.from_numpy(x).to(dtype)
    m, l = k.ce_stats(tx, torch.from_numpy(table), None if bias is None else torch.from_numpy(bias), OFF, nv)
    jm, jl = jce._fwd_stats(
        jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32), jnp.asarray(table),
        jnp.asarray(0, jnp.int32), OFF, nv, bias=None if bias is None else jnp.asarray(bias).reshape(1, -1),
    )
    assert m.shape == l.shape == (n,) and m.dtype == l.dtype == torch.float32
    np.testing.assert_allclose(m.numpy(), np.asarray(jm).reshape(-1), rtol=1e-6, atol=1e-6, err_msg="m")
    np.testing.assert_allclose(l.numpy(), np.asarray(jl).reshape(-1), rtol=1e-5, err_msg="l")


def test_forward_split_rule_covers_every_tile_once():
    """The forward's schedule: its vocabulary splits cover every
    ``FWD_VOCAB``-row vocab tile exactly once (each split non-empty) at a
    spread of (N, V), aim at ``FWD_TARGET_UNITS`` units of (row tile,
    split) with at least ``FWD_MIN_TILES`` tiles a split (short of the
    vocabulary's end), and the long-session shape (N = 160, V = 20,480: 2
    row tiles of ``FWD_ROWS``) has units for at least one wave of the
    H100's 132 SMs."""
    for n, v in ((2560, 55296), (160, 20480), (1, 1), (1, 64), (70000, 64), (5, 100000), (130, 700), (64, 65)):
        splits, per = k.ce_splits(n, v)
        tiles = -(-v // k.FWD_VOCAB)
        covered = [j for s in range(splits) for j in range(s * per, min((s + 1) * per, tiles))]
        assert covered == list(range(tiles)), (n, v)
        assert all(s * per < tiles for s in range(splits)), (n, v)  # no empty split
        assert per >= min(k.FWD_MIN_TILES, tiles), (n, v)
        row_tiles = -(-n // k.FWD_ROWS)
        most = row_tiles * -(-tiles // min(k.FWD_MIN_TILES, tiles))  # units at the fewest tiles a split
        assert row_tiles * splits >= min(k.FWD_TARGET_UNITS, most) // 2, (n, v)
    splits, _ = k.ce_splits(160, 20480)
    assert -(-160 // k.FWD_ROWS) * splits >= 132


def test_backward_route_is_a_function_of_d_alone():
    assert [k.ce_backward_route(d) for d in (1, 64, 256, 257, 384, 512)] == [
        "merged", "merged", "merged", "two_pass", "two_pass", "two_pass"]
    assert k.MAX_D == 256 and k.TWO_PASS_OUT_COLS == 384
    assert not hasattr(k, "MAX_D_FWD") and not hasattr(k, "MAX_D_TWO_PASS")  # no kernel refuses a width
    # the dx grid: the vocabulary split covers every tile, for any shape
    for n, v, d in ((2560, 55296, 384), (160, 20480, 256), (1, 1, 1), (70000, 64, 700), (5, 100000, 384)):
        splits, per = k.ce_dx_splits(n, v, d)
        tiles = -(-v // k.TILE)
        assert splits >= 1 and splits * per >= tiles and (splits - 1) * per < tiles, (n, v, d)


def test_wide_rows_go_through_the_two_pass_pair(monkeypatch):
    """fused_softmax_ce at D = 384: the backward takes the two-pass route
    (and at D = 64 the merged one), the gradients match the dense oracle
    (rtol 1e-4: f32 sums in another order), and no kernel is launched for
    CPU tensors."""
    calls = []
    for name in ("ce_backward_merged", "ce_backward_two_pass"):
        real = getattr(k, name)
        monkeypatch.setattr(k, name, lambda *a, _real=real, _name=name: (calls.append(_name), _real(*a))[1])
    before = _build.launch_counts()
    for d, route in ((384, "ce_backward_two_pass"), (64, "ce_backward_merged")):
        x, table, _, labels, _ = _case(d, seed=3)
        grads = []
        for fn in (tce.fused_softmax_ce, tce.dense_softmax_ce):
            tx = torch.from_numpy(x).requires_grad_()
            tt = torch.from_numpy(table).requires_grad_()
            fn(tx, tt, torch.from_numpy(labels), OFF, NV).sum().backward()
            grads.append((tx.grad, tt.grad))
        assert calls[-1] == route
        for g, w in zip(*grads):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5)
    assert _build.launch_counts() == before


def test_two_pass_wrappers_check_inputs():
    x, table, bias, labels, dnll = _case(32)
    lab = tce._labels_model(torch.from_numpy(labels), OFF)
    logz = torch.zeros(N)
    args = (torch.from_numpy(x), torch.from_numpy(table), None, lab, logz, torch.from_numpy(dnll), OFF, NV)
    for fn in (k.ce_backward_dx, k.ce_backward_dw, k.ce_backward_two_pass, k.ce_backward):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fn(args[0].double(), *args[1:])
        with pytest.raises(ValueError, match="logz must be"):
            fn(*args[:4], logz[:-1], *args[5:])
        with pytest.raises(ValueError, match="bias must be"):
            fn(args[0], args[1], torch.zeros(V - 1), *args[3:])


def test_fused_softmax_ce_matches_jax_at_a_wide_row():
    """fused_softmax_ce at D = 768, small N and V, forward and gradients of
    x and the table against the JAX package's fused CE (its Pallas kernels
    in interpret mode): nll rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 /
    atol 1e-6 (f32 sums in another order)."""
    import jax

    from bert4clickpath_tpu.ops.pallas.fused_ce import fused_softmax_ce as jfused

    x, table, _, labels, _ = _case(768, seed=4)
    tx = torch.from_numpy(x).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    nll = tce.fused_softmax_ce(tx, tt, torch.from_numpy(labels), OFF, NV)
    gx, gt = torch.autograd.grad(nll.sum(), (tx, tt))

    jl = jnp.asarray(labels)
    want = jfused(jnp.asarray(x), jnp.asarray(table), jl, OFF, NV)
    jgx, jgt = jax.grad(lambda a, b: jfused(a, b, jl, OFF, NV).sum(), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(table))
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(jgt), rtol=1e-4, atol=1e-6)
    assert (nll[labels == LABEL_PAD] == 0).all()
