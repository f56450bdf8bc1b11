"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test asks the ``cuda`` fixture for a device and skips
where there is none. On a machine with a card (``--noconftest``: the
suite's conftest.py imports jax, which the port's machines need not have):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: attention forward bf16 abs 2e-2, f32 abs
1e-5; attention backward bf16 abs 2e-2 + rel 2e-2 (one or two bf16 ulps of
an O(1) gradient: p, dp and ds are summed in another order, so ds may round
the other way), f32 abs 1e-5 + rel 1e-4; gather exact (both versions round
the same f32 value once). Fused CE: logz abs 1e-4 (f32 sums over the
catalog in another order); dx, dW and db within 1e-4 (f32 x) or 2e-2 (bf16
x) of the reference's largest magnitude (dx sums with atomics, in an order
that varies run to run; bf16 x rounds A, which may round the other way).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bert4clickpath_torch.ops.kernels import _build
from bert4clickpath_torch.constants import LABEL_PAD
from bert4clickpath_torch.ops.kernels import fused_ce as ce_kernels
from bert4clickpath_torch.ops.kernels.attention import mha, mha_backward, mha_backward_reference, mha_reference
from bert4clickpath_torch.ops.kernels.fused_ce import (
    ce_backward,
    ce_backward_reference,
    ce_stats,
    ce_stats_reference,
)
from bert4clickpath_torch.ops.kernels.gather import gather_scale_pos, gather_scale_pos_reference

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 53, 256, 4), (5, 13, 32, 4), (3, 200, 128, 2), (2, 7, 96, 1)])
def test_mha_kernel_matches_plain(cuda, dtype, shape):
    b, l, d, h = shape
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.standard_normal((b, l, 3 * d), dtype=np.float32)).to(cuda, dtype)
    q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
    bias = torch.from_numpy(np.where(rng.random((b, 1, 1, l)) < 0.3, -1e9, 0.0).astype(np.float32)).to(cuda)
    bias[0] = -1e9  # a fully padded row
    before = _build.launch_counts()["attention"]
    got = mha(q, k, v, bias, h)
    assert _build.launch_counts()["attention"] == before + 1
    want = mha_reference(q, k, v, bias, h)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, l, d) and torch.isfinite(got).all()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    # contiguous inputs give the same answer as strided slices
    torch.testing.assert_close(mha(q.contiguous(), k.contiguous(), v.contiguous(), bias, h), got, atol=0, rtol=0)


def test_mha_refuses_what_one_block_cannot_hold(cuda):
    x = torch.zeros(1, 4096, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="blockwise"):
        mha(x, x, x, torch.zeros(1, 1, 1, 4096, device=cuda), 1)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 53, 256), (64, 53, 256), (3, 13, 32)])
def test_gather_kernel_matches_plain(cuda, out_dtype, shape):
    b, l, d = shape
    rng = np.random.default_rng(1)
    v = 1000
    table = torch.from_numpy(rng.standard_normal((v, d), dtype=np.float32)).to(cuda)
    ids_np = rng.integers(0, v, size=(b, l)).astype(np.int32)
    ids_np.flat[0], ids_np.flat[-1] = 0, v - 1
    ids = torch.from_numpy(ids_np).to(cuda)
    pos = torch.from_numpy(rng.standard_normal((l, d), dtype=np.float32)).to(cuda)
    got = gather_scale_pos(table, ids, pos, d**0.5, out_dtype)
    want = gather_scale_pos_reference(table, ids, pos, d**0.5, out_dtype)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_gather_traps_on_out_of_range_id():
    """An id outside [0, V) is a device-side trap, never a silent read. Run
    in a child process: the trap poisons the CUDA context."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    code = (
        "import torch\n"
        "from bert4clickpath_torch.ops.kernels.gather import gather_scale_pos\n"
        "t = torch.zeros(10, 32, device='cuda')\n"
        "ids = torch.full((1, 4), 10, dtype=torch.int32, device='cuda')\n"
        "gather_scale_pos(t, ids, torch.zeros(4, 32, device='cuda'), 1.0)\n"
        "torch.cuda.synchronize()\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "RuntimeError" in proc.stderr or "CUDA error" in proc.stderr


def test_serving_on_card_matches_cpu(cuda, tmp_path):
    """A small bundle served on the card and on the CPU: same rankings,
    log-probs within 2e-2 (bf16 compute on both), and both kernels launched."""
    from bert4clickpath_torch.config import FeatureConfig, HeadConfig, ModelConfig
    from bert4clickpath_torch.training.checkpoint import export_serving
    from bert4clickpath_torch.training.serving import ServingModel
    from bert4clickpath_torch.vocab import Vocabulary

    sys.path.insert(0, REPO)
    from chip_smoke import seeded_state_dict

    vocab = Vocabulary([f"item_{i}" for i in range(500)])
    cfg = ModelConfig(
        features={"items": FeatureConfig(512, 64)}, num_layers=2, num_heads=4, ffn_dim=128,
        max_len=21, head=HeadConfig("tied_softmax", output_size=500), dtype="bfloat16", qkv_fused=True,
    )
    export_serving(str(tmp_path), seeded_state_dict(cfg, 0), cfg, {"items": vocab})
    gpu = ServingModel(str(tmp_path), device=cuda)
    cpu = ServingModel(str(tmp_path), device="cpu")
    sessions = [["item_1", "item_2"], [f"item_{i}" for i in range(30)], []]
    _build.reset_launch_counts()
    got = gpu.recommend(sessions, k=5)
    assert _build.launch_counts() == {"gather": 1, "attention": 2, "attention_bwd": 0, "ce_fwd": 0, "ce_bwd": 0}
    want = cpu.recommend(sessions, k=5)
    for g, w in zip(got, want):
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=2e-2, rtol=0)


def _near(got, want, rel):
    """max |got - want| <= rel * max |want| (both widened to f32)."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= rel * scale, f"max abs err {err} > {rel} x {scale}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(256, 53, 256, 4), (5, 7, 32, 4), (3, 13, 96, 1)])
def test_mha_backward_kernel_matches_plain(cuda, dtype, shape):
    b, l, d, h = shape
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((b, l, 3 * d), dtype=np.float32)).to(cuda, dtype)
    q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
    do = torch.from_numpy(rng.standard_normal((b, l, d), dtype=np.float32)).to(cuda, dtype)
    bias = torch.from_numpy(np.where(rng.random((b, 1, 1, l)) < 0.3, -1e9, 0.0).astype(np.float32)).to(cuda)
    bias[0] = -1e9  # a fully padded row
    before = _build.launch_counts()["attention_bwd"]
    got = mha_backward(q, k, v, bias, do, h)
    assert _build.launch_counts()["attention_bwd"] == before + 1
    want = mha_backward_reference(q, k, v, bias, do, h)
    torch.cuda.synchronize()
    atol, rtol = (2e-2, 2e-2) if dtype == torch.bfloat16 else (1e-5, 1e-4)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == (b, l, d) and torch.isfinite(g).all(), name
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=rtol, msg=name)


def test_mha_autograd_on_card_takes_both_kernels(cuda):
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((4, 9, 96), dtype=np.float32)).to(cuda).requires_grad_()
    bias = torch.zeros(4, 1, 1, 9, device=cuda)
    _build.reset_launch_counts()
    out = mha(qkv[..., :32], qkv[..., 32:64], qkv[..., 64:], bias, 2)
    out.square().sum().backward()
    counts = _build.launch_counts()
    assert counts["attention"] == 1 and counts["attention_bwd"] == 1
    ref = qkv.detach().cpu().requires_grad_()
    mha(ref[..., :32], ref[..., 32:64], ref[..., 64:], bias.cpu(), 2).square().sum().backward()
    torch.testing.assert_close(qkv.grad.cpu(), ref.grad, atol=1e-4, rtol=1e-4)


def _ce_case(n, v, d, dtype, with_bias, seed=0, row_offset=10, oov=False):
    rng = np.random.default_rng(seed)
    num_valid = v - row_offset - 7  # blinded rows at both ends
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to("cuda", dtype)
    table = torch.from_numpy(rng.standard_normal((v, d), dtype=np.float32) * 0.5).cuda()
    bias = torch.from_numpy(rng.standard_normal(v, dtype=np.float32)).cuda() if with_bias else None
    lab = rng.integers(0, num_valid, size=n).astype(np.int32) + row_offset
    lab[::7] = -1  # LABEL_PAD rows
    if oov:
        lab[1] = row_offset + num_valid + 2  # a label in the blinded tail
    logz_dnll = rng.random(n).astype(np.float32)
    dnll = torch.from_numpy(np.where(lab < 0, 0.0, logz_dnll / n).astype(np.float32)).cuda()
    return x, table, bias, torch.from_numpy(lab).cuda(), dnll, row_offset, num_valid


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize(
    "n,v,d,dtype",
    [
        (2560, 55_296, 256, torch.float32),  # the flagship's N, padded catalog, D
        (100, 128, 32, torch.float32),  # N off the 64-row tile, V one tile pair
        (77, 1000, 64, torch.bfloat16),  # ragged V, bf16 x
        (64, 2100, 8, torch.float32),  # several forward splits, small D
        (50, 300, 6, torch.float32),  # D not a multiple of 4: element-wise tile loads
    ],
)
def test_ce_kernels_match_plain(cuda, n, v, d, dtype, with_bias):
    x, table, bias, lab, dnll, off, nv = _ce_case(n, v, d, dtype, with_bias, oov=True)
    before = _build.launch_counts()
    m, l = ce_stats(x, table, bias, off, nv)
    wm, wl = ce_stats_reference(x, table, bias, off, nv)
    logz, want_logz = m + torch.log(l), wm + torch.log(wl)
    torch.testing.assert_close(logz, want_logz, atol=1e-4, rtol=0)
    dx, dw, db = ce_backward(x, table, bias, lab, want_logz, dnll, off, nv)
    wdx, wdw, wdb = ce_backward_reference(x, table, bias, lab, want_logz, dnll, off, nv)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert after["ce_fwd"] == before["ce_fwd"] + 1 and after["ce_bwd"] == before["ce_bwd"] + 1
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    assert dx.dtype == dtype and dw.dtype == torch.float32
    _near(dx, wdx, rel)
    _near(dw, wdw, rel)
    if with_bias:
        _near(db, wdb, rel)
    else:
        assert db is None
    # blinded rows other than the OOV label's get exactly zero
    blinded = torch.ones(v, dtype=torch.bool, device=cuda)
    blinded[off : off + nv] = False
    blinded[lab[1].long()] = False
    assert (dw[blinded] == 0).all()


def test_fused_ce_op_on_card_matches_dense(cuda):
    """The autograd op on the card (both kernels) against the dense f32
    oracle: nll, and grads of x, table and bias; an OOV label gives ~1e30."""
    from bert4clickpath_torch.ops.fused_ce import dense_softmax_ce, fused_softmax_ce_bias

    rng = np.random.default_rng(4)
    n, v, d, off, nv = 300, 1024, 64, 10, 1000
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).cuda().requires_grad_()
    table = torch.from_numpy(rng.standard_normal((v, d), dtype=np.float32) * 0.3).cuda().requires_grad_()
    bias = torch.from_numpy(rng.standard_normal(v, dtype=np.float32)).cuda().requires_grad_()
    labels = torch.from_numpy(rng.integers(0, nv, size=n).astype(np.int32)).cuda()
    labels[::5] = LABEL_PAD
    nll = fused_softmax_ce_bias(x, table, bias, labels, off, nv)
    want = dense_softmax_ce(x, table, labels, off, nv, bias)
    torch.testing.assert_close(nll, want, atol=1e-4, rtol=1e-5)
    assert (nll[::5] == 0).all()
    got_g = torch.autograd.grad(nll.sum(), (x, table, bias))
    want_g = torch.autograd.grad(want.sum(), (x, table, bias))
    for g, w in zip(got_g, want_g):
        _near(g, w, 1e-4)
    labels[1] = nv + 3  # out of the catalog window
    assert fused_softmax_ce_bias(x, table, bias, labels, off, nv)[1].item() > 1e29


def test_cuda_tensors_never_take_a_plain_version(cuda, monkeypatch):
    """A train step of a small model on the card with every plain version
    made to fail: it runs, and every kernel launched."""
    from bert4clickpath_torch.ops.kernels import attention as attn_kernels
    from bert4clickpath_torch.ops.kernels import gather as gather_kernels

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor took a plain version")

    for mod, name in [
        (attn_kernels, "mha_reference"), (attn_kernels, "mha_backward_reference"),
        (ce_kernels, "ce_stats_reference"), (ce_kernels, "ce_backward_reference"),
        (gather_kernels, "gather_scale_pos_reference"),
    ]:
        monkeypatch.setattr(mod, name, refuse)
    model, state, step, batch = _small_train(cuda, dropout=0.1)
    _build.reset_launch_counts()
    state, loss = step(state, batch, torch.Generator(cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert _build.launch_counts() == {"gather": 1, "attention": 2, "attention_bwd": 2, "ce_fwd": 1, "ce_bwd": 1}


def _small_train(device, dropout=0.0, dtype="bfloat16"):
    from bert4clickpath_torch.config import FeatureConfig, HeadConfig, ModelConfig, TrainConfig
    from bert4clickpath_torch.data.generator import ClickStreamGenerator
    from bert4clickpath_torch.data.pipeline import ClozeDataset, to_device
    from bert4clickpath_torch.models.model import ClickstreamModel
    from bert4clickpath_torch.ops.fused_ce import padded_rows
    from bert4clickpath_torch.training import schedules
    from bert4clickpath_torch.training.train_state import TrainState, make_optimizer, make_train_step

    sys.path.insert(0, REPO)
    from chip_smoke import seeded_state_dict

    gen = ClickStreamGenerator(n_items=300, session_cohesiveness=200, seed=0)
    vocab = gen.item_vocab()
    cfg = ModelConfig(
        features={"items": FeatureConfig(padded_rows(vocab.model_vocab_size), 64)}, num_layers=2,
        num_heads=4, ffn_dim=128, dropout_rate=dropout, max_len=23,
        head=HeadConfig("tied_softmax", output_size=vocab.label_vocab_size), dtype=dtype, qkv_fused=True,
    )
    model = ClickstreamModel(cfg, device=device)
    model.load_state_dict(seeded_state_dict(cfg, 0))
    items, _ = gen.generate_sessions(64)
    host = next(ClozeDataset(items, vocab, max_items=20, backend="numpy").train_batches(16, seed=0))
    tx = make_optimizer(TrainConfig(), mu_dtype=torch.bfloat16)
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, tx, schedules.constant(1e-3), fused_ce_num_valid=vocab.label_vocab_size)
    return model, state, step, to_device(host, device)


def test_train_step_on_card_matches_cpu(cuda):
    """One step of a small bf16 model, dropout 0, from the same weights and
    batch on the card and on the CPU: loss abs 2e-2; every parameter's
    gradient within 2e-2 relative norm error (bf16 compute on both)."""
    from bert4clickpath_torch.training.train_state import make_loss_fn

    results = []
    for device in (cuda, torch.device("cpu")):
        model, state, _, batch = _small_train(device)
        loss = make_loss_fn(model, fused_ce_num_valid=model.config.head.output_size)(batch)
        grads = torch.autograd.grad(loss, list(state.params.values()))
        results.append((loss.item(), {k: g.cpu() for k, g in zip(state.params, grads)}))
    (gl, gg), (cl, cg) = results
    assert abs(gl - cl) <= 2e-2
    for k in cg:
        err = (gg[k] - cg[k]).norm() / cg[k].norm().clamp(min=1e-30)
        assert err <= 2e-2, (k, err.item())
