"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test asks the ``cuda`` fixture for a device and skips
where there is none. On a machine with a card (``--noconftest``: the
suite's conftest.py imports jax, which the port's machines need not have):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: attention forward bf16 abs 2e-2 (the
tensor-core kernel for heads up to 128: f32 sums in the mma's order, so a
p may round to the other bf16 neighbour), f32 abs 1e-5; attention backward bf16 abs 2e-2 + rel 2e-2 (one or two bf16 ulps of
an O(1) gradient: the tensor-core kernel sums p, dp and ds in the mma's
order with the fast exp, so ds may round the other way), f32 (the scalar
kernel) abs 1e-5 + rel 1e-4, two runs of either bit-equal; gather exact (both versions round
the same f32 value once). Fused CE: logz abs 1e-4 (f32 sums over the
catalog in another order); dx, dW and db within 1e-4 (f32 x) or 2e-2 (bf16
x) of the reference's largest magnitude (the merged backward's dx sums across
vocab tiles with atomics, in an order that varies run to run; bf16 x rounds
A, which may round the other way); the merged backward runs its products on
the tensor cores (f32 x as hi + lo tf32 terms, three products) and writes dW
and db once, so two runs of those give the same bits.
The two-pass CE backward: the same, but its dx sums in a fixed order, so two
runs give the same bits, and a bf16 dx may besides round its f32 sum the
other way (one bf16 ulp, 2^-7 of the value). Its dx and dW passes run on
the tensor cores (f32 x as hi + lo tf32 terms, three products) and are held
to the same f32 tolerance; the dW pass writes each dW row once (no
atomics), so two runs give the same bits; no CE kernel refuses a row width.
The CE entries take a row_start (a shard's first global row): on row
shards they are held against their plain versions given the same
row_start (which the plain versions apply to the row ids, the wrappers as
a shift of the window and the labels). That row_start = 0 keeps the bits
of the calls from before the argument existed is held across checkouts by
``examples/long_context/ce_kernel_turns.py``.
Blockwise attention: the running maximum the forward rounds p against, and
the order of the f32 sums, depend on the tile walk, so the bf16 forward
(tensor cores, 32 keys at a time, fast exp) is held to two bf16 ulps of the
reference (rel 2^-6) plus abs 2e-3, the f32 one to abs 1e-5. The gradients: f32 (scalar kernels) at the whole-row kernels'
tolerance; bf16 (tensor-core kernels, f32 sums in another order, fast exp)
at 2e-3 of the largest gradient plus two bf16 ulps of the plain value; the
fully padded row's relative to that row's largest gradient; two runs of
either give the same bits. Fused dropout:
bit-equal to its plain Philox version.
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
from bert4clickpath_torch.ops.kernels import attention as attn_kernels
from bert4clickpath_torch.ops.kernels import dropout as dropout_kernels
from bert4clickpath_torch.ops.kernels.attention import (
    blockwise_mha,
    blockwise_mha_backward,
    blockwise_mha_backward_reference,
    blockwise_mha_forward,
    blockwise_mha_reference,
    fused_mha,
    mha,
    mha_backward,
    mha_backward_reference,
    mha_reference,
)
from bert4clickpath_torch.ops.kernels.dropout import fused_dropout, fused_dropout_reference
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


MHA_FWD_SHAPES = [
    (1, 53, 256, 4),  # flagship serving, batch 1, 8 and 64
    (8, 53, 256, 4),
    (64, 53, 256, 4),
    (256, 53, 256, 4),  # the flagship's training shape
    (256, 53, 384, 6),  # the wide model's
    (256, 53, 128, 4),  # the large-catalog stress model's: Dh = 32
    # the edges of the 16-row warps, the query-row blocks and the 64-key passes
    (3, 1, 256, 4),
    (3, 17, 256, 4),
    (3, 64, 256, 4),
    (3, 65, 256, 4),  # two passes over the keys: the scores are recomputed
    (2, 116, 256, 4),
    (2, 417, 256, 4),  # the longest row the dispatch sends here at Dh = 64
    (3, 53, 64, 4),  # Dh = 16
    (3, 53, 128, 4),  # Dh = 32
    (3, 53, 512, 4),  # Dh = 128
    (3, 53, 100, 4),  # Dh = 25 in the 32-wide instance: plain-load fill
    (3, 53, 128, 2, "unaligned"),  # q, k, v one element into a wider tensor
]


@pytest.mark.parametrize("shape", MHA_FWD_SHAPES)
def test_mha_forward_tensor_core_kernel(cuda, shape):
    """bf16 heads up to 128 wide take the tensor-core forward: within abs
    2e-2 of the plain version (f32 sums in the mma's order, so a p may round
    to the other bf16 neighbour), a fully padded row included; two runs and
    contiguous inputs give the same bits as strided slices."""
    b, l, d, h = shape[:4]
    off = 1 if shape[4:] == ("unaligned",) else 0
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.standard_normal((b, l, 3 * d + 8 * off), dtype=np.float32)).to(cuda, torch.bfloat16)
    q, k, v = (qkv[..., off + i * d : off + (i + 1) * d] for i in range(3))
    bias = torch.from_numpy(np.where(rng.random((b, 1, 1, l)) < 0.3, -1e9, 0.0).astype(np.float32)).to(cuda)
    bias[0] = -1e9  # a fully padded row
    before = _build.launch_counts()["attention"]
    got = fused_mha(q, k, v, bias, h)
    assert _build.launch_counts()["attention"] == before + 1
    want = mha_reference(q, k, v, bias, h)
    again = fused_mha(q, k, v, bias, h)
    same = fused_mha(q.contiguous(), k.contiguous(), v.contiguous(), bias, h)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (b, l, d) and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)
    assert torch.equal(got, again), "two runs differ"
    assert torch.equal(got, same), "contiguous inputs give other bits than strided slices"


def test_mha_takes_what_one_block_cannot_hold(cuda):
    """The whole-row kernel names the dispatch for an L beyond one block;
    ``mha`` takes the blockwise kernel there and refuses no length."""
    x = torch.zeros(1, 4096, 64, device=cuda, dtype=torch.bfloat16)
    bias = torch.zeros(1, 1, 1, 4096, device=cuda)
    with pytest.raises(ValueError, match="blockwise_mha"):
        fused_mha(x, x, x, bias, 1)
    _build.reset_launch_counts()
    out = mha(x, x, x, bias, 1)
    torch.cuda.synchronize()
    assert out.shape == x.shape and (out == 0).all()
    counts = _build.launch_counts()
    assert counts["blockwise_fwd"] == 1 and counts["attention"] == 0


def _blockwise_case(shape, dtype, seed=5, kind="random"):
    """q, k, v (strided slices of one projection), bias, do on the card.
    ``random``: normal values, ragged padding, batch row 0 fully padded, row
    1 with a first key tile that is all padding. ``unaligned``: the same with
    q, k and v starting one element into a wider tensor, so no vector access
    is allowed. ``distinct``: no padding and a value pattern, exact in bf16,
    that no permutation of a tile's elements leaves in place."""
    b, l, d, h = shape
    rng = np.random.default_rng(seed)
    if kind == "distinct":
        at = np.arange(b * l * 3 * d, dtype=np.int64).reshape(b, l, 3 * d)
        qkv = torch.from_numpy((((at * 37) % 509 - 254) / 256).astype(np.float32)).to("cuda", dtype)
        at = np.arange(b * l * d, dtype=np.int64).reshape(b, l, d)
        do = torch.from_numpy((((at * 101) % 509 - 254) / 256).astype(np.float32)).to("cuda", dtype)
        return qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :], torch.zeros(b, 1, 1, l, device="cuda"), do
    off = 1 if kind == "unaligned" else 0
    qkv = torch.from_numpy(rng.standard_normal((b, l, 3 * d + 8 * off), dtype=np.float32)).to("cuda", dtype)
    q, k, v = (qkv[..., off + i * d : off + (i + 1) * d] for i in range(3))
    bias_np = np.zeros((b, 1, 1, l), np.float32)
    for i, n in enumerate(rng.integers(1, l + 1, size=b)):  # ragged padding
        bias_np[i, ..., n:] = -1e9
    bias_np[0] = -1e9  # a fully padded row
    if b > 1:
        bias_np[1, ..., : min(70, l - 1)] = -1e9  # a first key tile that is all padding
        bias_np[1, ..., l - 1] = 0.0
    do = torch.from_numpy(rng.standard_normal((b, l, d), dtype=np.float32)).to("cuda", dtype)
    return q, k, v, torch.from_numpy(bias_np).cuda(), do


BLOCKWISE_SHAPES = [
    (16, 1024, 256, 4),  # the long-session shape
    (2, 1000, 256, 4),  # no tile divides L
    (3, 200, 128, 2),
    (2, 77, 96, 1),  # Dh = 96 in the 128-wide instance
    (5, 13, 48, 4),  # Dh = 12
    (2, 130, 24, 4),  # Dh = 6: element-wise tile loads
    (1, 64, 16, 1, "distinct"),  # one tile, one k-step: the fragment layouts alone
    (2, 130, 512, 4),  # Dh = 128: three tiles, the third ragged
    (2, 300, 100, 4),  # Dh = 25 in the 32-wide instance, no 16-byte copies
    (2, 130, 128, 2, "unaligned"),  # q, k, v one element into a wider tensor
    # the edges of the tensor-core forward's 64-row blocks and 64-key tiles
    (2, 1, 64, 4),  # one query, one key
    (2, 63, 256, 4),  # one ragged tile; batch row 1 has one real key
    (2, 65, 256, 4),  # a second tile with one key, a second block with one row
    (3, 130, 384, 6),  # six heads
    (2, 200, 128, 1),  # one head of 128
    # the bf16 forward's persistent grid over more units than SMs: Dh = 32
    # with a ragged last stage, Dh = 16
    (16, 1000, 256, 8),
    (24, 300, 64, 4),
]


def _grads_held(name, g, w, dtype, padded_row=False):
    """f32: abs 1e-5 + rel 1e-4 (sums in another order), the fully padded
    row's relative to that row's largest gradient. bf16: the products
    run on the tensor cores with f32 sums in another order than the plain
    version's, and exp is the fast one, so a p, a ds or the gradient itself
    may round the other way: abs 2e-3 of the largest gradient plus two bf16
    ulps (2^-6) of the plain value. Measured on an NVIDIA H100 80GB HBM3 at
    (16, 1024, 256): the largest error is 1.5e-3 / 3.0e-3 / 2.3e-3 of the
    largest dq / dk / dv (one bf16 ulp of a value a quarter to half as
    large), 0.37 of this tolerance at most."""
    if dtype == torch.bfloat16:
        # a row with one real key has p = 1 and ds = dp - delta = 0 but for
        # the f32 sums' rounding (~1e-6): its gradients are noise, not values
        atol, rtol = 2e-3 * max(float(w.float().abs().max()), 1e-2), 2.0**-6
    else:
        atol, rtol = 1e-5 * (float(w.abs().max().clamp(min=1.0)) if padded_row else 1.0), 1e-4
    torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=rtol, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", BLOCKWISE_SHAPES)
def test_blockwise_kernels_match_plain(cuda, dtype, shape):
    b, l, d, h = shape[:4]
    kind = shape[4] if len(shape) > 4 else "random"
    q, k, v, bias, do = _blockwise_case(shape[:4], dtype, kind=kind)
    before = _build.launch_counts()
    out, lse = blockwise_mha_forward(q, k, v, bias, h)
    want, want_lse = blockwise_mha_reference(q, k, v, bias, h)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (b, l, d) and torch.isfinite(out).all()
    assert lse.dtype == torch.float32 and lse.shape == (b, l, h)
    atol, rtol = (2e-3, 2.0**-6) if dtype == torch.bfloat16 else (1e-5, 0.0)
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=rtol)
    # lse within 1e-5 relative: its fully padded rows sit at -1e9
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    got = blockwise_mha_backward(q, k, v, bias, want, want_lse, do, h)
    delta = attn_kernels.attention_delta(do, want, h)
    want_g = blockwise_mha_backward_reference(q, k, v, bias, want_lse, do, delta, h)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for name in ("blockwise_fwd", "blockwise_dq", "blockwise_dkv"):
        assert after[name] == before[name] + 1, name
    for name, g, w in zip(("dq", "dk", "dv"), got, want_g):
        assert g.dtype == dtype and g.shape == (b, l, d) and torch.isfinite(g).all(), name
        if kind == "distinct":
            _grads_held(name, g, w, dtype)
            continue
        # the fully padded row's p is exp(s - lse) at |lse| = 1e9: compared apart
        _grads_held(name, g[1:], w[1:], dtype)
        _grads_held(f"{name}, the fully padded row", g[0], w[0], dtype, padded_row=True)
    # one block owns its output rows and sums in a fixed order: a second run
    # gives the same bits
    again_g = blockwise_mha_backward(q, k, v, bias, want, want_lse, do, h)
    for name, g, g2 in zip(("dq", "dk", "dv"), got, again_g):
        assert torch.equal(g, g2), name
    # contiguous inputs give the same answer as strided slices
    again, _ = blockwise_mha_forward(q.contiguous(), k.contiguous(), v.contiguous(), bias, h)
    torch.testing.assert_close(again, out, atol=0, rtol=0)
    same = blockwise_mha_backward(q.contiguous(), k.contiguous(), v.contiguous(), bias, want, want_lse, do, h)
    for name, g, g2 in zip(("dq", "dk", "dv"), got, same):
        assert torch.equal(g, g2), name


def test_blockwise_autograd_on_card_matches_cpu(cuda):
    """``blockwise_mha`` under autograd on the card (three kernels) against
    the CPU plain versions, f32."""
    rng = np.random.default_rng(6)
    qkv = torch.from_numpy(rng.standard_normal((2, 150, 96), dtype=np.float32)).to(cuda).requires_grad_()
    bias = torch.zeros(2, 1, 1, 150, device=cuda)
    bias[1, ..., 100:] = -1e9
    _build.reset_launch_counts()
    blockwise_mha(qkv[..., :32], qkv[..., 32:64], qkv[..., 64:], bias, 2).square().sum().backward()
    counts = _build.launch_counts()
    assert (counts["blockwise_fwd"], counts["blockwise_dq"], counts["blockwise_dkv"]) == (1, 1, 1)
    assert counts["attention"] == 0 and counts["attention_bwd"] == 0
    ref = qkv.detach().cpu().requires_grad_()
    blockwise_mha(ref[..., :32], ref[..., 32:64], ref[..., 64:], bias.cpu(), 2).square().sum().backward()
    torch.testing.assert_close(qkv.grad.cpu(), ref.grad, atol=1e-4, rtol=1e-4)


def test_mha_dispatch_on_card(cuda):
    """``mha`` takes the whole-row kernels at L=53 and the blockwise ones
    where a gradient is needed at L=141 (forward alone: whole-row)."""
    def run(l, grad):
        x = torch.zeros(1, l, 256, device=cuda, dtype=torch.bfloat16, requires_grad=grad)
        _build.reset_launch_counts()
        out = mha(x, x, x, torch.zeros(1, 1, 1, l, device=cuda), 4)
        if grad:
            out.sum().backward()
        return {k: n for k, n in _build.launch_counts().items() if n}

    assert run(53, True) == {"attention": 1, "attention_bwd": 1}
    assert run(141, False) == {"attention": 1}
    assert run(141, True) == {"blockwise_fwd": 1, "blockwise_dq": 1, "blockwise_dkv": 1}
    assert run(1024, False) == {"blockwise_fwd": 1}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(16384, 256), (16, 1024, 256), (1000, 7), (3,), (8,), (1, 4099)])
def test_dropout_kernel_is_bit_equal_to_plain(cuda, dtype, shape):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(cuda, dtype)
    seed = torch.tensor([12345], dtype=torch.int32, device=cuda)
    before = _build.launch_counts()["dropout"]
    got = fused_dropout(x, seed, 0.1)
    assert _build.launch_counts()["dropout"] == before + 1
    want = fused_dropout_reference(x, seed, 0.1)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, want)
    if x.numel() >= 1000:
        assert not torch.equal(got, fused_dropout(x, seed + 1, 0.1))
    if x.numel() > 8:  # a view at an odd offset takes the element-wise path: same bits
        assert torch.equal(fused_dropout(x.reshape(-1)[1:], seed, 0.1), fused_dropout_reference(x.reshape(-1)[1:], seed, 0.1))


def test_dropout_backward_regenerates_the_mask_on_card(cuda):
    x = torch.randn(64, 1024, 256, device=cuda, dtype=torch.bfloat16).requires_grad_()
    seed = torch.tensor([7], dtype=torch.int32, device=cuda)
    _build.reset_launch_counts()
    y = fused_dropout(x, seed, 0.25)
    (dx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    assert _build.launch_counts()["dropout"] == 2
    nonzero_x = x != 0
    assert torch.equal((y != 0) & nonzero_x, (dx != 0) & nonzero_x)
    kept = dx[dx != 0].float()
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / 0.75), rtol=2.0**-8, atol=0)
    assert abs((dx != 0).float().mean().item() - 0.75) < 1e-3  # 16.8M draws: 4 sigma = 4.2e-4


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

    from bert4clickpath_torch.data.synthetic import seeded_state_dict

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
    assert _nonzero_counts() == {"gather": 1, "attention": 2}
    want = cpu.recommend(sessions, k=5)
    for g, w in zip(got, want):
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=2e-2, rtol=0)


def _nonzero_counts():
    return {k: n for k, n in _build.launch_counts().items() if n}


def _near(got, want, rel):
    """max |got - want| <= rel * max |want| (both widened to f32)."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= rel * scale, f"max abs err {err} > {rel} x {scale}"


MHA_BWD_SHAPES = [
    (256, 53, 256, 4),  # the flagship's training shape
    (5, 7, 32, 4),
    (3, 13, 96, 1),  # Dh = 96 in the 128-wide instance
    # the edges of the tensor-core kernel's 16-row blocks, 64-row chunks and passes
    (3, 1, 64, 1),
    (2, 15, 64, 4),  # Dh = 16
    (2, 16, 100, 4),  # Dh = 25 in the 32-wide instance: plain-load fill
    (2, 17, 256, 4),
    (256, 53, 384, 6),  # the wide model's training shape
    (256, 53, 128, 4),  # the large-catalog stress model's: Dh = 32
    (2, 64, 128, 2),
    (2, 65, 256, 4),  # two passes over the keys: the scores are recomputed
    (2, 116, 256, 4),  # the longest row the dispatch sends here at Dh = 64
    (2, 80, 128, 1),  # one head of 128
    (2, 140, 64, 4),  # three 64-row chunks at Dh = 16
    (2, 53, 128, 2, "unaligned"),  # q, k, v one element into a wider tensor
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", MHA_BWD_SHAPES)
def test_mha_backward_kernel_matches_plain(cuda, dtype, shape):
    """bf16 (head width up to 128): the tensor-core kernel, whose f32 sums
    run in the mma's order with the fast exp, so a ds or a gradient may round
    to the other neighbour; measured on an NVIDIA H100 80GB HBM3 at
    (256, 53, 256): see PERF.md. f32: the scalar kernel. Two runs of either
    give the same bits."""
    b, l, d, h = shape[:4]
    off = 1 if shape[4:] == ("unaligned",) else 0
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((b, l, 3 * d + 8 * off), dtype=np.float32)).to(cuda, dtype)
    q, k, v = (qkv[..., off + i * d : off + (i + 1) * d] for i in range(3))  # slices of one projection
    do = torch.from_numpy(rng.standard_normal((b, l, d), dtype=np.float32)).to(cuda, dtype)
    bias = torch.from_numpy(np.where(rng.random((b, 1, 1, l)) < 0.3, -1e9, 0.0).astype(np.float32)).to(cuda)
    bias[0] = -1e9  # a fully padded row
    bias[1] = -1e9
    bias[1, ..., l // 2] = 0.0  # a row with one real key
    before = _build.launch_counts()["attention_bwd"]
    got = mha_backward(q, k, v, bias, do, h)
    assert _build.launch_counts()["attention_bwd"] == before + 1
    want = mha_backward_reference(q, k, v, bias, do, h)
    again = mha_backward(q, k, v, bias, do, h)
    same = mha_backward(q.contiguous(), k.contiguous(), v.contiguous(), bias, do, h)
    torch.cuda.synchronize()
    atol, rtol = (2e-2, 2e-2) if dtype == torch.bfloat16 else (1e-5, 1e-4)
    for name, g, w, g2, g3 in zip(("dq", "dk", "dv"), got, want, again, same):
        assert g.dtype == dtype and g.shape == (b, l, d) and torch.isfinite(g).all(), name
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=rtol, msg=lambda m: f"{name}: {m}")
        assert torch.equal(g, g2), f"{name}: two runs differ"
        assert torch.equal(g, g3), f"{name}: contiguous inputs give other bits than strided slices"


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


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize(
    "n,v,d,dtype",
    [
        (2560, 55_296, 384, torch.float32),  # the wide model's CE shape
        (100, 128, 32, torch.float32),  # N off the 64-row tile, V one tile pair, D below one chunk
        (77, 1000, 450, torch.bfloat16),  # ragged V, D not a multiple of 4 nor of a chunk, two D splits
        (64, 2100, 512, torch.float32),  # past the forward's limit: the backward alone
        (50, 300, 6, torch.float32),  # element-wise tile loads
        (130, 700, 713, torch.bfloat16),  # the widest row the pair takes
    ],
)
def test_ce_two_pass_kernels_match_plain(cuda, n, v, d, dtype, with_bias):
    x, table, bias, lab, dnll, off, nv = _ce_case(n, v, d, dtype, with_bias, oov=True)
    wm, wl = ce_stats_reference(x, table, bias, off, nv)
    logz = wm + torch.log(wl)
    m, l = ce_stats(x, table, bias, off, nv)  # the forward at wide rows too
    torch.testing.assert_close(m + torch.log(l), logz, atol=1e-4, rtol=0)
    args = (x, table, bias, lab, logz, dnll, off, nv)
    before = _build.launch_counts()
    dx, dw, db = ce_kernels.ce_backward_two_pass(*args)
    again = ce_kernels.ce_backward_dx(*args)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert after["ce_bwd_dx"] == before["ce_bwd_dx"] + 2 and after["ce_bwd_dw"] == before["ce_bwd_dw"] + 1
    assert after["ce_bwd"] == before["ce_bwd"]
    wdx = ce_kernels.ce_backward_dx_reference(*args)
    wdw, wdb = ce_kernels.ce_backward_dw_reference(*args)
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    assert dx.dtype == dtype and dw.dtype == torch.float32
    assert torch.equal(dx, again)  # a fixed order of sums
    if dtype == torch.float32:
        _near(dx, wdx, rel)
    else:
        diff = (dx.float() - wdx.float()).abs()
        assert bool((diff <= rel * wdx.float().abs().max() + 2.0**-7 * wdx.float().abs()).all())
    _near(dw, wdw, rel)
    if with_bias:
        _near(db, wdb, rel)
    else:
        assert db is None and wdb is None
    blinded = torch.ones(v, dtype=torch.bool, device=cuda)
    blinded[off : off + nv] = False
    blinded[lab[1].long()] = False
    assert (dw[blinded] == 0).all()


def test_ce_kernels_name_their_widest_row(cuda):
    """D = 384 goes through the forward and, by its shape alone, through the
    two-pass backward; D = 256 through the merged one. Only the merged
    kernel has a width limit (its register tile, D <= 256), which it names;
    every wider row takes the pair, which refuses none."""
    for d, route in ((384, "two_pass"), (256, "merged"), (454, "two_pass"), (714, "two_pass"), (1024, "two_pass")):
        x, table, bias, lab, dnll, off, nv = _ce_case(70, 500, d, torch.float32, False)
        m, l = ce_stats(x, table, None, off, nv)
        _build.reset_launch_counts()
        ce_backward(x, table, None, lab, m + torch.log(l), dnll, off, nv)
        want = {"ce_bwd": 1} if route == "merged" else {"ce_bwd_dx": 1, "ce_bwd_dw": 1}
        assert _nonzero_counts() == want and ce_kernels.ce_backward_route(d) == route
    x, table, _, lab, dnll, off, nv = _ce_case(70, 500, 257, torch.float32, False)
    with pytest.raises(ValueError, match="D <= 256"):
        ce_kernels.ce_backward_merged(x, table, None, lab, dnll, dnll, off, nv)


def _logz_f64(x, table, bias, off, nv):
    """logz of x . round_to_x(table)^T (+ bias) over the window [off, off +
    nv), in f64, 256 rows at a time: the forward's oracle, so that the plain
    version's own f32 sums (cuBLAS) do not count against the kernel."""
    w = table.to(x.dtype).double()
    out = []
    for r0 in range(0, x.shape[0], 256):
        s = x[r0 : r0 + 256].double() @ w[off : off + nv].T
        if bias is not None:
            s = s + bias[off : off + nv].double()
        out.append(torch.logsumexp(s, dim=1))
    return torch.cat(out)


def _check_fwd(x, table, bias, off, nv):
    """Two calls of the forward: one ce_fwd launch each and no other, the
    same bits (nothing is atomic), m and l finite of shape (N,), and logz =
    m + log(l) within abs 1e-4 of the f64 oracle (CE_LOGZ_TOL; the f32 x
    products run as three tf32 ones, bf16 x as one exact bf16 product)."""
    runs = []
    for _ in range(2):
        _build.reset_launch_counts()
        runs.append(ce_stats(x, table, bias, off, nv))
        torch.cuda.synchronize()
        assert _nonzero_counts() == {"ce_fwd": 1}
    (m, l), (m2, l2) = runs
    assert m.shape == l.shape == (x.shape[0],) and m.dtype == l.dtype == torch.float32
    assert torch.equal(m, m2) and torch.equal(l, l2), "two runs differ"
    logz = m + torch.log(l)
    assert torch.isfinite(logz).all()
    torch.testing.assert_close(logz.double(), _logz_f64(x, table, bias, off, nv), atol=1e-4, rtol=0)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "n,v,d",
    [
        (2560, 55_296, 256),  # the flagship's CE shape
        (2560, 55_296, 384),  # the wide model's
        (160, 20_480, 256),  # the long-session path's: 2 row tiles, the units split by V
        (130, 1000, 6),  # N off the 128-row tile, ragged V, D not a multiple of 4: padded through a copy
        (77, 700, 512),  # D a whole number of 32-column stages
        (77, 700, 513),  # one column past it: the last stage zero-filled but one column
        (64, 300, 1344),  # a wide row: 42 stages a vocab tile
    ],
)
def test_ce_forward_tensor_cores(cuda, n, v, d, dtype, with_bias):
    """The TMA + wgmma forward at the three main paths' CE shapes and
    around its tile and stage edges, f32 and bf16 x, with and without a
    bias: see _check_fwd."""
    x, table, bias, _, _, off, nv = _ce_case(n, v, d, dtype, with_bias, seed=d + n)
    _check_fwd(x, table, bias, off, nv)


@pytest.mark.parametrize("with_bias", [False, True])
def test_ce_forward_at_wide_logits(cuda, with_bias):
    """f32 x at D = 1,024 over a table of N(0, 0.5^2): logits of ~16 (the
    spread at which three bf16 products missed 1e-4, PERF.md): see _check_fwd (the f64 oracle; the plain version's own
    f32 sums move logz by ~1e-4 here)."""
    x, table, bias, _, _, off, nv = _ce_case(130, 700, 1024, torch.float32, with_bias, seed=41)
    _check_fwd(x, table, bias, off, nv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ce_forward_split_all_blinded(cuda, dtype):
    """A vocab split whose every row lies outside the window (the window
    ends 10 rows before the last split of 2,560 rows starts): its partial
    (m, l) is (-1e30, rows) and the combine weighs it by exp(-1e30 - m) =
    0. A bias is added before the blinding. See _check_fwd."""
    n, v, off = 130, 2560, 10
    splits, per = ce_kernels.ce_splits(n, v)
    assert splits > 1
    nv = (splits - 1) * per * ce_kernels.FWD_VOCAB - off - 10
    x, table, bias, _, _, _, _ = _ce_case(n, v, 64, dtype, True, seed=17)
    _check_fwd(x, table, bias, off, nv)


def _check_merged(args, dtype, cuda):
    """Two calls of the merged backward against its plain version: one
    ce_bwd launch each and no other; dx, dW and db within 1e-4 (f32 x) or
    2e-2 (bf16 x) of the largest magnitude; dW and db bit-equal over the
    two calls; dx summed across vocab tiles with atomic adds, so each
    call's dx is held to the tolerance alone (bf16 dx may besides round its
    f32 sum the other way: one bf16 ulp, 2^-7 of the value); blinded rows
    but the OOV label's get exactly zero dW."""
    x, table, bias, lab, _, _, off, nv = args
    n, d = x.shape
    v = table.shape[0]
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    wdx, wdw, wdb = ce_backward_reference(*args)
    runs = []
    for _ in range(2):
        _build.reset_launch_counts()
        runs.append(ce_kernels.ce_backward_merged(*args))
        torch.cuda.synchronize()
        assert _nonzero_counts() == {"ce_bwd": 1}
    (dx, dw, db), (dx2, dw2, db2) = runs
    assert dx.dtype == dtype and dx.shape == (n, d) and dw.shape == (v, d)
    assert torch.isfinite(dx).all() and torch.isfinite(dw).all()
    assert torch.equal(dw, dw2), "two runs of dW differ"
    for got in (dx, dx2):
        diff = (got.float() - wdx.float()).abs()
        elem = 0.0 if dtype == torch.float32 else 2.0**-7
        assert bool((diff <= rel * wdx.float().abs().max() + elem * wdx.float().abs()).all())
    _near(dw, wdw, rel)
    if bias is None:
        assert db is None and db2 is None
    else:
        assert db.shape == (v,) and torch.equal(db, db2), "two runs of db differ"
        _near(db, wdb, rel)
    blinded = torch.ones(v, dtype=torch.bool, device=cuda)
    blinded[off : off + nv] = False
    blinded[lab[1].long()] = False
    assert (dw[blinded] == 0).all()


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 72, 200, 256])
def test_ce_merged_backward_at_its_widths(cuda, d, dtype, with_bias):
    """The tensor-core merged backward at widths around its 64-column
    chunks up to its limit (D = 8, 72, 200, 256), N = 130 rows (off the
    64-row tile) over a ragged V = 700, LABEL_PAD rows and an OOV label:
    see _check_merged."""
    x, table, bias, lab, dnll, off, nv = _ce_case(130, 700, d, dtype, with_bias, seed=d + 3, oov=True)
    wm, wl = ce_stats_reference(x, table, bias, off, nv)
    _check_merged((x, table, bias, lab, wm + torch.log(wl), dnll, off, nv), dtype, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ce_merged_backward_skips_a_zero_row_tile(cuda, dtype):
    """A tile of 64 rows of x whose dnll is all zero, between two live
    ones, makes A zero there and the kernel skips that tile's dW and dx
    products: N = 200 over a ragged V = 1,000, D = 256, with a bias; see
    _check_merged (dx of the skipped rows exactly 0)."""
    x, table, bias, lab, dnll, off, nv = _ce_case(200, 1000, 256, dtype, True, seed=7, oov=True)
    dnll[64:128] = 0.0
    wm, wl = ce_stats_reference(x, table, bias, off, nv)
    args = (x, table, bias, lab, wm + torch.log(wl), dnll, off, nv)
    _check_merged(args, dtype, cuda)
    assert (ce_kernels.ce_backward_merged(*args)[0][64:128] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ce_merged_backward_walks_only_live_rows(cuda, dtype):
    """The merged backward walks only the rows whose dnll is nonzero: with
    every dnll 0 it walks none, and dx, dW and db are exactly 0; with one
    live row among 130 it matches the plain version (see _check_merged)."""
    x, table, bias, lab, dnll, off, nv = _ce_case(130, 700, 200, dtype, True, seed=13, oov=True)
    wm, wl = ce_stats_reference(x, table, bias, off, nv)
    zero = torch.zeros_like(dnll)
    dx, dw, db = ce_kernels.ce_backward_merged(x, table, bias, lab, wm + torch.log(wl), zero, off, nv)
    torch.cuda.synchronize()
    assert not dx.any() and not dw.any() and not db.any()
    one = zero.clone()
    one[77] = 0.5
    _check_merged((x, table, bias, lab, wm + torch.log(wl), one, off, nv), dtype, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "n,pattern", [(1023, "random"), (1024, "random"), (1025, "random"), (2560, "random"), (3000, "all"),
                  (3000, "ends")])
def test_ce_merged_backward_packs_exactly_the_live_rows(cuda, n, pattern, dtype):
    """The C entry lists the rows whose dnll is nonzero (ce_live_rows_kernel,
    in turns of 1,024 rows), packs them and scatters dx back: N rows across
    those turns, the others LABEL_PAD with dnll 0 (a fifth of them at
    random, none, or all but rows 0, 1 and N - 1); the LABEL_PAD rows' dx
    is exactly 0 and the rest matches the plain version, as dW and db do
    (see _check_merged)."""
    x, table, bias, lab, dnll, off, nv = _ce_case(n, 300, 128, dtype, True, seed=n + 5, oov=True)
    rng = np.random.default_rng(n)
    keep = {"random": rng.random(n) >= 0.2, "all": np.ones(n, bool),
            "ends": np.isin(np.arange(n), (0, 1, n - 1))}[pattern]
    keep[1] = True  # the OOV label's row, which _check_merged reads
    keep = torch.from_numpy(keep).cuda()
    lab = torch.where(keep, lab.clamp(min=off), torch.full_like(lab, LABEL_PAD))
    dnll = torch.where(keep, dnll + 1.0 / n, torch.zeros_like(dnll))
    wm, wl = ce_stats_reference(x, table, bias, off, nv)
    args = (x, table, bias, lab, wm + torch.log(wl), dnll, off, nv)
    _check_merged(args, dtype, cuda)
    dx = ce_kernels.ce_backward_merged(*args)[0]
    assert not dx[~keep].any() and bool(dx[keep].abs().amax(dim=1).gt(0).all())


def test_ce_merged_backward_at_wide_logits(cuda):
    """f32 x at D = 256 over a table of N(0, 1): logits of ~16, the spread
    at which three bf16 products missed 1e-4 at D = 1,024 (PERF.md, the dx
    numerics decision). The shipped tf32 x3 holds 1e-4 of the largest
    magnitude here too; see _check_merged."""
    x, table, bias, lab, dnll, off, nv = _ce_case(130, 700, 256, torch.float32, True, seed=11, oov=True)
    table = table * 2.0
    wm, wl = ce_stats_reference(x, table, bias, off, nv)
    _check_merged((x, table, bias, lab, wm + torch.log(wl), dnll, off, nv), torch.float32, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ce_merged_backward_dx_repeats_within_its_bound(cuda, dtype):
    """The merged backward sums dx across blocks with atomic adds, kept on
    purpose (ROADMAP.md, Queue 3: they cost 4% of its time), so dx repeats
    to rounding, not bit for bit. Two runs at the flagship's CE shape (N =
    2,560, V = 55,296, D = 256, with a bias) differ by at most 1e-5 of the
    largest |dx| (a tenth of the tolerance that holds dx against the plain
    version; each element sums 864 vocab tiles' f32 partials in an order
    that varies; 2.3e-7 measured on an H100); a bf16 dx, each run rounding
    its own f32 sum once, besides by one bf16 ulp of each value (2^-7 of
    it). dW and db are bit-equal."""
    x, table, bias, lab, dnll, off, nv = _ce_case(2560, 55_296, 256, dtype, True, seed=23)
    wm, wl = ce_stats_reference(x, table, bias, off, nv)
    args = (x, table, bias, lab, wm + torch.log(wl), dnll, off, nv)
    (dx, dw, db), (dx2, dw2, db2) = (ce_kernels.ce_backward_merged(*args) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    gap = (dx.float() - dx2.float()).abs()
    elem = 0.0 if dtype == torch.float32 else 2.0**-7
    assert bool((gap <= 1e-5 * dx.float().abs().max() + elem * dx.float().abs()).all()), gap.max().item()


def _shard_case(d, dtype, with_bias, shards=4, v=4096, n=300, seed=31):
    """A table cut into row shards: the window starts in the first shard
    and ends inside the last (a boundary tile there), the labels global, so
    most of each shard's rows' labels lie on other shards."""
    x, table, bias, lab, dnll, off, nv = _ce_case(n, v, d, dtype, with_bias, seed=seed, row_offset=10)
    nv = v - off - 100  # ends mid-tile in the last shard
    lab = torch.where(lab >= off + nv, off + nv - 1, lab)
    wm, wl = ce_stats_reference(x, table, bias, off, nv)
    return x, table, bias, lab, dnll, off, nv, wm + torch.log(wl), v // shards


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("entry", ["fwd", "merged", "dx", "dw"])
def test_ce_entries_with_row_start_match_plain(cuda, entry, dtype, with_bias):
    """Each CE entry on each of 4 row shards with its row_start (the
    vocab-sharded tier's call) against its plain version given the same
    row_start, at the kernels' tolerances: the forward's (m, l) logz at abs
    1e-4, the gradients within 1e-4 (f32 x) or 2e-2 (bf16 x) of the plain
    version's largest. D = 64 for the merged kernel, 384 for the pair."""
    d = 64 if entry in ("fwd", "merged") else 384
    x, table, bias, lab, dnll, off, nv, logz, v_local = _shard_case(d, dtype, with_bias)
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for s in range(4):
        lo = s * v_local
        tb, bb = table[lo : lo + v_local], None if bias is None else bias[lo : lo + v_local]
        if entry == "fwd":
            m, l = ce_stats(x, tb, bb, off, nv, row_start=lo)
            wm, wl = ce_stats_reference(x, tb, bb, off, nv, row_start=lo)
            torch.testing.assert_close(m + torch.log(l), wm + torch.log(wl), atol=1e-4, rtol=0)
            continue
        args = (x, tb, bb, lab, logz, dnll, off, nv, lo)
        if entry == "merged":
            got, want = ce_kernels.ce_backward_merged(*args), ce_backward_reference(*args)
        elif entry == "dx":
            got, want = (ce_kernels.ce_backward_dx(*args),), (ce_kernels.ce_backward_dx_reference(*args),)
        else:
            got, want = ce_kernels.ce_backward_dw(*args), ce_kernels.ce_backward_dw_reference(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            elif entry == "dx" and dtype == torch.bfloat16:
                diff = (g.float() - w.float()).abs()
                assert bool((diff <= rel * w.float().abs().max() + 2.0**-7 * w.float().abs()).all())
            else:
                _near(g, w, rel)


DX_WIDTHS = [6, 32, 256, 384, 450, 713, 714, 1024]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", DX_WIDTHS)
def test_ce_dx_pass_at_any_width(cuda, d, dtype):
    """The tensor-core dx pass at widths around every chunk and tile edge
    (x resident in shared memory up to D = 384 in f32, streamed above; D
    split over the grid above 384), with and without a bias, an OOV label:
    f32 within 1e-4 of the largest |dx|, bf16 within 2e-2 of it plus one
    bf16 ulp of each value, two runs bit-equal."""
    for with_bias in (False, True):
        x, table, bias, lab, dnll, off, nv = _ce_case(130, 700, d, dtype, with_bias, seed=d, oov=True)
        wm, wl = ce_stats_reference(x, table, bias, off, nv)
        args = (x, table, bias, lab, wm + torch.log(wl), dnll, off, nv)
        before = _build.launch_counts()["ce_bwd_dx"]
        dx = ce_kernels.ce_backward_dx(*args)
        again = ce_kernels.ce_backward_dx(*args)
        assert _build.launch_counts()["ce_bwd_dx"] == before + 2
        want = ce_kernels.ce_backward_dx_reference(*args)
        torch.cuda.synchronize()
        assert dx.dtype == dtype and dx.shape == (130, d) and torch.isfinite(dx).all()
        assert torch.equal(dx, again), "two runs differ"
        if dtype == torch.float32:
            _near(dx, want, 1e-4)
        else:
            diff = (dx.float() - want.float()).abs()
            assert bool((diff <= 2e-2 * want.float().abs().max() + 2.0**-7 * want.float().abs()).all())


def _check_dw(args, dtype, cuda):
    """Two runs of the dW pass against its plain version: dW and db within
    1e-4 (f32 x) or 2e-2 (bf16 x) of the largest magnitude, bit-equal to
    each other, blinded rows but the OOV label's exactly 0."""
    x, table, bias, lab, _, _, off, nv = args
    v, d = table.shape
    before = _build.launch_counts()["ce_bwd_dw"]
    dw, db = ce_kernels.ce_backward_dw(*args)
    dw2, db2 = ce_kernels.ce_backward_dw(*args)
    assert _build.launch_counts()["ce_bwd_dw"] == before + 2
    wdw, wdb = ce_kernels.ce_backward_dw_reference(*args)
    torch.cuda.synchronize()
    assert dw.dtype == torch.float32 and dw.shape == (v, d) and torch.isfinite(dw).all()
    assert torch.equal(dw, dw2), "two runs differ"
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    _near(dw, wdw, rel)
    if bias is None:
        assert db is None and db2 is None
    else:
        assert db.shape == (v,) and torch.equal(db, db2), "two runs of db differ"
        _near(db, wdb, rel)
    blinded = torch.ones(v, dtype=torch.bool, device=cuda)
    blinded[off : off + nv] = False
    blinded[lab[1].long()] = False
    assert (dw[blinded] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", DX_WIDTHS)
def test_ce_dw_pass_at_any_width(cuda, d, dtype):
    """The tensor-core dW pass at widths around every chunk and tile edge
    (the table rows resident in shared memory up to D = 384 in f32, streamed
    above; D split over the grid above 384), N = 130 rows (off the 64-row
    tile) over a ragged V = 700, with and without a bias, an OOV label:
    see _check_dw."""
    for with_bias in (False, True):
        x, table, bias, lab, dnll, off, nv = _ce_case(130, 700, d, dtype, with_bias, seed=d + 2, oov=True)
        wm, wl = ce_stats_reference(x, table, bias, off, nv)
        _check_dw((x, table, bias, lab, wm + torch.log(wl), dnll, off, nv), dtype, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ce_dw_pass_skips_a_zero_row_tile(cuda, dtype):
    """A tile of 64 rows of x whose dnll is all zero, between two live
    ones, makes A^T zero there and the kernel skips that tile's product:
    N = 200 over a ragged V = 1,000, D = 384, with a bias; see _check_dw."""
    x, table, bias, lab, dnll, off, nv = _ce_case(200, 1000, 384, dtype, True, seed=5, oov=True)
    dnll[64:128] = 0.0
    wm, wl = ce_stats_reference(x, table, bias, off, nv)
    _check_dw((x, table, bias, lab, wm + torch.log(wl), dnll, off, nv), dtype, cuda)


@pytest.mark.parametrize("d", [454, 714, 1024])
def test_ce_forward_and_dw_at_wide_rows(cuda, d):
    """The forward and the dW pass past the widths their whole tiles held
    (the dW pass streams its table rows above D = 384 in f32; the forward
    streams every D): logz abs 1e-4 plus 4e-6 of |logz| (logits reach ~60 at D =
    1,024, where f32 sums in another order move logz by a few tens of its
    ulps: 1.1e-4 measured on an H100), dW and db 1e-4 of the largest
    magnitude (f32 x) or 2e-2 (bf16 x)."""
    for dtype, with_bias in ((torch.float32, True), (torch.bfloat16, False)):
        x, table, bias, lab, dnll, off, nv = _ce_case(130, 700, d, dtype, with_bias, seed=d + 1, oov=True)
        m, l = ce_stats(x, table, bias, off, nv)
        wm, wl = ce_stats_reference(x, table, bias, off, nv)
        torch.testing.assert_close(m + torch.log(l), wm + torch.log(wl), atol=1e-4, rtol=4e-6)
        args = (x, table, bias, lab, wm + torch.log(wl), dnll, off, nv)
        dw, db = ce_kernels.ce_backward_dw(*args)
        wdw, wdb = ce_kernels.ce_backward_dw_reference(*args)
        torch.cuda.synchronize()
        rel = 1e-4 if dtype == torch.float32 else 2e-2
        _near(dw, wdw, rel)
        if with_bias:
            _near(db, wdb, rel)
        blinded = torch.ones(700, dtype=torch.bool, device=cuda)
        blinded[off : off + nv] = False
        blinded[lab[1].long()] = False
        assert (dw[blinded] == 0).all()


def test_fused_ce_op_at_a_wide_row_on_card(cuda):
    """fused_softmax_ce with gradients at D = 1,024 on the card against the
    dense f32 oracle: nll abs 1e-4, gradients 1e-4 of the largest."""
    from bert4clickpath_torch.ops.fused_ce import dense_softmax_ce, fused_softmax_ce

    rng = np.random.default_rng(6)
    n, v, d, off, nv = 200, 900, 1024, 10, 850
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).cuda().requires_grad_()
    table = torch.from_numpy(rng.standard_normal((v, d), dtype=np.float32) * 0.05).cuda().requires_grad_()
    labels = torch.from_numpy(rng.integers(0, nv, size=n).astype(np.int32)).cuda()
    labels[::5] = LABEL_PAD
    _build.reset_launch_counts()
    nll = fused_softmax_ce(x, table, labels, off, nv)
    got = torch.autograd.grad(nll.sum(), (x, table))
    assert _nonzero_counts() == {"ce_fwd": 1, "ce_bwd_dx": 1, "ce_bwd_dw": 1}
    want = dense_softmax_ce(x, table, labels, off, nv)
    torch.testing.assert_close(nll, want, atol=1e-4, rtol=1e-5)
    for g, w in zip(got, torch.autograd.grad(want.sum(), (x, table))):
        _near(g, w, 1e-4)


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
    from bert4clickpath_torch.ops.kernels import gather as gather_kernels

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor took a plain version")

    for mod, name in [
        (attn_kernels, "mha_reference"), (attn_kernels, "mha_backward_reference"),
        (ce_kernels, "ce_stats_reference"), (ce_kernels, "ce_backward_reference"),
        (ce_kernels, "ce_backward_dx_reference"), (ce_kernels, "ce_backward_dw_reference"),
        (gather_kernels, "gather_scale_pos_reference"),
        (attn_kernels, "blockwise_mha_reference"), (attn_kernels, "blockwise_dq_reference"),
        (attn_kernels, "blockwise_dkv_reference"),
        (dropout_kernels, "fused_dropout_reference"), (dropout_kernels, "dropout_bits"),
    ]:
        monkeypatch.setattr(mod, name, refuse)
    model, state, step, batch = _small_train(cuda, dropout=0.1)
    _build.reset_launch_counts()
    state, loss = step(state, batch, torch.Generator(cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert _nonzero_counts() == {"gather": 1, "attention": 2, "attention_bwd": 2, "ce_fwd": 1, "ce_bwd": 1}
    # a model wider than the merged CE backward holds: the two-pass pair
    model, state, step, batch = _small_train(cuda, dropout=0.1, d_model=320, heads=5)
    _build.reset_launch_counts()
    state, loss = step(state, batch, torch.Generator(cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert _nonzero_counts() == {"gather": 1, "attention": 2, "attention_bwd": 2, "ce_fwd": 1,
                                 "ce_bwd_dx": 1, "ce_bwd_dw": 1}
    # the long-session families: blockwise attention and the dropout kernel
    # at its five sites (encoder input, 2 per layer), forward and backward
    monkeypatch.setattr(attn_kernels, "attention_family", lambda *a: "blockwise")
    model, state, step, batch = _small_train(cuda, dropout=0.1, dropout_impl="fused")
    _build.reset_launch_counts()
    state, loss = step(state, batch, torch.Generator(cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert _nonzero_counts() == {
        "gather": 1, "blockwise_fwd": 2, "blockwise_dq": 2, "blockwise_dkv": 2,
        "dropout": 10, "ce_fwd": 1, "ce_bwd": 1,
    }


def _small_train(device, dropout=0.0, dtype="bfloat16", dropout_impl="mask", d_model=64, heads=4):
    from bert4clickpath_torch.config import FeatureConfig, HeadConfig, ModelConfig, TrainConfig
    from bert4clickpath_torch.data.generator import ClickStreamGenerator
    from bert4clickpath_torch.data.pipeline import ClozeDataset, to_device
    from bert4clickpath_torch.models.model import ClickstreamModel
    from bert4clickpath_torch.ops.fused_ce import padded_rows
    from bert4clickpath_torch.training import schedules
    from bert4clickpath_torch.training.train_state import TrainState, make_optimizer, make_train_step

    from bert4clickpath_torch.data.synthetic import seeded_state_dict

    gen = ClickStreamGenerator(n_items=300, session_cohesiveness=200, seed=0)
    vocab = gen.item_vocab()
    cfg = ModelConfig(
        features={"items": FeatureConfig(padded_rows(vocab.model_vocab_size), d_model)}, num_layers=2,
        num_heads=heads, ffn_dim=2 * d_model, dropout_rate=dropout, max_len=23,
        head=HeadConfig("tied_softmax", output_size=vocab.label_vocab_size), dtype=dtype, qkv_fused=True,
    )
    model = ClickstreamModel(cfg, device=device, dropout_impl=dropout_impl)
    model.load_state_dict(seeded_state_dict(cfg, 0))
    items, _ = gen.generate_sessions(64)
    host = next(ClozeDataset(items, vocab, max_items=20, backend="numpy").train_batches(16, seed=0))
    tx = make_optimizer(TrainConfig(), mu_dtype=torch.bfloat16)
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, tx, schedules.constant(1e-3), fused_ce_num_valid=vocab.label_vocab_size)
    return model, state, step, to_device(host, device)


@pytest.mark.parametrize("d_model,heads", [(64, 4), (320, 5)])  # the merged CE backward, the two-pass pair
def test_train_step_on_card_matches_cpu(cuda, d_model, heads):
    """One step of a small bf16 model, dropout 0, from the same weights and
    batch on the card and on the CPU: loss abs 2e-2; every parameter's
    gradient within 2e-2 relative norm error (bf16 compute on both)."""
    from bert4clickpath_torch.training.train_state import make_loss_fn

    results = []
    for device in (cuda, torch.device("cpu")):
        model, state, _, batch = _small_train(device, d_model=d_model, heads=heads)
        loss = make_loss_fn(model, fused_ce_num_valid=model.config.head.output_size)(batch)
        grads = torch.autograd.grad(loss, list(state.params.values()))
        results.append((loss.item(), {k: g.cpu() for k, g in zip(state.params, grads)}))
    (gl, gg), (cl, cg) = results
    assert abs(gl - cl) <= 2e-2
    for k in cg:
        err = (gg[k] - cg[k]).norm() / cg[k].norm().clamp(min=1e-30)
        assert err <= 2e-2, (k, err.item())


def _chained_bias(b, rng, device):
    """The padding bias of chained rows ``[CLS][SEP] history [SEP] basket
    [SEP]`` (history 41, basket 8: L=53), each segment's pads before its
    [SEP]: pads inside the sequence."""
    from bert4clickpath_torch.constants import PAD_ID
    from bert4clickpath_torch.data.chaining import chain_sequences
    from bert4clickpath_torch.ops.masking import padding_bias

    segs = []
    for width in (41, 8):
        seg = np.full((b, width), PAD_ID, np.int32)
        for i, n in enumerate(rng.integers(0, width + 1, size=b)):
            seg[i, :n] = rng.integers(10, 1000, size=n)
        segs.append(seg)
    return padding_bias(torch.from_numpy(chain_sequences(segs)).to(device))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(256, 4, 256), (7, 2, 64)])
def test_mha_kernels_with_interior_pads(cuda, dtype, shape):
    """The whole-row forward and backward on chained rows (pads before each
    [SEP], not only at the end) against their plain versions, at the
    tolerances of the tests above; two runs bit-equal."""
    b, h, d = shape
    rng = np.random.default_rng(7)
    bias = _chained_bias(b, rng, cuda)
    l = bias.shape[-1]
    assert ((bias[:, 0, 0, :-1] < 0) & (bias[:, 0, 0, 1:] == 0)).any()  # a pad before a real token
    qkv = torch.from_numpy(rng.standard_normal((b, l, 3 * d), dtype=np.float32)).to(cuda, dtype)
    q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
    do = torch.from_numpy(rng.standard_normal((b, l, d), dtype=np.float32)).to(cuda, dtype)
    _build.reset_launch_counts()
    out, out2 = mha(q, k, v, bias, h), mha(q, k, v, bias, h)
    grads, grads2 = mha_backward(q, k, v, bias, do, h), mha_backward(q, k, v, bias, do, h)
    assert _nonzero_counts() == {"attention": 2, "attention_bwd": 2}
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), mha_reference(q, k, v, bias, h).float(), atol=tol, rtol=0)
    assert torch.equal(out, out2)
    atol, rtol = (2e-2, 2e-2) if dtype == torch.bfloat16 else (1e-5, 1e-4)
    for name, g, w, g2 in zip(("dq", "dk", "dv"), grads, mha_backward_reference(q, k, v, bias, do, h), grads2):
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=rtol, msg=lambda m: f"{name}: {m}")
        assert torch.equal(g, g2), name


@pytest.mark.parametrize("kind", ["binary", "multilabel"])
def test_task_head_step_on_card_matches_cpu(cuda, kind):
    """One train step of a small f32 binary (chained layout, segment
    embeddings, pos_weight 2) or multilabel ([CLS]) model, dropout 0, from
    the same weights and batch on the card and on the CPU: the launches of
    the step (gather 1, whole-row attention and its backward one a layer,
    no CE kernel), loss abs 1e-4, every parameter's gradient within 1e-3
    relative norm error."""
    import functools

    from bert4clickpath_torch.config import FeatureConfig, HeadConfig, ModelConfig
    from bert4clickpath_torch.data.chaining import chain_sequences, segment_bounds
    from bert4clickpath_torch.data.pipeline import to_device
    from bert4clickpath_torch.data.synthetic import seeded_state_dict
    from bert4clickpath_torch.models.model import ClickstreamModel
    from bert4clickpath_torch.ops.losses import masked_binary_cross_entropy
    from bert4clickpath_torch.training.train_state import make_loss_fn

    rng = np.random.default_rng(8)
    b = 16
    if kind == "binary":
        segs = (20, 6)
        hist = rng.integers(10, 500, size=(b, 20)).astype(np.int32)
        basket = rng.integers(10, 500, size=(b, 6)).astype(np.int32)
        for i in range(b):
            hist[i, rng.integers(0, 21):] = 0
            basket[i, rng.integers(1, 7):] = 0
        labels = np.where(basket > 0, rng.integers(0, 2, size=basket.shape), LABEL_PAD).astype(np.int32)
        tokens = chain_sequences([hist, basket])
        head = HeadConfig("binary", (48, 16))
        extra = dict(segment_bounds=segment_bounds(segs, 2), use_segment_embeddings=True)
        loss_fn = functools.partial(masked_binary_cross_entropy, pos_weight=2.0)
    else:
        hist = rng.integers(10, 500, size=(b, 20)).astype(np.int32)
        for i in range(b):
            hist[i, rng.integers(1, 21):] = 0
        tokens = chain_sequences([hist])
        labels = rng.integers(0, 2, size=(b, 12)).astype(np.int32)
        head = HeadConfig("multilabel", (48,), 12)
        extra = dict(segment_bounds=(0, 1))
        loss_fn = None
    cfg = ModelConfig(features={"items": FeatureConfig(512, 64)}, num_layers=2, num_heads=4, ffn_dim=128,
                      dropout_rate=0.0, max_len=tokens.shape[1], routing="segment", head=head, qkv_fused=True,
                      **extra)
    sd = seeded_state_dict(cfg, 0)
    host = {"features": {"items": tokens}, "labels": labels}
    results = []
    for device in (cuda, torch.device("cpu")):
        model = ClickstreamModel(cfg, device=device)
        model.load_state_dict(sd)
        _build.reset_launch_counts()
        loss = make_loss_fn(model, loss_fn)(to_device(host, device))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        if device.type == "cuda":
            assert _nonzero_counts() == {"gather": 1, "attention": 2, "attention_bwd": 2}
        results.append((loss.item(), {n: g.cpu() for (n, _), g in zip(model.named_parameters(), grads)}))
    (gl, gg), (cl, cg) = results
    assert abs(gl - cl) <= 1e-4
    for k in cg:
        err = (gg[k] - cg[k]).norm() / cg[k].norm().clamp(min=1e-30)
        assert err <= 1e-3, (k, err.item())


@pytest.mark.parametrize("tier", ["tp", "tp_spmd", "sampled_spmd"])
def test_tp_and_sampled_tiers_on_card_match_cpu(cuda, tier, tmp_path):
    """Two ranks sharing the card over gloo at (data, model) = (1, 2): one
    f32 step of the tier on the card against the same tier on the CPU (the
    plain versions) from the same weights and batch: the loss 1e-4
    relative, every gradient (Adam's first moment after one step, gathered
    back) within 1e-3 of its norm (the key bias, whose gradient is rounding
    noise, left out); exact kernel launches per rank (attention forward and
    backward once a layer, on each rank's two heads of four; the gather on
    tp; the CE forward and merged backward with their row_start on tp_spmd;
    no CE kernel on sampled_spmd, whose card and CPU runs take the same
    negatives, and whose ranks draw one set of them when left to draw: a
    CUDA generator's draws are not a CPU one's)."""
    from bert4clickpath_torch.config import FeatureConfig, HeadConfig, ModelConfig
    from bert4clickpath_torch.data.synthetic import seeded_state_dict
    from bert4clickpath_torch.parallel import drive
    from bert4clickpath_torch.parallel.mesh import spawn
    from bert4clickpath_torch.parallel.spmd import padded_vocab_rows

    rng = np.random.default_rng(3)
    num_valid, b, seq = 1500, 16, 24
    cfg = ModelConfig(features={"items": FeatureConfig(padded_vocab_rows(num_valid + 8, 2), 64)}, num_layers=2,
                      num_heads=4, ffn_dim=128, dropout_rate=0.0, max_len=seq,
                      head=HeadConfig("tied_softmax", output_size=num_valid, tied_bias=True))
    sd = {k: v.numpy() for k, v in seeded_state_dict(cfg, 1).items()}
    sd["tied_out_bias"] = rng.normal(scale=0.1, size=sd["tied_out_bias"].shape).astype(np.float32)
    tokens = rng.integers(10, num_valid, size=(b, seq)).astype(np.int32)
    tokens[:, -3:] = 0
    batch = {"features": {"items": tokens}, "head_positions": rng.integers(0, seq - 3, size=(b, 4)).astype(np.int32),
             "labels": rng.integers(0, num_valid, size=(b, 4)).astype(np.int32)}
    job = dict(kind="tier", tier=tier, mesh=(1, 2), config=cfg.to_json(), state=sd, batches=[batch],
               eval_batches=[], num_valid=num_valid, lr=1e-3, num_samples=64)
    jobs = [{**job, "device": "cuda"}, {**job, "device": "cpu"}]
    if tier == "sampled_spmd":
        negatives = [rng.integers(0, num_valid, size=64)]
        jobs = [{**j, "negatives": negatives} for j in jobs] + [{**job, "device": "cuda"}]
    ranks = spawn(drive.run_jobs, 2, str(tmp_path / "store"), (jobs,))
    per_step = {"tp": {"gather": 1, "attention": 2, "attention_bwd": 2},
                "tp_spmd": {"attention": 2, "attention_bwd": 2, "ce_fwd": 1, "ce_bwd": 1},
                "sampled_spmd": {"attention": 2, "attention_bwd": 2}}[tier]
    for card, cpu, *_ in ranks:
        assert {k: v for k, v in card["train_launches"].items() if v} == per_step
        np.testing.assert_allclose(card["losses"], cpu["losses"], rtol=1e-4)
        for k, want in cpu["mu"].items():
            if not k.endswith("wk.bias"):
                assert np.linalg.norm(card["mu"][k] - want) <= 1e-3 * np.linalg.norm(want), k
    if tier == "sampled_spmd":
        np.testing.assert_array_equal(ranks[0][2]["negatives"][0], ranks[1][2]["negatives"][0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v_rows", [1_000_448, 1_000_003])
def test_ce_kernels_against_plain_over_row_windows(cuda, v_rows, dtype):
    """The CE forward and the merged backward at a catalog of a million
    rows (the large-catalog path's shape cut in V: N = 2,560 rows of x (f32,
    as the SPMD step gives it, and bf16),
    D = 128, an f32 table of N(0, 0.02^2), a fifth of the labels padding;
    one V a multiple of the 64-row tile, one not), against the plain version
    taken over 8 row windows, each with its row_start, combined as the
    vocab-sharded tier combines shards (logz by log-sum-exp, dx summed in
    f32 and rounded once, dW the windows' rows). The tolerances of
    chip_smoke.py's sharded-ce phase: logz within 1e-5 of the largest
    |logz|, dx and dW within 1e-4 of their largest value; a bf16 dx adds
    one bf16 ulp of the value (where the two f32 sums straddle a rounding
    boundary, either neighbour is right)."""
    n, d, off, windows = 2560, 128, 11, 8
    nv = v_rows - off - 1
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn((n, d), generator=g, device=cuda).to(dtype)
    table = torch.randn((v_rows, d), generator=g, device=cuda).mul_(0.02)
    labels = torch.randint(0, nv, (n,), generator=g, device=cuda)
    labels[torch.rand(n, generator=g, device=cuda) < 0.2] = LABEL_PAD
    lab = torch.where(labels == LABEL_PAD, -1, labels + off).to(torch.int32)
    mask = (labels != LABEL_PAD).float()
    dnll = mask / mask.sum()
    per = -(-v_rows // windows)
    parts = [ce_stats_reference(x, table[lo : lo + per], None, off, nv, lo) for lo in range(0, v_rows, per)]
    m = torch.stack([p[0] for p in parts])
    gmax = m.max(dim=0).values
    want_logz = gmax + torch.log((torch.stack([p[1] for p in parts]) * torch.exp(m - gmax)).sum(dim=0))
    got_m, got_l = ce_stats(x, table, None, off, nv)
    scale = want_logz.abs().max().item()
    torch.testing.assert_close(got_m + torch.log(got_l), want_logz, atol=1e-5 * scale, rtol=0)
    want_dx = torch.zeros((n, d), dtype=torch.float32, device=cuda)
    want_dw = torch.empty((v_rows, d), dtype=torch.float32, device=cuda)
    for lo in range(0, v_rows, per):
        tw = table[lo : lo + per]
        a = ce_kernels._adjoint(x, tw, None, lab, want_logz, dnll, off, nv, lo).to(x.dtype).float()
        want_dx += a @ tw.to(x.dtype).float()
        want_dw[lo : lo + per] = a.T @ x.float()
    dx, dw, db = ce_backward(x, table, None, lab, want_logz, dnll, off, nv)
    assert db is None and dx.dtype == dtype
    want_dx = want_dx.to(x.dtype).float()
    ulp = torch.ldexp(torch.ones_like(want_dx), torch.frexp(want_dx)[1] - 8) if dtype == torch.bfloat16 else 0.0
    assert bool(((dx.float() - want_dx).abs() <= 1e-4 * want_dx.abs().max() + ulp).all())
    torch.testing.assert_close(dw, want_dw, atol=1e-4 * want_dw.abs().max().item(), rtol=0)
