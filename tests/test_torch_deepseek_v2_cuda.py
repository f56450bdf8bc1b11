"""The DeepSeek-V2 block's card paths: the grouped expert GEMM, the expert
layer without a host synchronisation, its launches, and the fused CE at
the block's width.

Marked ``gpu``: each test asks the ``cuda`` fixture for a device and skips
where there is none. On a machine with a card:

    python -m pytest --noconftest -m gpu tests/test_torch_deepseek_v2_cuda.py

Tolerances: the grouped GEMM's three products against an f64 oracle of the
same bf16 operands at the cell's shapes (64 experts, D 2,048, F 1,408,
~91k routed rows, uneven, one expert empty): the bf16 outputs within
2^-8 of the largest |value| (one rounding of an f32 sum to bf16 is at most
2^-9 of the value; the f32 sum over K <= 2,816 terms adds ~1e-6), the f32
weight gradient within 1e-5 of the largest (f32 sums over an expert's
~1,400 rows). The fused CE at D = 2,048, V = 102,400 with bf16 x: as
``test_torch_cuda.py``'s wide-row test, nll abs 1e-4 + rel 1e-5 and the
gradients within 1e-4 of the largest.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bert4clickpath_torch.config import DeepSeekV2Config, FeatureConfig, HeadConfig, ModelConfig
from bert4clickpath_torch.constants import LABEL_PAD
from bert4clickpath_torch.models.deepseek_v2 import MoE, route
from bert4clickpath_torch.models.model import ClickstreamModel
from bert4clickpath_torch.ops.kernels import _build
from bert4clickpath_torch.ops.kernels import grouped_gemm as gg
from bert4clickpath_torch.training import train_state as tts

pytestmark = pytest.mark.gpu

E, D, F = 64, 2048, 1408


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _offsets(device, rows_total=91_000, empty=(5,), seed=0):
    """Uneven per-expert counts summing to about ``rows_total``, the experts
    in ``empty`` with none; (offsets int32 on the device, the buffer's rows)."""
    rng = np.random.default_rng(seed)
    share = rng.gamma(0.7, size=E)
    share[list(empty)] = 0
    counts = np.floor(share / share.sum() * rows_total).astype(np.int64)
    padded = -(-counts // gg.GROUP_ROWS) * gg.GROUP_ROWS
    off = np.concatenate([[0], np.cumsum(padded)])
    rows = int(off[-1]) + 3 * gg.GROUP_ROWS  # a tail past the last expert
    return torch.tensor(off, dtype=torch.int32, device=device), counts, rows


def _rows(device, off, counts, rows, width, seed):
    """(rows, width) bf16: random in each expert's first ``counts`` rows, 0
    in its padding and the tail."""
    g = torch.Generator(device).manual_seed(seed)
    x = torch.zeros(rows, width, dtype=torch.bfloat16, device=device)
    o = off.tolist()
    for e in range(E):
        if counts[e]:
            x[o[e] : o[e] + counts[e]] = torch.randn(int(counts[e]), width, generator=g, device=device).bfloat16()
    return x


def _close(got, want, tol):
    scale = want.abs().max().item()
    err = (got.double() - want).abs().max().item()
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("n,k,as_lies", [(2 * F, D, False), (D, F, False), (D, 2 * F, True), (F, D, True)],
                         ids=["gate_up", "down", "dx_of_gate_up", "dx_of_down"])
def test_grouped_rows_product_against_f64(cuda, n, k, as_lies):
    """Y = X W_e^T per expert (the forward's two shapes), and dX = dY W_e
    with W (E, k, n) read as it lies (the input gradients of both); rows
    past the last expert and padding rows 0."""
    off, counts, rows = _offsets(cuda)
    x = _rows(cuda, off, counts, rows, k, seed=1)
    w = (torch.randn(E, *((k, n) if as_lies else (n, k)), device=cuda) / k**0.5).bfloat16()
    product = gg.grouped_mm_w if as_lies else gg.grouped_mm
    _build.reset_launch_counts()
    y = product(x, w, off)
    assert _build.launch_counts()["grouped_gemm"] == 1 and y.shape == (rows, n)
    want = torch.zeros(rows, n, dtype=torch.float64, device=cuda)
    o = off.tolist()
    for e in range(E):
        if o[e + 1] > o[e]:
            we = w[e].double()
            want[o[e] : o[e + 1]] = x[o[e] : o[e + 1]].double() @ (we if as_lies else we.t())
    _close(y, want, 2.0**-8)
    assert not y[int(o[-1]) :].any()
    torch.testing.assert_close(y, product(x, w, off), rtol=0, atol=0)  # repeats bit for bit


def test_grouped_weight_gradient_against_f64(cuda):
    """dW_e = dY_e^T X_e over each expert's rows (ragged), f32; an expert
    without rows gets 0."""
    off, counts, rows = _offsets(cuda, seed=2)
    x = _rows(cuda, off, counts, rows, D, seed=3)
    dy = _rows(cuda, off, counts, rows, 2 * F, seed=4)
    dw = gg.grouped_mm_dw(dy, x, off)
    o = off.tolist()
    assert dw.dtype == torch.float32 and not dw[5].any()
    for e in range(E):
        want = dy[o[e] : o[e + 1]].double().t() @ x[o[e] : o[e + 1]].double()
        if o[e + 1] > o[e]:
            _close(dw[e], want, 1e-5)
    torch.testing.assert_close(dw, gg.grouped_mm_dw(dy, x, off), rtol=0, atol=0)


def test_grouped_linear_gradients_match_the_plain_version(cuda):
    """The autograd op on the card against the per-expert loop of the plain
    version on the same bf16 operands (f32 sums both)."""
    off, counts, rows = _offsets(cuda, rows_total=9_000, seed=5)
    x = _rows(cuda, off, counts, rows, 256, seed=6).requires_grad_()
    w = (torch.randn(E, 384, 256, device=cuda) / 16).requires_grad_()
    y = gg.grouped_linear(x, w, off)
    dy = torch.randn_like(y)
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    wb = w.detach().bfloat16()
    want_y = gg.grouped_mm_reference(x.detach().float(), wb.float(), off)
    _close(y, want_y.double(), 2.0**-8)
    want_dx = gg.grouped_mm_w_reference(dy.float(), wb.float(), off)
    _close(dx, want_dx.double(), 2.0**-8)
    want_dw = gg.grouped_mm_dw_reference(dy.float(), x.detach().float(), off)
    _close(dw, want_dw.double(), 1e-5)


def test_gather_sum_and_dot_match_the_plain_versions(cuda):
    """The expert layer's gathers at the cell's shapes (T = 25,984 tokens, k
    = 6, D = 2,048; indices past the rows name none): the weighted sum
    within one bf16 rounding of the plain version's f32 sum, the dots
    within f32 summation order (1e-5 of the largest), both repeating bit
    for bit."""
    from bert4clickpath_torch.ops.kernels import moe_gather

    g = torch.Generator(cuda).manual_seed(8)
    t, k, r = 25_984, 6, 164_096
    rows = torch.randn(r, D, generator=g, device=cuda).bfloat16()
    idx = torch.randint(0, r + 2000, (t, k), generator=g, device=cuda)
    w = torch.rand(t, k, generator=g, device=cuda)
    grad = torch.randn(t, D, generator=g, device=cuda).bfloat16()
    _build.reset_launch_counts()
    out = moe_gather.gather_sum(rows, idx, w)
    dots = moe_gather.gather_dot(rows, idx, grad)
    assert _build.launch_counts()["moe_gather_sum"] == 1 and _build.launch_counts()["moe_gather_dot"] == 1
    want = moe_gather.gather_sum_reference(rows, idx, w)
    assert (out.float() - want.float()).abs().max().item() <= 2.0**-8 * want.float().abs().max().item()
    want_dots = moe_gather.gather_dot_reference(rows, idx, grad)
    assert (dots - want_dots).abs().max().item() <= 1e-5 * want_dots.abs().max().item()
    assert torch.equal(out, moe_gather.gather_sum(rows, idx, w))
    assert torch.equal(dots, moe_gather.gather_dot(rows, idx, grad))


def _block(layers=3):
    # the published head widths (q/k 128 + 64, v 128): the uneven attention
    # kernels' instance
    return DeepSeekV2Config(kv_lora_rank=128, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
                            n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1, moe_intermediate_size=128)


def test_expert_layer_makes_no_host_sync(cuda):
    """The MoE layer at the published widths, forward and backward, raises
    nothing under ``set_sync_debug_mode("error")`` (after a first call that
    allocates)."""
    torch.manual_seed(0)
    layer = MoE(D, DeepSeekV2Config(), torch.bfloat16, device=cuda)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0, p.shape[-1] ** -0.5)
    x = torch.randn(16, 203, D, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    valid = torch.arange(203, device=cuda)[None, :] < torch.randint(20, 204, (16, 1), device=cuda)

    def run():
        out = layer(x, valid)
        torch.autograd.grad((out.float().square().mean() + layer.aux), [x, *layer.parameters()])

    run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_train_step_launches_two_grouped_products_per_moe_layer(cuda):
    """One train step of a small block on the card: the forward of each MoE
    layer launches the fused gate-up product and the down product, the
    backward each one's input and weight gradient; the loss matches the
    CPU's plain path in f32 within bf16's reach."""
    n_items = 500
    cfg = ModelConfig(features={"items": FeatureConfig(512, 256)}, num_layers=3, num_heads=4, ffn_dim=512,
                      dropout_rate=0.0, max_len=40, positional="rope", head=HeadConfig("tied_softmax", output_size=n_items),
                      max_masked=8, dtype="bfloat16", norm_style="pre", block=_block())
    model = ClickstreamModel(cfg, device=cuda)
    g = torch.Generator(cuda).manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.ones_like(p) if p.dim() == 1 else torch.randn(p.shape, generator=g, device=cuda) * p.shape[-1] ** -0.5)
    rng = np.random.default_rng(0)
    tokens = np.zeros((16, 40), np.int32)
    for i, n in enumerate(rng.integers(5, 38, size=16)):
        tokens[i, :n] = rng.integers(10, 10 + n_items, size=n)
    positions = np.tile(np.arange(1, 9, dtype=np.int32), (16, 1))
    labels = np.where(positions < 5, rng.integers(0, n_items, size=positions.shape), LABEL_PAD).astype(np.int32)
    batch = {"features": {"items": torch.from_numpy(tokens).to(cuda)}, "head_positions": torch.from_numpy(positions).to(cuda),
             "labels": torch.from_numpy(labels).to(cuda)}
    loss_fn = tts.make_loss_fn(model, fused_ce_num_valid=n_items)
    params = list(model.parameters())
    _build.reset_launch_counts()
    loss = loss_fn(batch)
    counts = _build.launch_counts()
    assert (counts["grouped_gemm"], counts["uneven_fwd"], counts["uneven_bwd"]) == (2 * 2, 3, 0)
    torch.autograd.grad(loss, params)
    counts = _build.launch_counts()
    assert (counts["grouped_gemm"], counts["uneven_fwd"], counts["uneven_bwd"]) == (2 * 2 + 4 * 2, 3, 3)
    assert torch.isfinite(loss)


def test_fused_ce_at_the_block_width(cuda):
    """fused_softmax_ce with gradients at D = 2,048 (the two-pass backward,
    four slices of 512) over V = 102,400 rows, bf16 x, against the dense f32
    oracle of the same bf16 x."""
    from bert4clickpath_torch.ops.fused_ce import dense_softmax_ce, fused_softmax_ce
    from bert4clickpath_torch.ops.kernels.fused_ce import ce_backward_route, two_pass_slices

    assert ce_backward_route(D) == "two_pass" and two_pass_slices(D) == 4
    rng = np.random.default_rng(7)
    n, v, off, nv = 2900, 102_400, 10, 102_389
    x = torch.from_numpy(rng.standard_normal((n, D), dtype=np.float32)).cuda().bfloat16().requires_grad_()
    table = torch.from_numpy(rng.standard_normal((v, D), dtype=np.float32) * D**-0.5).cuda().requires_grad_()
    labels = torch.from_numpy(rng.integers(0, nv, size=n).astype(np.int32)).cuda()
    labels[::7] = LABEL_PAD
    nll = fused_softmax_ce(x, table, labels, off, nv)
    got = torch.autograd.grad(nll.sum(), (x, table))
    xf = x.detach().float().requires_grad_()
    tb = table.detach().bfloat16().float().requires_grad_()
    want = dense_softmax_ce(xf, tb, labels, off, nv)
    torch.testing.assert_close(nll, want, atol=1e-4, rtol=1e-5)
    for a, b in zip(got, torch.autograd.grad(want.sum(), (xf, tb))):
        err = (a.float() - b).abs().max().item()
        assert err <= 1e-4 * b.abs().max().item() + 2.0**-8 * (a.dtype == torch.bfloat16) * b.abs().max().item(), err


def _uneven_inputs(cuda, b=8, l=203, h=16, dqk=192, dv=128, seed=3):
    """bf16 q, k (B, L, H dqk), v, do (B, L, H dv) and the f32 padding bias
    of sessions 20..L long (the cell's lengths)."""
    g = torch.Generator(cuda).manual_seed(seed)
    q, k = (torch.randn(b, l, h * dqk, generator=g, device=cuda).bfloat16() for _ in range(2))
    v, do = (torch.randn(b, l, h * dv, generator=g, device=cuda).bfloat16() for _ in range(2))
    lengths = torch.randint(20, l + 1, (b,), generator=g, device=cuda)
    lengths[0] = l
    bias = torch.where(torch.arange(l, device=cuda)[None, :] < lengths[:, None], 0.0, -1e9)
    return q, k, v, do, bias[:, None, None, :].float().contiguous()


def test_uneven_attention_kernels_match_the_plain_versions(cuda):
    """The uneven attention kernels at the cell's heads (16 of q/k 192 and v
    128, L = 203, the block's YaRN scale) against their plain versions with
    the same roundings: out within one bf16 ulp of an O(1) value (2e-2;
    the kernel's exp and its sums run in another order), lse within 1e-4,
    the gradients within (2e-2, 2e-2) as the blockwise kernels'; two runs
    bit-equal (no atomics)."""
    from bert4clickpath_torch.models.deepseek_v2 import yarn_scale
    from bert4clickpath_torch.ops.kernels import attention as att

    h, scale = 16, yarn_scale(DeepSeekV2Config())
    q, k, v, do, bias = _uneven_inputs(cuda)
    out, lse = att.uneven_mha_forward(q, k, v, bias, h, scale)
    want_out, want_lse = att.blockwise_mha_reference(q, k, v, bias, h, scale)
    torch.testing.assert_close(out.float(), want_out.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    grads = att.uneven_mha_backward(q, k, v, bias, out, lse, do, h, scale)
    delta = att.attention_delta(do, out, h)
    args = (q, k, v, bias, lse, do, delta, h, scale)
    want = (att.blockwise_dq_reference(*args), *att.blockwise_dkv_reference(*args))
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
        torch.testing.assert_close(got.float(), ref.float(), atol=2e-2, rtol=2e-2, msg=name)
    again = att.uneven_mha_forward(q, k, v, bias, h, scale)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    assert all(torch.equal(a, b) for a, b in zip(att.uneven_mha_backward(q, k, v, bias, out, lse, do, h, scale), grads))


def test_gather_without_positions_matches_the_plain_version(cuda):
    """The lookup of a RoPE model: the gather kernel with no position table,
    bit-equal to table[ids] * scale rounded once to bf16."""
    from bert4clickpath_torch.ops.kernels.gather import gather_scale_pos, gather_scale_pos_reference

    g = torch.Generator(cuda).manual_seed(4)
    table = torch.randn(1000, D, generator=g, device=cuda)
    ids = torch.randint(0, 1000, (4, 203), generator=g, device=cuda, dtype=torch.int32)
    got = gather_scale_pos(table, ids, None, D**0.5, torch.bfloat16)
    assert torch.equal(got, gather_scale_pos_reference(table, ids, None, D**0.5, torch.bfloat16))
