"""The DeepSeek-V2 block (``config.DeepSeekV2Config``) as the encoder's
layer: pre-RMSNorm, multi-head latent attention, and a SwiGLU feed-forward
that is dense in the first layers and a mixture of experts after them.

It has no counterpart in the JAX package. Its plain float32 reference is
``tests/plain_deepseek_v2.py`` (and the benchmark's copy,
``portbench/reference/deepseek_v2.py``); the CPU tests hold the two
together.

* :class:`RMSNorm`: statistics and the scale in f32, one rounding to the
  compute dtype (as :class:`~bert4clickpath_torch.models.encoder.LayerNorm`).
* :class:`MLAttention`: ``q = x W_q`` (per head ``[nope | rope]``), the
  latent ``c = x W_kva`` split into ``c_kv`` (RMS-normed) and one RoPE key
  ``k_pe`` for all heads, ``[k_nope | v] = c_kv W_kvb`` per head, RoPE on
  ``q_pe`` and ``k_pe`` at slot positions 0..L-1 (:func:`rope`, DeepSeek's
  pair layout), attention at the YaRN softmax scale (:func:`yarn_scale`)
  through ``ops/kernels/attention.py:mha`` (v narrower than q and k), then
  ``W_o``. The span ``b4cp.mla`` holds all of it but attention's core,
  which lies in ``b4cp.attention``.
* :class:`SwiGLU`: ``W_down(silu(W_gate x) * W_up x)``, the gate and up
  projections as one (2F, D) weight.
* :class:`MoE`: a softmax router in f32, greedy top-k without
  renormalisation, every routed token kept. The routed (token, expert)
  pairs are sorted by expert on the device (:func:`route`: each expert's
  rows padded to ``GROUP_ROWS``, no host read), gathered into a buffer of
  rows and run through the grouped expert products
  (``ops/kernels/grouped_gemm.py``: gate and up as one, SwiGLU, down),
  scaled by their gate weights and summed back per token
  (``ops/kernels/moe_gather.py``, f32 sums, no atomics);
  the shared experts are one dense SwiGLU. Padding positions are routed
  nowhere: their routed part is 0. Spans: ``b4cp.moe.route`` (router, top-k,
  balance loss, the permutation and the sum back), ``b4cp.moe.experts``
  (the grouped products and SwiGLU), ``b4cp.moe.shared``.
* :func:`balance_loss`: DeepSeek-V2's sequence-wise balance loss over the
  real tokens of each session, averaged over the batch's sessions; each MoE
  layer leaves its own of the last forward in ``MoE.aux``, which
  ``training/train_state.py:make_loss_fn`` adds to the loss.

Parameters are f32; the compute dtype follows the model's (products in
bf16 with f32 sums under bf16). The block takes no dropout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bert4clickpath_torch.config import DeepSeekV2Config
from bert4clickpath_torch.ops.kernels import grouped_gemm, moe_gather
from bert4clickpath_torch.ops.kernels.attention import mha
from bert4clickpath_torch.utils import profiling

GROUP_ROWS = grouped_gemm.GROUP_ROWS


class Linear(nn.Module):
    """A product without bias: f32 ``weight`` (out, in), computed in the
    compute dtype."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype, *, device):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class RMSNorm(nn.Module):
    """x / sqrt(mean(x^2) + eps) * weight, in f32, rounded once."""

    def __init__(self, dim: int, dtype: torch.dtype, eps: float, *, device):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x.float(), self.weight.shape, self.weight, self.eps).to(self.dtype)


def yarn_correction_range(cfg: DeepSeekV2Config) -> tuple[int, int]:
    """(low, high): the rotary pairs below ``low`` keep their frequency,
    those above ``high`` are divided by the factor, with d(r) = dim ln(L0 /
    (2 pi r)) / (2 ln theta) and low = floor(d(beta_fast)), high =
    ceil(d(beta_slow)), clamped to [0, dim - 1]."""
    dim = cfg.qk_rope_head_dim

    def d(rotations: float) -> float:
        return dim * math.log(cfg.rope_original_max_position / (rotations * 2 * math.pi)) / (2 * math.log(cfg.rope_theta))

    return max(math.floor(d(cfg.rope_beta_fast)), 0), min(math.ceil(d(cfg.rope_beta_slow)), dim - 1)


def yarn_inv_freq(cfg: DeepSeekV2Config) -> torch.Tensor:
    """(dim / 2,) f64: theta^(-2i/dim) where the ramp is 0, that over the
    factor where it is 1, linear between ``low`` and ``high``."""
    dim = cfg.qk_rope_head_dim
    low, high = yarn_correction_range(cfg)
    i = torch.arange(dim // 2, dtype=torch.float64)
    extra = cfg.rope_theta ** (-2.0 * i / dim)
    ramp = ((i - low) / max(high - low, 1e-3)).clamp(0.0, 1.0)
    return extra * (1.0 - ramp) + extra / cfg.rope_factor * ramp


def _yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_scale(cfg: DeepSeekV2Config) -> float:
    """The softmax scale: qk_head_dim^-1/2 times the squared YaRN mscale of
    ``rope_mscale_all_dim`` (0.114721 at DeepSeek-V2-Lite's widths)."""
    return cfg.qk_head_dim ** -0.5 * _yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim) ** 2


def rope_tables(cfg: DeepSeekV2Config, length: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (length, dim / 2) f32, at positions 0..length-1,
    scaled by the ratio of the two mscales (1 where they are equal)."""
    angles = torch.arange(length, dtype=torch.float64)[:, None] * yarn_inv_freq(cfg)[None, :]
    m = _yarn_mscale(cfg.rope_factor, cfg.rope_mscale) / _yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim)
    return (torch.cos(angles) * m).float().to(device), (torch.sin(angles) * m).float().to(device)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek's rotary layout on (..., L, [H,] dim): the pairs are
    (x[2i], x[2i+1]), rotated by angle i, and the result is laid out
    de-interleaved, [a_0 .. a_{n-1} | b_0 .. b_{n-1}] with a_i = x[2i] cos -
    x[2i+1] sin and b_i = x[2i+1] cos + x[2i] sin. ``cos``/``sin`` (L, dim /
    2) broadcast over the dims between L and the last. In f32, rounded to
    x's dtype."""
    c, s = (cos, sin) if x.dim() == 3 else (cos[:, None, :], sin[:, None, :])
    even, odd = x.float().unflatten(-1, (-1, 2)).unbind(-1)
    return torch.cat([even * c - odd * s, odd * c + even * s], dim=-1).to(x.dtype)


class MLAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, cfg: DeepSeekV2Config, dtype: torch.dtype, *, device):
        super().__init__()
        self.cfg = cfg
        self.num_heads = num_heads
        self.dtype = dtype
        h = num_heads
        self.wq = Linear(d_model, h * cfg.qk_head_dim, dtype, device=device)
        self.wkv_a = Linear(d_model, cfg.kv_lora_rank + cfg.qk_rope_head_dim, dtype, device=device)
        self.kv_norm = RMSNorm(cfg.kv_lora_rank, dtype, cfg.rms_norm_eps, device=device)
        self.wkv_b = Linear(cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim), dtype, device=device)
        self.wo = Linear(h * cfg.v_head_dim, d_model, dtype, device=device)
        self.scale = yarn_scale(cfg)
        self._rope = {}  # (length, device) -> (cos, sin), made once on the host

    def rope_tables(self, length: int, device) -> tuple[torch.Tensor, torch.Tensor]:
        key = (length, str(device))
        if key not in self._rope:
            self._rope[key] = rope_tables(self.cfg, length, device)
        return self._rope[key]

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        cfg, h = self.cfg, self.num_heads
        b, l, _ = x.shape
        nope, pe, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        with profiling.block("b4cp.mla") as blk:
            x = blk.input(x)
            cos, sin = self.rope_tables(l, x.device)
            # split, not two slices: the backward joins the parts in one pass
            q_nope, q_pe = self.wq(x).view(b, l, h, nope + pe).split([nope, pe], dim=-1)
            q = torch.cat([q_nope, rope(q_pe, cos, sin)], dim=-1)
            c_kv, k_pe = self.wkv_a(x).split([cfg.kv_lora_rank, pe], dim=-1)
            k_pe = rope(k_pe, cos, sin)  # (B, L, pe), one for all heads
            k_nope, v = self.wkv_b(self.kv_norm(c_kv)).view(b, l, h, nope + dv).split([nope, dv], dim=-1)
            k = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, l, h, pe)], dim=-1)
            q, k, v = blk.output(q.reshape(b, l, -1)), blk.output(k.reshape(b, l, -1)), blk.output(v.reshape(b, l, -1))
        out = mha(q, k, v, bias, h, scale=self.scale)
        with profiling.block("b4cp.mla") as blk:
            return blk.output(self.wo(blk.input(out)))


class SwiGLU(nn.Module):
    """W_down(silu(W_gate x) * W_up x), gate and up one (2F, D) weight."""

    def __init__(self, d_model: int, width: int, dtype: torch.dtype, *, device):
        super().__init__()
        self.gate_up = Linear(d_model, 2 * width, dtype, device=device)
        self.down = Linear(width, d_model, dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(swiglu(self.gate_up(x)))


def swiglu(gu: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up of (..., 2F) ``gu``, gate first (unbound, not sliced:
    the backward stacks the two gradients in one pass)."""
    gate, up = gu.unflatten(-1, (2, -1)).unbind(-2)
    return F.silu(gate) * up


def route(scores: torch.Tensor, valid: torch.Tensor, k: int, group_rows: int = GROUP_ROWS):
    """The routing of (T, E) f32 router probabilities: each real token to
    its top-k experts, sorted by expert on the device.

    Returns ``(weights (T, k) f32, experts (T, k) int64, dest (T, k) int64,
    slot (R,) int64, offsets (E + 1,) int32)``. The buffer's R rows are T k
    rounded up to ``group_rows``, plus E ``group_rows``. ``dest``: the row
    each (token, slot) pair goes to (R for padding, routed nowhere);
    ``slot``: the pair t k + j each row takes (T k: none, a row of zeros);
    ``offsets``: where each expert's rows start, each expert's count padded
    to a multiple of ``group_rows``, and their end. Reads nothing back to
    the host."""
    t, e = scores.shape
    weights, experts = scores.topk(k, dim=-1)
    slot_expert = torch.where(valid[:, None], experts, e).reshape(-1)  # e: routed nowhere
    counts = torch.zeros(e + 1, dtype=torch.int64, device=scores.device)
    counts.scatter_add_(0, slot_expert, torch.ones_like(slot_expert))
    counts = counts[:e]
    padded = (counts + group_rows - 1) // group_rows * group_rows
    seg_end = padded.cumsum(0)
    order = torch.argsort(slot_expert, stable=True)
    sorted_expert = slot_expert[order]
    clamped = sorted_expert.clamp(max=e - 1)
    rank = torch.arange(t * k, device=scores.device) - (counts.cumsum(0) - counts)[clamped]
    rows = (t * k + group_rows - 1) // group_rows * group_rows + e * group_rows
    dest_sorted = torch.where(sorted_expert < e, seg_end[clamped] - padded[clamped] + rank, rows)
    dest = torch.empty_like(dest_sorted)
    dest[order] = dest_sorted
    slot = torch.full((rows + 1,), t * k, dtype=torch.int64, device=scores.device)
    slot[dest] = torch.arange(t * k, device=scores.device)
    offsets = torch.cat([seg_end.new_zeros(1), seg_end]).to(torch.int32)
    return weights, experts, dest.view(t, k), slot[:rows], offsets


class _Dispatch(torch.autograd.Function):
    """The (R, D) buffer of rows: token ``slot // k`` of ``x`` (T, D) in
    each row (0 where ``slot`` names none); its backward sums each token's
    k rows back (``moe_gather.gather_sum``, f32 sums, no atomics: it repeats
    bit for bit). ``live`` (T, k) f32: 1 for a routed pair, 0 for padding."""

    @staticmethod
    def forward(ctx, x, slot, dest, live):
        ctx.save_for_backward(dest, live)
        k = dest.shape[1]
        return moe_gather.gather_sum(x, (slot // k)[:, None], torch.ones_like(slot, dtype=torch.float32)[:, None])

    @staticmethod
    def backward(ctx, g):
        dest, live = ctx.saved_tensors
        return moe_gather.gather_sum(g, dest, live), None, None, None


class _Combine(torch.autograd.Function):
    """(T, D): each token's k expert rows of ``rows`` (R, D), scaled by
    ``weights`` (T, k) f32 and summed in f32. Backward: each row's gradient
    is its token's, scaled by its weight (a gather, no atomics); each
    weight's is the dot of its row and its token's gradient."""

    @staticmethod
    def forward(ctx, rows, weights, dest, slot):
        ctx.save_for_backward(rows, weights, dest, slot)
        return moe_gather.gather_sum(rows, dest, weights)

    @staticmethod
    def backward(ctx, g):
        rows, weights, dest, slot = ctx.saved_tensors
        k = dest.shape[1]
        g = g.contiguous()
        row_weight = F.pad(weights.reshape(-1), (0, 1)).index_select(0, slot)[:, None]
        d_rows = moe_gather.gather_sum(g, (slot // k)[:, None], row_weight)
        return d_rows, moe_gather.gather_dot(rows, dest, g), None, None


def balance_loss(scores: torch.Tensor, experts: torch.Tensor, valid: torch.Tensor, alpha: float) -> torch.Tensor:
    """DeepSeek-V2's sequence-wise balance loss over the real tokens:
    alpha sum_i f_i P_i per session, f_i = E / (k T) #{t: i in topk(t)} and
    P_i = (1 / T) sum_t s_ti, averaged over the sessions with a real token.
    ``scores`` (B, L, E) f32, ``experts`` (B, L, k), ``valid`` (B, L)."""
    b, l, e = scores.shape
    k = experts.shape[-1]
    real = valid.sum(1).float()  # T of each session
    slot = torch.where(valid[..., None], experts, e).reshape(b, l * k)
    counts = torch.zeros(b, e + 1, device=scores.device).scatter_add_(1, slot, torch.ones_like(slot, dtype=torch.float32))
    t = real.clamp(min=1.0)[:, None]
    f = counts[:, :e] * (e / k) / t
    p = (scores * valid[..., None]).sum(1) / t
    per_session = alpha * (f * p).sum(1)
    has = (real > 0).float()
    return (per_session * has).sum() / has.sum().clamp(min=1.0)


class GroupedExperts(nn.Module):
    """``n`` SwiGLU experts of width F: ``w_gate_up`` (n, 2F, D), gate rows
    first, and ``w_down`` (n, D, F), run over a buffer of rows sorted and
    padded by expert (:func:`route`)."""

    def __init__(self, n: int, d_model: int, width: int, dtype: torch.dtype, *, device):
        super().__init__()
        self.w_gate_up = nn.Parameter(torch.empty(n, 2 * width, d_model, device=device))
        self.w_down = nn.Parameter(torch.empty(n, d_model, width, device=device))

    def forward(self, rows: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
        act = swiglu(grouped_gemm.grouped_linear(rows, self.w_gate_up, offsets))
        return grouped_gemm.grouped_linear(act, self.w_down, offsets)


class MoE(nn.Module):
    def __init__(self, d_model: int, cfg: DeepSeekV2Config, dtype: torch.dtype, *, device):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.router = nn.Parameter(torch.empty(cfg.n_routed_experts, d_model, device=device))
        self.experts = GroupedExperts(cfg.n_routed_experts, d_model, cfg.moe_intermediate_size, dtype, device=device)
        self.shared = SwiGLU(d_model, cfg.n_shared_experts * cfg.moe_intermediate_size, dtype, device=device)
        self.aux: Optional[torch.Tensor] = None  # the last forward's balance loss

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """(B, L, D) -> (B, L, D); ``valid`` (B, L) marks the real tokens."""
        cfg = self.cfg
        b, l, d = x.shape
        k = cfg.num_experts_per_tok
        with profiling.block("b4cp.moe.route") as blk:
            flat = blk.input(x).reshape(b * l, d)
            scores = torch.softmax(F.linear(flat.float(), self.router.float()), dim=-1)
            weights, experts, dest, slot, offsets = route(scores, valid.reshape(-1), k)
            live = valid.reshape(-1, 1).expand(-1, k).float()
            rows = blk.output(_Dispatch.apply(flat, slot, dest, live))
            weights = blk.output(weights * live)
            self.aux = balance_loss(scores.view(b, l, -1), experts.view(b, l, k), valid, cfg.aux_loss_alpha)
        with profiling.block("b4cp.moe.experts") as blk:
            out_rows = blk.output(self.experts(blk.input(rows), offsets))
        with profiling.block("b4cp.moe.route") as blk:
            routed = blk.output(_Combine.apply(blk.input(out_rows), blk.input(weights), dest, slot))
        with profiling.block("b4cp.moe.shared") as blk:
            shared = blk.output(self.shared(blk.input(x)))
        return routed.view(b, l, d) + shared


class DeepSeekV2Layer(nn.Module):
    """h = x + MLA(RMSNorm(x)); out = h + FFN(RMSNorm(h)), the FFN dense
    (``dense_width`` wide) or a :class:`MoE`."""

    def __init__(self, d_model: int, num_heads: int, cfg: DeepSeekV2Config, dense_width: Optional[int],
                 dtype: torch.dtype, *, device):
        super().__init__()
        self.attn_norm = RMSNorm(d_model, dtype, cfg.rms_norm_eps, device=device)
        self.attn = MLAttention(d_model, num_heads, cfg, dtype, device=device)
        self.ffn_norm = RMSNorm(d_model, dtype, cfg.rms_norm_eps, device=device)
        self.ffn = SwiGLU(d_model, dense_width, dtype, device=device) if dense_width else MoE(
            d_model, cfg, dtype, device=device)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), bias)
        h = self.ffn_norm(x)
        if isinstance(self.ffn, MoE):
            return x + self.ffn(h, bias[:, 0, 0, :] == 0)
        return x + self.ffn(h)
