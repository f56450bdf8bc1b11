"""Plain float32 reference of the DeepSeek-V2 block as the Cloze encoder
(the configuration ``deepseek_v2_lite_stage5``).

DeepSeek-V2 (https://arxiv.org/abs/2405.04434) at the widths of
DeepSeek-V2-Lite's ``config.json``, which the configuration file holds
under the published keys, as an encoder over item ids trained with the
Cloze objective:

* item ids looked up in the table and scaled by sqrt(hidden_size), no
  positions added (they enter as RoPE);
* per layer, pre-RMSNorm (x / sqrt(mean(x^2) + eps) * w): h = x +
  MLA(RMSNorm(x)), out = h + FFN(RMSNorm(h));
* MLA without query compression: q = x W_q, per head [nope | rope]; the
  latent c = x W_kva split into c_kv (kv_lora_rank, RMS-normed) and one RoPE
  key k_pe for all heads; [k_nope | v] = c_kv W_kvb per head; RoPE rotates
  the interleaved pairs (x[2i], x[2i+1]) by pos * inv_freq[i], here as
  complex products with the pairs left interleaved (Hugging Face's model
  lays them out de-interleaved: a permutation of q_pe and k_pe alike, which
  leaves every score as it is); YaRN's inv_freq (divided by the factor
  beyond the correction range, ramped inside it) and softmax scale
  (qk_head_dim^-1/2 mscale^2, mscale = 0.1 mscale_all_dim ln(factor) + 1);
  padded keys masked with -1e9; then W_o;
* the FFN: SwiGLU W_down(silu(W_gate x) * W_up x), gate and up stacked as
  one (2F, D) weight (gate rows first), dense in the first
  first_k_dense_replace layers; after them a mixture of experts: the router
  softmax(x W_r^T) in f32, greedy top-k, weights not renormalised, no token
  dropped, each routed expert a SwiGLU (stacked (E, 2F, D) and (E, D, F)
  weights), plus the shared experts as one SwiGLU of n_shared_experts
  moe_intermediate_size; padding tokens are routed nowhere;
* a final RMSNorm, the Cloze positions gathered, the softmax tied to the
  item table (``common.BlockedTiedCE``): the mean NLL of the labelled rows;
* plus each MoE layer's sequence-wise balance loss: aux_loss_alpha sum_i
  f_i P_i per session over its T real tokens, f_i = E / (k T) #{t: i in
  topk(t)}, P_i = (1 / T) sum_t s_ti, averaged over the sessions.

Departures from the published model: padding is neither routed nor counted
in the balance loss (the published model sees no padding), the tied Cloze
head in place of the untied lm_head, the table's sqrt(d) scale, no causal
mask (a bidirectional encoder, as BERT4Rec's). No dropout (the published
attention_dropout is 0).

Written in plain PyTorch from that description; it imports nothing of the
program (the test suite holds it against ``tests/plain_deepseek_v2.py``).
Every product goes through a ``common.Numerics``. At the published widths
each layer runs under ``torch.utils.checkpoint`` (its activations computed
again in the backward), so the f32 activations of one layer at a time are
held beside the weights, gradients and Adam's state.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.common import LABEL_PAD, PAD_ID, BlockedTiedCE, Numerics

NEG_INF = -1e9


def check_supported(cfg: dict) -> None:
    wanted = {"head": "tied_softmax", "q_lora_rank": None, "hidden_act": "silu", "scoring_func": "softmax",
              "topk_method": "greedy", "norm_topk_prob": False, "routed_scaling_factor": 1, "moe_layer_freq": 1,
              "attention_bias": False, "seq_aux": True, "dropout_rate": 0.0}
    for key, value in wanted.items():
        if cfg[key] != value:
            raise ValueError(f"deepseek_v2 reference: {key}={cfg[key]!r} is not written out (only {value!r})")
    if cfg["rope_scaling"]["type"] != "yarn" or cfg["d_model"] != cfg["hidden_size"]:
        raise ValueError("deepseek_v2 reference: YaRN RoPE, d_model = hidden_size only")


def param_specs(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, pe, dv, r = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    e, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    shared = cfg["n_shared_experts"] * f
    specs = [("embed_items.weight", (cfg["table_rows"], d), "table")]
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer_{i}."
        specs += [
            (p + "attn_norm.weight", (d,), "ones"),
            (p + "attn.wq.weight", (h * (nope + pe), d), "dense"),
            (p + "attn.wkv_a.weight", (r + pe, d), "dense"),
            (p + "attn.kv_norm.weight", (r,), "ones"),
            (p + "attn.wkv_b.weight", (h * (nope + dv), r), "dense"),
            (p + "attn.wo.weight", (d, h * dv), "dense"),
            (p + "ffn_norm.weight", (d,), "ones"),
        ]
        if i < cfg["first_k_dense_replace"]:
            w = cfg["intermediate_size"]
            specs += [(p + "ffn.gate_up.weight", (2 * w, d), "dense"), (p + "ffn.down.weight", (d, w), "dense")]
        else:
            specs += [
                (p + "ffn.router", (e, d), "dense"),
                (p + "ffn.experts.w_gate_up", (e, 2 * f, d), "dense"),
                (p + "ffn.experts.w_down", (e, d, f), "dense"),
                (p + "ffn.shared.gate_up.weight", (2 * shared, d), "dense"),
                (p + "ffn.shared.down.weight", (d, shared), "dense"),
            ]
    specs.append(("encoder.ln_final.weight", (d,), "ones"))
    return specs


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def yarn(cfg: dict) -> tuple[torch.Tensor, float]:
    """(inv_freq (dim / 2,) f64, the softmax scale)."""
    rs = cfg["rope_scaling"]
    dim, theta, factor = cfg["qk_rope_head_dim"], cfg["rope_theta"], rs["factor"]

    def corr(rot):
        return dim * math.log(rs["original_max_position_embeddings"] / (rot * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    i = torch.arange(dim // 2, dtype=torch.float64)
    base = 1.0 / theta ** (2 * i / dim)
    ramp = torch.clamp((i - low) / max(high - low, 1e-3), 0, 1)
    mscale = 0.1 * rs["mscale_all_dim"] * math.log(factor) + 1.0
    return base / factor * ramp + base * (1 - ramp), (cfg["qk_nope_head_dim"] + dim) ** -0.5 * mscale * mscale


def _rotate(x, rot):
    """Interleaved pairs of x's last axis times the unit complex numbers
    ``rot`` (L, dim / 2); x is (B, L, ...)."""
    z = torch.view_as_complex(x.float().reshape(*x.shape[:-1], -1, 2).contiguous())
    return torch.view_as_real(z * rot.reshape(1, rot.shape[0], *([1] * (x.dim() - 3)), rot.shape[1])).reshape(x.shape)


def _lin(x, w, num: Numerics):
    """x @ w^T over x's rows taken as one matrix (a weight's gradient is one
    product, not one a leading index)."""
    return num.mm(x.reshape(-1, x.shape[-1]), w.t()).view(*x.shape[:-1], w.shape[0])


def _swiglu(x, w_gate_up, w_down, num: Numerics):
    f = w_down.shape[-1]
    gu = _lin(x, w_gate_up, num)
    return _lin(F.silu(gu[..., :f]) * gu[..., f:], w_down, num)


def _mla(x, p, pre, cfg, bias, rot, scale, num: Numerics):
    b, l, _ = x.shape
    h = cfg["num_attention_heads"]
    nope, pe, dv, r = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = _lin(x, p[pre + "wq.weight"], num).reshape(b, l, h, nope + pe)
    q = torch.cat([q[..., :nope], _rotate(q[..., nope:], rot)], -1)
    c = _lin(x, p[pre + "wkv_a.weight"], num)
    c_kv = _rms(c[..., :r], p[pre + "kv_norm.weight"], cfg["rms_norm_eps"])
    k_pe = _rotate(c[..., r:], rot)
    kv = _lin(c_kv, p[pre + "wkv_b.weight"], num).reshape(b, l, h, nope + dv)
    k = torch.cat([kv[..., :nope], k_pe[:, :, None, :].expand(b, l, h, pe)], -1)
    v = kv[..., nope:]
    s = num.mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * scale + bias
    o = num.mm(torch.softmax(s, -1), v.transpose(1, 2)).transpose(1, 2).reshape(b, l, h * dv)
    return _lin(o, p[pre + "wo.weight"], num)


def _moe(x, p, pre, cfg, valid, num: Numerics):
    b, l, d = x.shape
    e, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    flat = x.reshape(-1, d)
    scores = torch.softmax(_lin(flat, p[pre + "router"], num), -1)
    weights, experts = scores.topk(k, -1)
    routed = (experts[..., None] == torch.arange(e, device=x.device)) & valid.reshape(-1, 1, 1)  # (T, k, E)
    out = torch.zeros_like(flat)
    for i in range(e):
        tokens, slots = torch.nonzero(routed[..., i], as_tuple=True)
        if tokens.numel():
            y = _swiglu(flat[tokens], p[pre + "experts.w_gate_up"][i], p[pre + "experts.w_down"][i], num)
            out = out.index_add(0, tokens, y * weights[tokens, slots, None])
    out = out + _swiglu(flat, p[pre + "shared.gate_up.weight"], p[pre + "shared.down.weight"], num)
    real = valid.sum(1).float()
    t = real.clamp(min=1.0)[:, None]
    f = routed.view(b, l, k, e).sum((1, 2)).float() * (e / k) / t
    share = (scores.view(b, l, e) * valid[..., None]).sum(1) / t
    has = (real > 0).float()
    aux = ((cfg["aux_loss_alpha"] * (f * share).sum(1)) * has).sum() / has.sum().clamp(min=1.0)
    return out.reshape(b, l, d), aux


def _layer(i, cfg, p, num, x, bias, valid, rot, scale):
    pre = f"encoder.layer_{i}."
    eps = cfg["rms_norm_eps"]
    x = x + _mla(_rms(x, p[pre + "attn_norm.weight"], eps), p, pre + "attn.", cfg, bias, rot, scale, num)
    h = _rms(x, p[pre + "ffn_norm.weight"], eps)
    if i < cfg["first_k_dense_replace"]:
        return x + _swiglu(h, p[pre + "ffn.gate_up.weight"], p[pre + "ffn.down.weight"], num), x.new_zeros(())
    y, aux = _moe(h, p, pre + "ffn.", cfg, valid, num)
    return x + y, aux


def loss_fn(params: dict, cfg: dict, batch: dict, generator: Optional[torch.Generator],
            num: Numerics, block: int) -> torch.Tensor:
    """The step's loss on one batch (``tokens``, ``positions``, ``labels``
    on the device): the Cloze CE plus the balance losses."""
    tokens = batch["tokens"]
    b, l = tokens.shape
    d = cfg["hidden_size"]
    valid = tokens != PAD_ID
    bias = torch.where(valid, 0.0, NEG_INF)[:, None, None, :]
    inv_freq, scale = yarn(cfg)
    angles = (torch.arange(l, dtype=torch.float64)[:, None] * inv_freq[None]).float().to(tokens.device)
    rot = torch.polar(torch.ones_like(angles), angles)
    x = params["embed_items.weight"][tokens.long()] * math.sqrt(d)
    aux = x.new_zeros(())
    for i in range(cfg["num_hidden_layers"]):
        x, a = checkpoint(_layer, i, cfg, params, num, x, bias, valid, rot, scale, use_reentrant=False)
        aux = aux + a
    x = _rms(x, params["encoder.ln_final.weight"], cfg["rms_norm_eps"])
    x = torch.gather(x, 1, batch["positions"].long()[..., None].expand(-1, -1, d))
    labels = batch["labels"].reshape(-1).long()
    live = labels != LABEL_PAD
    ce = BlockedTiedCE.apply(x.reshape(-1, d)[live], params["embed_items.weight"], labels[live], cfg["n_items"],
                             block, num)
    return ce + aux


def model_flops(cfg: dict, stats: dict) -> float:
    """3x the forward over the real tokens, without recomputed work: MLA's
    projections, attention over the real query-key pairs, the dense
    SwiGLU, the router, each token's routed experts and the shared ones,
    and the tied head over the catalog."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, pe, dv, r = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    e, k, f = cfg["n_routed_experts"], cfg["num_experts_per_tok"], cfg["moe_intermediate_size"]
    tokens, pairs = stats["tokens"], stats["tokens_sq"]
    mla = 2.0 * tokens * (d * h * (nope + pe) + d * (r + pe) + r * h * (nope + dv) + h * dv * d)
    attention = 2.0 * pairs * h * (nope + pe + dv)
    dense = 2.0 * tokens * 3 * d * cfg["intermediate_size"]
    moe = 2.0 * tokens * (d * e + k * 3 * d * f + 3 * d * cfg["n_shared_experts"] * f)
    layers = cfg["num_hidden_layers"]
    n_dense = min(cfg["first_k_dense_replace"], layers)
    forward = layers * (mla + attention) + n_dense * dense + (layers - n_dense) * moe
    return 3.0 * (forward + 2.0 * stats["labelled"] * cfg["n_items"] * d)
