"""Plain float32 reference of the DeepSeek-V2 block as the Cloze encoder.

Written in plain PyTorch from the published description (DeepSeek-V2,
https://arxiv.org/abs/2405.04434, and DeepSeek-V2-Lite's ``config.json``);
it imports neither JAX nor anything of the port. Callers turn TF32 off
(:func:`exact_float32` does). The configuration is a dict with the
published keys (``hidden_size``, ``num_attention_heads``, ``kv_lora_rank``,
``qk_nope_head_dim``, ``qk_rope_head_dim``, ``v_head_dim``,
``intermediate_size``, ``moe_intermediate_size``, ``n_routed_experts``,
``num_experts_per_tok``, ``n_shared_experts``, ``first_k_dense_replace``,
``num_hidden_layers``, ``rms_norm_eps``, ``rope_theta``, ``rope_scaling``)
and ``aux_loss_alpha``, ``n_items``.

The model, with parameters named as the port names them:

* item ids looked up in the table ``embed_items.weight`` and scaled by
  sqrt(hidden_size) (BERT4Rec's input; no positions are added);
* per layer, pre-RMSNorm: h = x + MLA(RMSNorm(x)), out = h +
  FFN(RMSNorm(h)); RMSNorm is x / sqrt(mean(x^2) + eps) * w;
* MLA without query compression: q = x W_q, per head [nope 128 | rope 64];
  c = x W_kva split into c_kv (512, RMS-normed) and one RoPE key k_pe (64)
  for all heads; [k_nope | v] = c_kv W_kvb per head; RoPE rotates the
  interleaved pairs (x[2i], x[2i+1]) by the angle pos * inv_freq[i] (here as
  complex products, the layout kept interleaved: Hugging Face's model lays
  the rotated pairs out de-interleaved, a permutation of q_pe and k_pe alike
  that leaves every score unchanged); inv_freq is YaRN's (factor 40 beyond
  the correction range, ramped inside it) and the softmax scale
  qk_head_dim^-1/2 mscale^2 with mscale = 0.1 mscale_all_dim ln(factor) + 1;
  padded keys masked with -1e9; then W_o;
* the FFN: SwiGLU W_down(silu(W_gate x) * W_up x), the gate and up
  projections stacked as one (2F, D) weight, gate rows first; dense
  (intermediate_size) in the first first_k_dense_replace layers, else a
  mixture of experts: router softmax(x W_r^T) in f32, greedy top-k, weights
  not renormalised (norm_topk_prob false, routed_scaling_factor 1), no
  token dropped, each expert a SwiGLU of moe_intermediate_size (stacked
  (E, 2F, D) and (E, D, F) weights), plus the shared experts as one SwiGLU
  of n_shared_experts * moe_intermediate_size; padding tokens are routed
  nowhere (a departure: the published model routes every position);
* a final RMSNorm, the Cloze positions gathered, a softmax tied to the item
  table's rows [10, 10 + n_items): the mean NLL over labelled rows;
* plus the sequence-wise balance loss (seq_aux) of each MoE layer:
  alpha sum_i f_i P_i per session over its T real tokens, f_i = E / (k T)
  #{t : i in topk(t)}, P_i = (1 / T) sum_t s_ti, averaged over the sessions
  (a departure: the published loss counts every position of a sequence).

Departures from the published model besides those two: the tied Cloze head
in place of the untied ``lm_head``, the item table's sqrt(d) scale, no
causal mask (the encoder is bidirectional, as BERT4Rec's).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

NUM_RESERVED = 10
PAD_ID = 0
LABEL_PAD = -1
NEG_INF = -1e9


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convolutions while the block runs."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def yarn(cfg: dict) -> tuple[torch.Tensor, float]:
    """(inv_freq (dim / 2,) f64, softmax scale)."""
    rs = cfg["rope_scaling"]
    dim, theta, factor = cfg["qk_rope_head_dim"], cfg["rope_theta"], rs["factor"]

    def corr(rot):
        return dim * math.log(rs["original_max_position_embeddings"] / (rot * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    i = torch.arange(dim // 2, dtype=torch.float64)
    base = 1.0 / theta ** (2 * i / dim)
    ramp = torch.clamp((i - low) / max(high - low, 1e-3), 0, 1)
    inv_freq = base / factor * ramp + base * (1 - ramp)
    mscale = 0.1 * rs["mscale_all_dim"] * math.log(factor) + 1.0
    return inv_freq, (cfg["qk_nope_head_dim"] + dim) ** -0.5 * mscale * mscale


def rotate(x, angles):
    """Interleaved pairs of the last axis rotated by ``angles`` (L, dim / 2)
    broadcast over the leading axes but L (axis 1)."""
    z = torch.view_as_complex(x.float().reshape(*x.shape[:-1], -1, 2).contiguous())
    rot = torch.polar(torch.ones_like(angles), angles).to(torch.complex64)
    rot = rot.reshape(1, angles.shape[0], *([1] * (x.dim() - 3)), angles.shape[1])
    return torch.view_as_real(z * rot).reshape(x.shape)


def swiglu(x, w_gate_up, w_down):
    f = w_down.shape[-1]
    gu = x @ w_gate_up.t()
    return (F.silu(gu[..., :f]) * gu[..., f:]) @ w_down.t()


def mla(x, p, pre, cfg, bias, angles, scale):
    b, l, _ = x.shape
    h = cfg["num_attention_heads"]
    nope, pe, dv, r = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = (x @ p[pre + "wq.weight"].t()).reshape(b, l, h, nope + pe)
    q = torch.cat([q[..., :nope], rotate(q[..., nope:], angles)], -1)
    c = x @ p[pre + "wkv_a.weight"].t()
    c_kv = rms_norm(c[..., :r], p[pre + "kv_norm.weight"], cfg["rms_norm_eps"])
    k_pe = rotate(c[..., r:], angles)
    kv = (c_kv @ p[pre + "wkv_b.weight"].t()).reshape(b, l, h, nope + dv)
    k = torch.cat([kv[..., :nope], k_pe[:, :, None, :].expand(b, l, h, pe)], -1)
    v = kv[..., nope:]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale + bias
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v).reshape(b, l, h * dv)
    return o @ p[pre + "wo.weight"].t()


def moe(x, p, pre, cfg, valid):
    """(out, aux): the routed and shared experts, and the balance loss."""
    b, l, d = x.shape
    e, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    flat = x.reshape(-1, d)
    scores = torch.softmax(flat.float() @ p[pre + "router"].t().float(), -1)
    weights, experts = scores.topk(k, -1)
    real = valid.reshape(-1)
    out = torch.zeros_like(flat)
    for i in range(e):
        tokens, slots = torch.nonzero((experts == i) & real[:, None], as_tuple=True)
        if tokens.numel():
            y = swiglu(flat[tokens], p[pre + "experts.w_gate_up"][i], p[pre + "experts.w_down"][i])
            out = out.index_add(0, tokens, y * weights[tokens, slots, None])
    out = out + swiglu(flat, p[pre + "shared.gate_up.weight"], p[pre + "shared.down.weight"])
    # the balance loss, session by session over the real tokens
    aux = []
    for s in range(b):
        m = valid[s]
        t = int(m.sum())
        if t == 0:
            continue
        sc = scores.view(b, l, e)[s][m]
        hits = torch.zeros(e).index_add_(0, experts.view(b, l, k)[s][m].reshape(-1).cpu(), torch.ones(t * k))
        f = hits.to(sc.device) * e / (k * t)
        aux.append(cfg["aux_loss_alpha"] * (f * sc.mean(0)).sum())
    return out.reshape(b, l, d), torch.stack(aux).mean() if aux else flat.new_zeros(())


def forward(params: dict, cfg: dict, tokens: torch.Tensor):
    """(hidden (B, L, D) after the final norm, the balance losses' sum)."""
    p = params
    d = cfg["hidden_size"]
    b, l = tokens.shape
    valid = tokens != PAD_ID
    bias = torch.where(valid, 0.0, NEG_INF)[:, None, None, :]
    inv_freq, scale = yarn(cfg)
    angles = (torch.arange(l, dtype=torch.float64)[:, None] * inv_freq[None]).float().to(tokens.device)
    x = p["embed_items.weight"][tokens.long()] * math.sqrt(d)
    eps = cfg["rms_norm_eps"]
    aux = x.new_zeros(())
    for i in range(cfg["num_hidden_layers"]):
        pre = f"encoder.layer_{i}."
        x = x + mla(rms_norm(x, p[pre + "attn_norm.weight"], eps), p, pre + "attn.", cfg, bias, angles, scale)
        h = rms_norm(x, p[pre + "ffn_norm.weight"], eps)
        if i < cfg["first_k_dense_replace"]:
            x = x + swiglu(h, p[pre + "ffn.gate_up.weight"], p[pre + "ffn.down.weight"])
        else:
            y, a = moe(h, p, pre + "ffn.", cfg, valid)
            x, aux = x + y, aux + a
    return rms_norm(x, p["encoder.ln_final.weight"], eps), aux


def loss(params: dict, cfg: dict, tokens, positions, labels):
    """(loss, Cloze CE, balance loss): the mean NLL of the labelled rows
    under the tied softmax, plus the balance losses."""
    x, aux = forward(params, cfg, tokens)
    d = cfg["hidden_size"]
    rows = torch.gather(x, 1, positions.long()[..., None].expand(-1, -1, d)).reshape(-1, d)
    lab = labels.reshape(-1).long()
    live = lab != LABEL_PAD
    table = params["embed_items.weight"][NUM_RESERVED : NUM_RESERVED + cfg["n_items"]]
    ce = F.cross_entropy(rows[live] @ table.t(), lab[live])
    return ce + aux, ce, aux
