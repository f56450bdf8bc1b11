"""Bidirectional (encoder-only) Transformer stack.

Counterpart of ``bert4clickpath_tpu/models/encoder.py``: post-LN (or pre-LN
plus a final LayerNorm) residual blocks, ReLU feed-forward, padding-masked
bidirectional attention, LayerNorm eps 1e-6, dropout on the encoder input,
the attention output and the FFN output.

Dropout is live only when the caller passes a ``torch.Generator`` (the
train step does; serving and eval pass none): each of the three sites
draws its keep mask from that generator, never from the global RNG, as
flax's ``nn.Dropout`` draws from the step's ``dropout`` key. The RNG
streams cannot match JAX's bits, so parity runs use dropout 0.

Attention always goes through :func:`bert4clickpath_torch.ops.kernels.
attention.mha` (the CUDA kernel on the card, its plain version on the CPU);
the JAX package's ``attn_impl`` choices are not carried over.

Parameters are f32 and allocated uninitialised: weights always come from a
state_dict (``convert.state_dict_from_flax`` or an exported bundle). The
compute dtype follows flax's ``dtype=`` convention: :class:`Dense` casts its
input, weight and bias to it, and :class:`LayerNorm` normalizes in f32 and
rounds once to it. Module and parameter names mirror the flax tree.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bert4clickpath_torch.ops.kernels.attention import mha


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept
    values by 1 / (1 - rate) in x's dtype; identity without a generator or
    at rate 0."""
    if generator is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class Dense(nn.Module):
    """flax ``nn.Dense`` with f32 params and a compute dtype. ``weight`` is
    (out, in), the transpose of flax's (in, out) ``kernel``."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype, *, device):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-6, dtype=...)``: statistics and the
    affine step in f32, one rounding to the compute dtype."""

    def __init__(self, dim: int, dtype: torch.dtype, eps: float = 1e-6, *, device):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, self.eps)
        return y.to(self.dtype)


class MultiHeadAttention(nn.Module):
    def __init__(
        self, d_model: int, num_heads: int, dtype: torch.dtype,
        qkv_fused: bool = False, *, device,
    ):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by num_heads {num_heads}")
        self.d_model = d_model
        self.num_heads = num_heads
        self.qkv_fused = qkv_fused
        if qkv_fused:
            # one (D, 3D) projection; q/k/v are column slices that the kernel
            # reads through their strides (no copy)
            self.wqkv = Dense(d_model, 3 * d_model, dtype, device=device)
        else:
            self.wq = Dense(d_model, d_model, dtype, device=device)
            self.wk = Dense(d_model, d_model, dtype, device=device)
            self.wv = Dense(d_model, d_model, dtype, device=device)
        self.wo = Dense(d_model, d_model, dtype, device=device)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        d = self.d_model
        if self.qkv_fused:
            qkv = self.wqkv(x)
            q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
        else:
            q, k, v = self.wq(x), self.wk(x), self.wv(x)
        return self.wo(mha(q, k, v, bias, self.num_heads))


class EncoderLayer(nn.Module):
    def __init__(
        self, d_model: int, num_heads: int, ffn_dim: int, dropout_rate: float,
        dtype: torch.dtype, qkv_fused: bool = False, norm_style: str = "post",
        *, device,
    ):
        super().__init__()
        self.norm_style = norm_style
        self.mha = MultiHeadAttention(d_model, num_heads, dtype, qkv_fused, device=device)
        self.ln1 = LayerNorm(d_model, dtype, device=device)
        self.ln2 = LayerNorm(d_model, dtype, device=device)
        self.ffn1 = Dense(d_model, ffn_dim, dtype, device=device)
        self.ffn2 = Dense(ffn_dim, d_model, dtype, device=device)
        self.dropout_rate = dropout_rate

    def forward(
        self, x: torch.Tensor, bias: torch.Tensor, generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        drop = lambda t: dropout(t, self.dropout_rate, generator)  # noqa: E731
        if self.norm_style == "pre":
            x = x + drop(self.mha(self.ln1(x), bias))
            return x + drop(self.ffn2(F.relu(self.ffn1(self.ln2(x)))))
        # post-LN residual (reference transformer.py:202-213)
        x = self.ln1(x + drop(self.mha(x, bias)))
        return self.ln2(x + drop(self.ffn2(F.relu(self.ffn1(x)))))


class Encoder(nn.Module):
    def __init__(
        self, num_layers: int, d_model: int, num_heads: int, ffn_dim: int,
        dropout_rate: float, dtype: torch.dtype, qkv_fused: bool = False,
        norm_style: str = "post", *, device,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.dropout_rate = dropout_rate
        for i in range(num_layers):
            self.add_module(
                f"layer_{i}",
                EncoderLayer(
                    d_model, num_heads, ffn_dim, dropout_rate, dtype, qkv_fused,
                    norm_style, device=device,
                ),
            )
        # pre-LN leaves the residual stream un-normalized; one final LN feeds
        # the head the same normalized scale post-LN produces
        self.ln_final: Optional[LayerNorm] = (
            LayerNorm(d_model, dtype, device=device) if norm_style == "pre" else None
        )

    def forward(
        self, x: torch.Tensor, bias: torch.Tensor, generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        x = dropout(x, self.dropout_rate, generator)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, bias, generator)
        if self.ln_final is not None:
            x = self.ln_final(x)
        return x
