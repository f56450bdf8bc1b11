"""Bidirectional (encoder-only) Transformer stack.

Counterpart of ``bert4clickpath_tpu/models/encoder.py``: post-LN (or pre-LN
plus a final LayerNorm) residual blocks, ReLU feed-forward, padding-masked
bidirectional attention, LayerNorm eps 1e-6, dropout on the encoder input,
the attention output and the FFN output.

Dropout is live only when the caller passes a ``torch.Generator`` (the
train step does; serving and eval pass none): each of the three sites
draws from that generator, never from the global RNG, as flax's
``nn.Dropout`` draws from the step's ``dropout`` key. ``dropout_impl``
selects the back end, as in the JAX package (:func:`apply_dropout`):
``"mask"`` draws a keep mask with ``torch.rand`` (the counterpart of
``"xla"``, the default), ``"fused"`` draws one int32 seed on the device and
runs the fused dropout kernel, which regenerates the mask in the backward
(the counterpart of ``"pallas"``). The RNG streams cannot match JAX's bits,
so parity runs use dropout 0.

Attention always goes through :func:`bert4clickpath_torch.ops.kernels.
attention.mha`, the counterpart of ``attn_impl="pallas"``: the whole-row
kernels where a head's row fits one block's shared memory, the blockwise
(K/V-streaming) kernels at any longer L (CUDA kernels on the card, their
plain versions on the CPU). The JAX package's ``"xla"`` and ``"auto"``
choices are not carried over.

Parameters are f32 and allocated uninitialised: weights always come from a
state_dict (``convert.state_dict_from_flax`` or an exported bundle). The
compute dtype follows flax's ``dtype=`` convention: :class:`Dense` casts its
input, weight and bias to it, and :class:`LayerNorm` normalizes in f32 and
rounds once to it. Module and parameter names mirror the flax tree.

With a ``block`` (``config.DeepSeekV2Config``) the layers are
``models/deepseek_v2.py:DeepSeekV2Layer`` instead, pre-RMSNorm with a final
RMSNorm.

``remat`` (the JAX ``Encoder.remat``, ``nn.remat(EncoderLayer)``) wraps
each layer in ``torch.utils.checkpoint``: the layer's activations are
recomputed in the backward instead of kept, with the same dropout masks.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from bert4clickpath_torch.config import DeepSeekV2Config
from bert4clickpath_torch.models.deepseek_v2 import DeepSeekV2Layer, RMSNorm
from bert4clickpath_torch.ops.kernels.attention import mha
from bert4clickpath_torch.ops.kernels.dropout import fused_dropout
from bert4clickpath_torch.utils import profiling

DROPOUT_IMPLS = ("mask", "fused")


def apply_dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator], impl: str = "mask",
) -> torch.Tensor:
    """Dropout with a selectable back end; identity without a generator or
    at rate 0. ``"mask"`` is flax ``nn.Dropout``: keep with probability
    1 - rate, scale kept values by 1 / (1 - rate) in x's dtype. ``"fused"``
    draws an int32 seed in [0, 2**31 - 1) from the generator, on x's device
    (no host sync), for :func:`fused_dropout`."""
    if impl not in DROPOUT_IMPLS:
        raise ValueError(f"dropout_impl must be one of {DROPOUT_IMPLS}, got {impl!r}")
    if generator is None or rate == 0.0:
        return x
    if impl == "fused":
        seed = torch.randint(
            0, 2**31 - 1, (1,), generator=generator, device=x.device, dtype=torch.int32
        )
        return fused_dropout(x, seed, rate)
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
        dropout_impl: str = "mask", *, device,
    ):
        super().__init__()
        self.norm_style = norm_style
        self.dropout_impl = dropout_impl
        self.mha = MultiHeadAttention(d_model, num_heads, dtype, qkv_fused, device=device)
        self.ln1 = LayerNorm(d_model, dtype, device=device)
        self.ln2 = LayerNorm(d_model, dtype, device=device)
        self.ffn1 = Dense(d_model, ffn_dim, dtype, device=device)
        self.ffn2 = Dense(ffn_dim, d_model, dtype, device=device)
        self.dropout_rate = dropout_rate

    def forward(
        self, x: torch.Tensor, bias: torch.Tensor, generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        drop = lambda t: apply_dropout(t, self.dropout_rate, generator, self.dropout_impl)  # noqa: E731
        if self.norm_style == "pre":
            x = x + drop(self.mha(self.ln1(x), bias))
            return x + drop(self.ffn2(F.relu(self.ffn1(self.ln2(x)))))
        # post-LN residual (reference transformer.py:202-213)
        x = self.ln1(x + drop(self.mha(x, bias)))
        return self.ln2(x + drop(self.ffn2(F.relu(self.ffn1(x)))))


def _remat_layer(layer: nn.Module, x: torch.Tensor, bias: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """``layer(x, bias, generator)`` under ``torch.utils.checkpoint``: its
    activations are dropped after the forward and recomputed in the
    backward (the attention kernels' autograd Functions run again, nothing
    of theirs is saved). The recompute draws the same dropout masks: the
    generator is rewound to where the forward's draws began for it, then
    put back where the step had taken it, so later draws are unchanged."""
    if generator is None:
        return checkpoint(layer, x, bias, None, use_reentrant=False)
    start = generator.get_state()
    ran = []

    def run(x, bias):
        if not ran:  # the forward
            ran.append(True)
            return layer(x, bias, generator)
        now = generator.get_state()  # the recompute, inside the backward
        generator.set_state(start)
        try:
            return layer(x, bias, generator)
        finally:
            generator.set_state(now)

    return checkpoint(run, x, bias, use_reentrant=False)


class Encoder(nn.Module):
    def __init__(
        self, num_layers: int, d_model: int, num_heads: int, ffn_dim: int,
        dropout_rate: float, dtype: torch.dtype, qkv_fused: bool = False,
        norm_style: str = "post", dropout_impl: str = "mask", remat: bool = False,
        block: Optional[DeepSeekV2Config] = None, *, device,
    ):
        super().__init__()
        if block is not None and dropout_rate:
            raise ValueError("the DeepSeek-V2 block takes no dropout (dropout_rate 0)")
        if dropout_impl not in DROPOUT_IMPLS:
            raise ValueError(f"dropout_impl must be one of {DROPOUT_IMPLS}, got {dropout_impl!r}")
        self.num_layers = num_layers
        self.dropout_rate = dropout_rate
        self.dropout_impl = dropout_impl
        # recompute each layer's activations in the backward (JAX: nn.remat)
        self.remat = remat
        for i in range(num_layers):
            if block is not None:
                dense = ffn_dim if i < block.first_k_dense_replace else None
                layer = DeepSeekV2Layer(d_model, num_heads, block, dense, dtype, device=device)
            else:
                layer = EncoderLayer(
                    d_model, num_heads, ffn_dim, dropout_rate, dtype, qkv_fused,
                    norm_style, dropout_impl, device=device,
                )
            self.add_module(f"layer_{i}", layer)
        # pre-LN leaves the residual stream un-normalized; one final LN feeds
        # the head the same normalized scale post-LN produces
        self.ln_final: Optional[nn.Module] = None
        if block is not None:
            self.ln_final = RMSNorm(d_model, dtype, block.rms_norm_eps, device=device)
        elif norm_style == "pre":
            self.ln_final = LayerNorm(d_model, dtype, device=device)

    def forward(
        self, x: torch.Tensor, bias: torch.Tensor, generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """The input dropout, each layer and pre-LN's final LayerNorm, each
        in the span ``b4cp.encoder``, its backward too."""
        with profiling.block("b4cp.encoder") as blk:
            x = blk.output(apply_dropout(blk.input(x), self.dropout_rate, generator, self.dropout_impl))
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            with profiling.block("b4cp.encoder") as blk:
                x = blk.input(x)
                if self.remat and torch.is_grad_enabled():
                    x = _remat_layer(layer, x, bias, generator)
                else:
                    x = layer(x, bias, generator)
                x = blk.output(x)
        if self.ln_final is not None:
            with profiling.block("b4cp.encoder") as blk:
                x = blk.output(self.ln_final(blk.input(x)))
        return x
