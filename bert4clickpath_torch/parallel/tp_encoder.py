"""The tensor-parallel encoder: one rank's slices of the encoder, run as
Megatron runs them (counterpart of ``TPEncoderApply``,
``bert4clickpath_tpu/parallel/tp_spmd.py:81-172``).

The JAX package writes this encoder once, for its composed tier, because
its plain tensor-parallel tier (``tp.py``) leaves the split to pjit's
partitioner. Both of the port's tiers are explicit per-rank programs, so
both run this one module: ``parallel/tp.py`` with a replicated item table
and the dense loss, ``parallel/tp_spmd.py`` with the row-sharded table and
the sharded fused CE. It sits in a module of its own so that ``spmd.py``
(which checks which encoder a model carries), ``tp.py`` and ``tp_spmd.py``
all import it without a cycle.

Layout over the model group of S ranks, each rank holding H / S heads:

* ``wq``, ``wk``, ``wv`` and ``ffn1`` are column-parallel: a rank holds
  rows of the torch ``(out, in)`` weight and the same rows of the bias;
* ``wo`` and ``ffn2`` are row-parallel (:class:`RowParallelDense`): a rank
  holds columns of the weight; the bias is replicated and added once,
  after the sum;
* the LayerNorms are replicated.

Each sublayer's input passes ``psum_bwd`` ("f") before the column-parallel
projections; the attention kernel runs on the rank's D / S columns with
H / S heads (``ops/kernels/attention.py:mha`` takes heads as column ranges
of any slice). Dropout acts only on replicated tensors (the encoder input
and each sublayer's output after the sum), so the model ranks of one data
group, whose generators are seeded alike (``spmd.tier_generator``), draw
the same masks and stay bit-equal. Parameter names are the single-device
``Encoder``'s, so a full state maps onto the slices by name.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bert4clickpath_torch.models.encoder import Dense, LayerNorm, apply_dropout
from bert4clickpath_torch.ops.kernels.attention import mha
from bert4clickpath_torch.parallel.collectives import psum_bwd, psum_fwd
from bert4clickpath_torch.parallel.mesh import Mesh


def check_divisible(config, model_shards: int) -> None:
    """Heads and the FFN width must cut into equal slices."""
    if config.num_heads % model_shards:
        raise ValueError(f"num_heads {config.num_heads} not divisible by model axis {model_shards}")
    if config.ffn_dim % model_shards:
        raise ValueError(f"ffn_dim {config.ffn_dim} not divisible by model axis {model_shards}")


class RowParallelDense(nn.Module):
    """A Dense whose input width is sharded: ``weight`` (out, in / S) is
    this rank's columns, ``bias`` (out,) is replicated. The partial product
    takes operands in the compute dtype and sums in f32 (the JAX code's
    ``preferred_element_type=f32``), the sum over the model group runs in
    f32, the result is rounded once to the compute dtype, and then the bias
    is added in that dtype."""

    def __init__(self, in_local: int, out_features: int, dtype: torch.dtype, mesh: Mesh, *, device):
        super().__init__()
        self.dtype = dtype
        self.mesh = mesh
        self.weight = nn.Parameter(torch.empty(out_features, in_local, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        part = F.linear(x.to(self.dtype).float(), self.weight.to(self.dtype).float())
        return psum_fwd(part, self.mesh).to(self.dtype) + self.bias.to(self.dtype)


class TPAttention(nn.Module):
    def __init__(self, d_model: int, local_heads: int, d_local: int, dtype: torch.dtype, mesh: Mesh, *, device):
        super().__init__()
        self.local_heads = local_heads
        self.wq = Dense(d_model, d_local, dtype, device=device)
        self.wk = Dense(d_model, d_local, dtype, device=device)
        self.wv = Dense(d_model, d_local, dtype, device=device)
        self.wo = RowParallelDense(d_local, d_model, dtype, mesh, device=device)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.wo(mha(self.wq(x), self.wk(x), self.wv(x), bias, self.local_heads))


class TPEncoderLayer(nn.Module):
    def __init__(self, config, dtype: torch.dtype, mesh: Mesh, dropout_impl: str, *, device):
        super().__init__()
        s = mesh.model_size
        d = config.d_model
        self.mesh = mesh
        self.norm_style = config.norm_style
        self.dropout_rate = config.dropout_rate
        self.dropout_impl = dropout_impl
        self.mha = TPAttention(d, config.num_heads // s, d // s, dtype, mesh, device=device)
        self.ln1 = LayerNorm(d, dtype, device=device)
        self.ln2 = LayerNorm(d, dtype, device=device)
        self.ffn1 = Dense(d, config.ffn_dim // s, dtype, device=device)
        self.ffn2 = RowParallelDense(config.ffn_dim // s, d, dtype, mesh, device=device)

    def forward(
        self, x: torch.Tensor, bias: torch.Tensor, generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        drop = lambda t: apply_dropout(t, self.dropout_rate, generator, self.dropout_impl)  # noqa: E731
        ffn = lambda t: self.ffn2(F.relu(self.ffn1(psum_bwd(t, self.mesh))))  # noqa: E731
        if self.norm_style == "pre":
            x = x + drop(self.mha(psum_bwd(self.ln1(x), self.mesh), bias))
            return x + drop(ffn(self.ln2(x)))
        x = self.ln1(x + drop(self.mha(psum_bwd(x, self.mesh), bias)))
        return self.ln2(x + drop(ffn(x)))


class TPEncoder(nn.Module):
    """The encoder of ``models/encoder.py`` with this rank's slices, for a
    model group of ``mesh.model_size`` ranks; allocated uninitialised (the
    tiers' shard functions fill it from a full state)."""

    def __init__(self, config, mesh: Mesh, dropout_impl: str = "mask", *, device):
        super().__init__()
        check_divisible(config, mesh.model_size)
        dtype = torch.bfloat16 if config.dtype == "bfloat16" else torch.float32
        self.num_layers = config.num_layers
        self.dropout_rate = config.dropout_rate
        self.dropout_impl = dropout_impl
        for i in range(config.num_layers):
            self.add_module(f"layer_{i}", TPEncoderLayer(config, dtype, mesh, dropout_impl, device=device))
        self.ln_final: Optional[LayerNorm] = (
            LayerNorm(config.d_model, dtype, device=device) if config.norm_style == "pre" else None
        )

    def forward(
        self, x: torch.Tensor, bias: torch.Tensor, generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        x = apply_dropout(x, self.dropout_rate, generator, self.dropout_impl)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, bias, generator)
        if self.ln_final is not None:
            x = self.ln_final(x)
        return x
