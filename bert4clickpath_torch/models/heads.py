"""Task heads (counterpart of ``bert4clickpath_tpu/models/heads.py``).

Only the softmax ("parity") head is ported so far, so that an export with
the reference's MLP head can be served; the binary and multilabel heads
come with their slices. The tied-weight head lives in
:mod:`bert4clickpath_torch.models.model` because it shares the item table.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bert4clickpath_torch.models.encoder import Dense


class _MLP(nn.Module):
    """Dense + ReLU per configured dim (flax names ``dense_{i}``)."""

    def __init__(self, in_dim: int, dense_dims: tuple[int, ...], dtype: torch.dtype, *, device):
        super().__init__()
        self.n = len(dense_dims)
        for i, dim in enumerate(dense_dims):
            self.add_module(f"dense_{i}", Dense(in_dim, dim, dtype, device=device))
            in_dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = F.relu(getattr(self, f"dense_{i}")(x))
        return x


class SoftmaxHead(nn.Module):
    """MLP -> V logits per position. ``trunk`` is everything up to (but
    excluding) the final ``out`` projection, whose rows the serving path
    ranks as the catalog."""

    def __init__(
        self, in_dim: int, dense_dims: tuple[int, ...], output_size: int,
        dtype: torch.dtype, *, device,
    ):
        super().__init__()
        self.mlp = _MLP(in_dim, dense_dims, dtype, device=device)
        self.out = Dense(dense_dims[-1] if dense_dims else in_dim, output_size, dtype, device=device)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(self.mlp(x))
