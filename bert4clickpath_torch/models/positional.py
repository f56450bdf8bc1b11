"""Position encodings (counterpart of ``bert4clickpath_tpu/models/positional.py``).

* Sinusoidal — computed once as a constant with the JAX package's formula
  (even dims sin, odd dims cos, base 10000).
* Learned — one (max_len, d_model) f32 parameter named ``embedding``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def sinusoidal_positions(max_len: int, d_model: int) -> np.ndarray:
    """(max_len, d_model) float32 sinusoidal table."""
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    i = np.arange(d_model, dtype=np.float32)[None, :]
    angle_rates = 1.0 / np.power(10000.0, (2.0 * (i // 2)) / np.float32(d_model))
    angles = pos * angle_rates
    table = np.zeros((max_len, d_model), dtype=np.float32)
    table[:, 0::2] = np.sin(angles[:, 0::2])
    table[:, 1::2] = np.cos(angles[:, 1::2])
    return table


class LearnedPositions(nn.Module):
    """Learned position table; allocated uninitialised, filled from a
    state_dict (``positions.embedding``)."""

    def __init__(self, max_len: int, d_model: int, *, device):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.empty(max_len, d_model, dtype=torch.float32, device=device)
        )

    def forward(self, seq_len: int) -> torch.Tensor:
        return self.embedding[:seq_len]
