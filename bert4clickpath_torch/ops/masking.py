"""Padding-mask helpers (counterpart of ``bert4clickpath_tpu/ops/masking.py``).

Masks are additive attention biases with static shapes, computed once per
batch from the integer token ids.
"""

from __future__ import annotations

import torch

from bert4clickpath_torch.constants import PAD_ID

# Large-negative bias added to attention logits at padded key positions.
# Finite (not -inf) so fully-padded rows still softmax to a uniform
# distribution instead of NaN. The reference used -1e9 (transformer.py:91).
NEG_INF = -1e9


def padding_bias(tokens: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(B, L) int tokens -> (B, 1, 1, L) additive attention bias.

    0 where the key position is real, ``NEG_INF`` where it is ``[PAD]``.
    """
    pad = (tokens == PAD_ID).to(dtype) * NEG_INF
    return pad[:, None, None, :]


def valid_token_mask(tokens: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(B, L) int tokens -> (B, L) {0,1} mask of non-pad positions."""
    return (tokens != PAD_ID).to(dtype)


def segment_ids(tokens: torch.Tensor, sep_id: int) -> torch.Tensor:
    """Cumulative-SEP segment markers:
    ``[CLS][SEP] s1 [SEP] s2 [SEP]`` -> ``0 1 1.. 2 2.. 3``."""
    return torch.cumsum((tokens == sep_id).to(torch.int32), dim=-1, dtype=torch.int32)
