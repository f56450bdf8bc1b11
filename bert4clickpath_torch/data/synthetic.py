"""Synthetic long-session workload: the configuration and batches of
``examples/long_context/bench.py``, shared by
``examples/long_context/bench_torch.py`` and ``chip_smoke.py``.

:func:`synthetic_batch` is a numpy copy of
``examples/large_catalog/stress.py:synthetic_batch`` (that module imports
jax): the same draws from the same generator give the same batch.
:func:`seeded_state_dict` makes random weights from a numpy seed (the port
allocates parameters uninitialised; weights otherwise come from a bundle or
from ``convert.state_dict_from_flax``).
"""

from __future__ import annotations

import numpy as np
import torch

from bert4clickpath_torch.config import FeatureConfig, HeadConfig, ModelConfig
from bert4clickpath_torch.constants import (
    CLS_ID,
    LABEL_PAD,
    MASK_ID,
    NUM_RESERVED_TOKENS,
    PAD_ID,
    SEP_ID,
)
from bert4clickpath_torch.models.encoder import LayerNorm
from bert4clickpath_torch.models.model import ClickstreamModel
from bert4clickpath_torch.ops.fused_ce import padded_rows


def synthetic_batch(rng: np.random.Generator, batch: int, max_items: int, max_masked: int, n_items: int) -> dict:
    """Uniform-random sessions directly in model space: (B, max_items + 3)
    int32 tokens ``[CLS][SEP] items... [PAD]... [SEP]`` with 5 to max_items
    items, up to ``max_masked`` of them (40%) replaced by [MASK], their
    positions and label-space ids."""
    length = max_items + 3
    tokens = np.full((batch, length), PAD_ID, np.int32)
    tokens[:, 0] = CLS_ID
    tokens[:, 1] = SEP_ID
    tokens[:, -1] = SEP_ID
    lens = rng.integers(5, max_items + 1, size=batch)
    positions = np.zeros((batch, max_masked), np.int32)
    labels = np.full((batch, max_masked), LABEL_PAD, np.int32)
    for i in range(batch):
        n = lens[i]
        items = rng.integers(0, n_items, size=n).astype(np.int32)
        tokens[i, 2 : 2 + n] = items + NUM_RESERVED_TOKENS
        n_masked = min(max_masked, max(1, int(0.4 * n)))
        picks = np.sort(rng.permutation(n)[:n_masked])
        labels[i, :n_masked] = items[picks]
        tokens[i, 2 + picks] = MASK_ID
        positions[i, :n_masked] = picks + 2
    return {
        "features": {"items": tokens},
        "head_positions": positions,
        "labels": labels,
    }


def long_context_config(
    seq_len: int = 1024, items: int = 20_000, d_model: int = 256, layers: int = 4,
    heads: int = 4, dropout: float = 0.1, dtype: str = "bfloat16",
) -> ModelConfig:
    """The model of ``examples/long_context/bench.py:101-113``: learned
    positions up to ``seq_len``, FFN 4 x d_model, post-LN, a tied softmax
    over ``items`` labels whose table rows are padded as the fused CE wants
    them (20,480 rows for 20,000 items)."""
    return ModelConfig(
        features={"items": FeatureConfig(padded_rows(items + 11), d_model)},
        num_layers=layers,
        num_heads=heads,
        ffn_dim=4 * d_model,
        dropout_rate=dropout,
        max_len=seq_len,
        positional="learned",
        head=HeadConfig("tied_softmax", output_size=items),
        dtype=dtype,
    )


def seeded_state_dict(cfg: ModelConfig, seed: int) -> dict:
    """Random weights from a numpy seed: N(0, 0.02) matrices and tables,
    zero biases, LayerNorm scale 1 / bias 0."""
    rng = np.random.default_rng(seed)
    skeleton = ClickstreamModel(cfg, device="meta")
    ln_scales = {f"{n}.weight" for n, m in skeleton.named_modules() if isinstance(m, LayerNorm)}
    sd = {}
    for key, t in skeleton.state_dict().items():
        if key in ln_scales:
            arr = np.ones(t.shape, np.float32)
        elif key.endswith("bias"):
            arr = np.zeros(t.shape, np.float32)
        else:
            arr = rng.standard_normal(t.shape, dtype=np.float32) * np.float32(0.02)
        sd[key] = torch.from_numpy(arr)
    return sd
