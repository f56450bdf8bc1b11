"""Cloze (masked-item) batch construction — host side, fixed shapes.

(Copied whole from ``bert4clickpath_tpu/data/cloze.py``, which is numpy
only, so that the port never imports the JAX package. Keep the two in
step: the tests hold the port's batches to the JAX package's, bit for bit.)

TPU-native rework of the reference input pipeline
(examples/BERT4Rec/source/input_pipeline.py):

* TRAIN (input_pipeline.py:99-114): drop the last item (leave-one-out
  holdout), then mask ``floor(0.4 * len)`` clipped to [0, 10] randomly chosen
  unique positions, order-preserving (random_choice :21-32,
  random_item_mask :59-74).
* EVAL (input_pipeline.py:115-120): mask only the last item.

Instead of ragged tensors padded to longest-in-batch
(input_pipeline.py:198-214), every batch is **statically shaped**:

* tokens: ``(B, L)`` int32 model-space ids laid out
  ``[CLS][SEP] items... [PAD]... [SEP]`` — the same chain the reference
  builds for a single sequence (clickstream_transformer.py:38-63, where the
  trailing SEP also lands after the pads because chaining runs post-padding).
* head_positions: ``(B, P)`` int32 token indices of the [MASK]s (0-padded);
* labels: ``(B, P)`` int32 label-space ids with LABEL_PAD fill.

This deletes the ragged [MASK]-gather and the per-replica-pad adaptor
(clickstream_transformer.py:260-297, source/utils.py:56-113) by
construction, and makes masking deterministic and seedable across hosts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from bert4clickpath_torch.constants import (
    CLS_ID,
    LABEL_PAD,
    MASK_ID,
    MASKED_PERCENTAGE,
    MAX_MASKED_ITEMS,
    NUM_RESERVED_TOKENS,
    PAD_ID,
    SEP_ID,
)

# [CLS] [SEP] ... [SEP] around the single item sequence.
N_SPECIAL = 3
ITEM_OFFSET = 2  # token index of the first item


@dataclass
class ClozeBatch:
    """One fixed-shape device batch (still on host as numpy)."""

    features: dict[str, np.ndarray]  # {'items': (B, L) int32 model-space}
    head_positions: np.ndarray  # (B, P) int32 token indices of [MASK]s
    labels: np.ndarray  # (B, P) int32 label-space, LABEL_PAD padded

    @property
    def batch_size(self) -> int:
        return self.labels.shape[0]


def stack_batches(batches: Sequence[ClozeBatch]) -> ClozeBatch:
    """Stack K same-shape batches into one with a leading (K, ...) axis —
    the host half of the scan-train-step path (one transfer + one dispatch
    per K steps; training/train_state.make_scan_train_step)."""
    return ClozeBatch(
        {
            k: np.stack([b.features[k] for b in batches])
            for k in batches[0].features
        },
        np.stack([b.head_positions for b in batches]),
        np.stack([b.labels for b in batches]),
    )


def token_length(max_items: int) -> int:
    return max_items + N_SPECIAL


def _empty_batch(
    batch: int, max_items: int, max_masked: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    length = token_length(max_items)
    tokens = np.full((batch, length), PAD_ID, dtype=np.int32)
    tokens[:, 0] = CLS_ID
    tokens[:, 1] = SEP_ID
    tokens[:, -1] = SEP_ID
    positions = np.zeros((batch, max_masked), dtype=np.int32)
    labels = np.full((batch, max_masked), LABEL_PAD, dtype=np.int32)
    return tokens, positions, labels


def make_train_batch(
    sequences: Sequence[np.ndarray],
    rng: np.random.Generator,
    max_items: int = 50,
    max_masked: int = MAX_MASKED_ITEMS,
    masked_percentage: float = MASKED_PERCENTAGE,
    feature_name: str = "items",
) -> ClozeBatch:
    """Build a training batch from label-space id sequences.

    Each sequence loses its last item (the eval holdout), then
    ``int(n * masked_percentage)`` clipped to [0, max_masked] positions are
    masked (reference input_pipeline.py:59-74,99-114).
    """
    b = len(sequences)
    tokens, positions, labels = _empty_batch(b, max_items, max_masked)
    for i, seq in enumerate(sequences):
        # Drop-last holdout, then keep the most recent window: training must
        # see the events adjacent to the held-out item (serving.py uses the
        # same last-window convention), not the oldest prefix.
        items = np.asarray(seq[:-1], dtype=np.int32)[-max_items:]
        n = len(items)
        row = items + NUM_RESERVED_TOKENS  # label -> model space
        n_masked = int(np.clip(int(n * masked_percentage), 0, max_masked))
        if n_masked > 0:
            picks = np.sort(rng.permutation(n)[:n_masked])
            labels[i, :n_masked] = items[picks]
            row = row.copy()
            row[picks] = MASK_ID
            positions[i, :n_masked] = picks + ITEM_OFFSET
        tokens[i, ITEM_OFFSET : ITEM_OFFSET + n] = row
    return ClozeBatch({feature_name: tokens}, positions, labels)


def make_eval_batch(
    sequences: Sequence[np.ndarray],
    max_items: int = 50,
    max_masked: int = MAX_MASKED_ITEMS,
    feature_name: str = "items",
) -> ClozeBatch:
    """Leave-one-out eval: the full sequence with only its last item masked
    (reference input_pipeline.py:115-120). Rows beyond ``len(sequences)``
    callers may add for padding are all-LABEL_PAD and drop out of metrics.

    Emits WIDTH-1 positions/labels: leave-one-out scores exactly one slot
    per user, and a max_masked-wide batch would make every eval forward
    gather — and the full-catalog scan score — max_masked positions of
    which all but one are padding (a ~P× waste; eval dominates quality-run
    wall clock). ``max_masked`` is kept for signature compatibility.
    """
    b = len(sequences)
    tokens, positions, labels = _empty_batch(b, max_items, 1)
    for i, seq in enumerate(sequences):
        # Most-recent window so the masked position is the true last item.
        items = np.asarray(seq, dtype=np.int32)[-max_items:]
        n = len(items)
        if n == 0:  # degenerate row: all-LABEL_PAD, drops out of metrics
            continue
        row = items + NUM_RESERVED_TOKENS
        row[-1] = MASK_ID
        labels[i, 0] = items[-1]
        positions[i, 0] = (n - 1) + ITEM_OFFSET
        tokens[i, ITEM_OFFSET : ITEM_OFFSET + n] = row
    return ClozeBatch({feature_name: tokens}, positions, labels)


def pad_batch(batch: ClozeBatch, to_size: int) -> ClozeBatch:
    """Pad a short (final eval) batch to the static batch size with rows whose
    labels are all LABEL_PAD — masked losses/metrics ignore them exactly."""
    b = batch.batch_size
    if b == to_size:
        return batch
    assert b < to_size
    pad = to_size - b
    feats = {}
    for k, v in batch.features.items():
        filler = np.full((pad, v.shape[1]), PAD_ID, dtype=v.dtype)
        filler[:, 0] = CLS_ID
        filler[:, 1] = SEP_ID
        filler[:, -1] = SEP_ID
        feats[k] = np.concatenate([v, filler], axis=0)
    positions = np.concatenate(
        [batch.head_positions, np.zeros((pad, batch.head_positions.shape[1]), np.int32)]
    )
    labels = np.concatenate(
        [batch.labels, np.full((pad, batch.labels.shape[1]), LABEL_PAD, np.int32)]
    )
    return ClozeBatch(feats, positions, labels)
