"""[CLS]/[SEP] sequence chaining at static offsets.

(Copied whole from ``bert4clickpath_tpu/data/chaining.py``, which is numpy
only; keep the two in step.)

Reference semantics (TransformerInputPrep, clickstream_transformer.py:8-103):
chained input is ``[CLS] [SEP] seq_1 [SEP] seq_2 [SEP] ...``, segment 0 is
the CLS summary, segment i is seq_i. Every sequence slot has a *fixed*
padded length, so segment boundaries are constants: ``segment_bounds(i)``
feeds ``ModelConfig.segment_bounds`` directly. Each segment's pads sit
before its trailing [SEP], so a chained row holds pads inside the sequence,
not only at its end.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from bert4clickpath_torch.constants import CLS_ID, SEP_ID


def chained_length(segment_lengths: Sequence[int]) -> int:
    """Total token length: [CLS][SEP] + sum(L_i + 1 trailing SEP each)."""
    return 2 + sum(length + 1 for length in segment_lengths)


def segment_bounds(segment_lengths: Sequence[int], segment: int) -> tuple[int, int]:
    """[start, end) token range of ``segment`` (0 = the CLS token):
    segment 0 -> (0, 1), segment i -> the seq_i span (its trailing SEP
    excluded)."""
    if segment == 0:
        return (0, 1)
    start = 2
    for i, length in enumerate(segment_lengths, start=1):
        if i == segment:
            return (start, start + length)
        start += length + 1
    raise ValueError(f"segment {segment} out of range")


def chain_sequences(padded_seqs: Sequence[np.ndarray]) -> np.ndarray:
    """Chain (B, L_i) int32 model-space padded sequences into
    (B, chained_length) tokens: ``[CLS][SEP] s1 [SEP] s2 [SEP] ...``; each
    segment's SEP sits after its pads."""
    b = padded_seqs[0].shape[0]
    cls_col = np.full((b, 1), CLS_ID, dtype=np.int32)
    sep_col = np.full((b, 1), SEP_ID, dtype=np.int32)
    parts = [cls_col, sep_col]
    for seq in padded_seqs:
        if seq.shape[0] != b:
            raise ValueError(f"segment of {seq.shape[0]} rows chained to {b}")
        parts.append(seq.astype(np.int32))
        parts.append(sep_col)
    return np.concatenate(parts, axis=1)
