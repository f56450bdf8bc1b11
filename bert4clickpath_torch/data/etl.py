"""Packed ragged layout of id sequences (the part of
``bert4clickpath_tpu/data/etl.py`` the batch pipeline needs, copied: it is
numpy only).

A list of 1-D sequences becomes one flat ``values`` array plus ``offsets``
(``len + 1`` entries), the layout the native batch builder reads.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def pack_ragged(sequences: Sequence[np.ndarray]) -> dict[str, np.ndarray]:
    """list of 1-D arrays -> {'values', 'offsets'} flat layout."""
    lengths = np.array([len(s) for s in sequences], dtype=np.int64)
    offsets = np.zeros(len(sequences) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    values = (
        np.concatenate([np.asarray(s) for s in sequences])
        if sequences
        else np.array([], dtype=np.int32)
    )
    return {"values": values, "offsets": offsets}
