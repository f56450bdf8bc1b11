"""Packed ragged layout of id sequences (the part of
``bert4clickpath_tpu/data/etl.py`` the batch pipeline and the training
script need, copied: it is numpy only).

A list of 1-D sequences becomes one flat ``values`` array plus ``offsets``
(``len + 1`` entries), the layout the native batcher reads and the
``<prefix>_i_of_n.npz`` shards of a prepared data directory hold.
"""

from __future__ import annotations

import glob
import re
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


def unpack_ragged(packed: dict) -> list[np.ndarray]:
    values, offsets = packed["values"], packed["offsets"]
    return [values[offsets[i] : offsets[i + 1]] for i in range(len(offsets) - 1)]


def read_packed(path_glob: str) -> list[np.ndarray]:
    """Read all shards matching a glob, in shard order."""

    def shard_key(p):
        m = re.search(r"_(\d+)_of_(\d+)\.npz$", p)
        return int(m.group(1)) if m else 0

    out: list[np.ndarray] = []
    for fname in sorted(glob.glob(path_glob), key=shard_key):
        with np.load(fname, allow_pickle=False) as z:
            out.extend(unpack_ragged({"values": z["values"], "offsets": z["offsets"]}))
    return out
