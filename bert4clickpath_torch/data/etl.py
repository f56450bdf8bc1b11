"""Offline ETL: pandas -> grouped sequences -> packed ragged arrays
(copied whole from ``bert4clickpath_tpu/data/etl.py``, which is numpy only;
keep the two in step). pandas is never imported: the DataFrame arguments
are duck-typed, as in the JAX module.

The reference's pandas -> tf.train.Example -> TFRecord pipeline
(clickstream_transformer/data_utils.py) becomes packed values + offsets
ragged arrays stored as ``.npz`` (or ``.npy`` directories to memory-map):
shardable, no TF dependency. A list of 1-D sequences becomes one flat
``values`` array plus ``offsets`` (``len + 1`` entries), the layout the
native batcher reads and the ``<prefix>_i_of_n.npz`` shards of a prepared
data directory hold.

Covered reference surface:
* ``pandas_to_tf_example_list`` (data_utils.py:53-124) -> :func:`group_sequences`
* ``pandas_train_test_split`` (data_utils.py:399-409) -> :func:`train_test_split`
* ``write_to_tfrecord`` sharded writer (data_utils.py:412-481) ->
  :func:`write_packed` / :func:`read_packed` (sharded ``name_i_of_n.npz``)
* the SequenceExample writer (data_utils.py:127-245) ->
  :func:`write_packed_dataset` / :func:`read_packed_dataset`
"""

from __future__ import annotations

import glob
import os
import re
from typing import Optional, Sequence

import numpy as np


def group_sequences(
    df,
    group_id_column: str,
    feature_columns: Optional[Sequence[str]] = None,
    max_seq_len: Optional[int] = None,
):
    """Group a long-format DataFrame into per-group ordered lists.

    Equivalent to the reference's groupby + collect_list
    (data_utils.py:119-124): row order within each group is preserved; each
    feature column becomes one list per group.

    Returns (group_ids: list[str], {feature: list[np.ndarray of str]}).
    """
    if feature_columns is None:
        feature_columns = [c for c in df.columns if c != group_id_column]
    group_ids: list[str] = []
    out: dict[str, list[np.ndarray]] = {c: [] for c in feature_columns}
    for gid, grp in df.groupby(group_id_column, sort=False):
        if max_seq_len is not None:
            grp = grp.head(max_seq_len)
        group_ids.append(str(gid))
        for c in feature_columns:
            out[c].append(np.asarray(grp[c].tolist()))
    return group_ids, out


def train_test_split(df, group_id_column: str, train_fraction: float, seed: int = 0):
    """Per-group random train/test marking (reference data_utils.py:399-409):
    every *group* (user) is assigned wholly to train or test."""
    rng = np.random.default_rng(seed)
    gids = df[group_id_column].unique()
    train_gids = set(gids[rng.random(len(gids)) < train_fraction])
    is_train = df[group_id_column].isin(train_gids)
    return df[is_train], df[~is_train]


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


def write_packed(
    sequences: Sequence[np.ndarray],
    path: str,
    filename_prefix: str,
    records_per_shard: int = 10_000,
) -> list[str]:
    """Sharded ``<prefix>_i_of_n.npz`` writer (naming per data_utils.py:474-478)."""
    os.makedirs(path, exist_ok=True)
    n_shards = max(1, (len(sequences) + records_per_shard - 1) // records_per_shard)
    files = []
    for i in range(n_shards):
        shard = sequences[i * records_per_shard : (i + 1) * records_per_shard]
        fname = os.path.join(path, f"{filename_prefix}_{i + 1}_of_{n_shards}.npz")
        np.savez_compressed(fname, **pack_ragged(shard))
        files.append(fname)
    return files


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


def _pack_feature(seqs: Sequence[np.ndarray]) -> dict[str, np.ndarray]:
    """Pack 1-D or 2-D per-group arrays.

    2-D list features (reference pandas_to_seq_example flattens them into
    per-index context keys, data_utils.py:378-381 — a self-described temp
    hack) pack properly here: rows flatten into ``values`` with a constant
    ``width`` recorded, offsets count rows. width=0 marks a 1-D feature.
    """
    arrays = [np.asarray(s) for s in seqs]
    widths = {a.shape[1] for a in arrays if a.ndim == 2}
    if not widths:
        packed = pack_ragged(arrays)
        packed["width"] = np.int64(0)
        return packed
    if len(widths) != 1 or any(a.ndim != 2 for a in arrays if a.size):
        raise ValueError(
            f"2-D list feature needs one constant inner width, got {widths}"
        )
    (width,) = widths
    lengths = np.array([a.shape[0] for a in arrays], dtype=np.int64)
    offsets = np.zeros(len(arrays) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    values = (
        np.concatenate([a.reshape(-1, width) for a in arrays])
        if arrays
        else np.zeros((0, width))
    )
    return {"values": values, "offsets": offsets, "width": np.int64(width)}


def _unpack_feature(values, offsets, width) -> list[np.ndarray]:
    if int(width) == 0:
        return [values[offsets[i] : offsets[i + 1]] for i in range(len(offsets) - 1)]
    return [values[offsets[i] : offsets[i + 1], :] for i in range(len(offsets) - 1)]


def write_packed_dataset(
    features: dict[str, Sequence[np.ndarray]],
    path: str,
    records_per_shard: int = 10_000,
    context: Optional[dict[str, Sequence]] = None,
    mmap: bool = False,
) -> list[str]:
    """Multi-feature ragged dataset writer (the SequenceExample replacement,
    reference data_utils.py:127-245): each feature is a list of per-group
    1-D or 2-D arrays, all aligned on the group axis.

    context: per-group SCALAR features (one value per group — the
    SequenceExample ``context`` split, data_utils.py:218-221), stored as
    plain ``ctx_<name>`` arrays alongside.

    mmap=False: one ``dataset_i_of_n.npz`` per shard. mmap=True: one
    ``dataset_i_of_n/`` directory per shard holding raw ``.npy`` files so
    :func:`read_packed_dataset` can ``np.load(mmap_mode='r')`` them —
    sequences come back as zero-copy views into the mapped file.
    """
    names = sorted(features)
    n = len(features[names[0]])
    for m in names:
        if len(features[m]) != n:
            raise ValueError("features must align on the group axis")
    context = context or {}
    for m in context:
        if len(context[m]) != n:
            raise ValueError("context must align on the group axis")
    os.makedirs(path, exist_ok=True)
    n_shards = max(1, (n + records_per_shard - 1) // records_per_shard)
    files = []
    for i in range(n_shards):
        sl = slice(i * records_per_shard, (i + 1) * records_per_shard)
        payload = {}
        for m in names:
            packed = _pack_feature(features[m][sl])
            payload[f"{m}_values"] = packed["values"]
            payload[f"{m}_offsets"] = packed["offsets"]
            payload[f"{m}_width"] = packed["width"]
        for m in sorted(context):
            payload[f"ctx_{m}"] = np.asarray(context[m][sl])
        base = os.path.join(path, f"dataset_{i + 1}_of_{n_shards}")
        if mmap:
            os.makedirs(base, exist_ok=True)
            for k, v in payload.items():
                np.save(os.path.join(base, f"{k}.npy"), v)
            files.append(base)
        else:
            fname = base + ".npz"
            np.savez_compressed(fname, **payload)
            files.append(fname)
    return files


def read_packed_dataset(
    path_glob: str, mmap: bool = False
) -> tuple[dict[str, list[np.ndarray]], dict[str, np.ndarray]]:
    """Read a packed dataset back (all shards, in order).

    Returns ``(features, context)``. With ``mmap=True`` (``.npy``-directory
    shards), values arrays are memory-mapped and the per-group sequences
    are zero-copy views — a 100M-event dataset opens in milliseconds.
    """

    def shard_key(p):
        m = re.search(r"_(\d+)_of_(\d+)(\.npz)?$", p)
        return int(m.group(1)) if m else 0

    feats: dict[str, list[np.ndarray]] = {}
    ctx: dict[str, list[np.ndarray]] = {}
    for fname in sorted(glob.glob(path_glob), key=shard_key):
        if os.path.isdir(fname):
            mode = "r" if mmap else None
            z = {
                os.path.splitext(os.path.basename(p))[0]: np.load(
                    p, mmap_mode=mode, allow_pickle=False
                )
                for p in glob.glob(os.path.join(fname, "*.npy"))
            }
            _read_shard(z, feats, ctx)
        else:
            with np.load(fname, allow_pickle=False) as z:
                _read_shard({k: z[k] for k in z.files}, feats, ctx)
    return feats, {m: np.concatenate(parts) for m, parts in ctx.items()}


def _read_shard(z: dict, feats: dict, ctx: dict) -> None:
    names = sorted({k[: -len("_values")] for k in z if k.endswith("_values")})
    for m in names:
        width = z.get(f"{m}_width", np.int64(0))
        feats.setdefault(m, []).extend(
            _unpack_feature(z[f"{m}_values"], z[f"{m}_offsets"], width)
        )
    for k in z:
        if k.startswith("ctx_"):
            ctx.setdefault(k[len("ctx_") :], []).append(np.asarray(z[k]))
