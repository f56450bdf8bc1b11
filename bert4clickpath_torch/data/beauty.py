"""Amazon Beauty loader.

Replaces the reference's pandas -> TFRecord ETL
(examples/BERT4Rec/data_prep/main.py + data_utils.py) with a direct
packed-array loader: beauty.txt ("user item" pairs in interaction order,
FeiSun/BERT4Rec format, read_bert4rec_text_data at data_prep/main.py:45-49)
-> per-user int32 sequences + a first-appearance item vocabulary.

Parity contract (data_prep/main.py:57-83): each user truncated to their
*first* ``max_seq_len`` interactions; vocabulary is ``pd.unique`` over the
truncated interactions, i.e. first-appearance order; min-interaction
filtering (>=5) is already applied inside beauty.txt.

(Copied whole from ``bert4clickpath_tpu/data/beauty.py``, which is numpy
only; keep the two in step. :func:`load_amazon_json` feeds
``examples/bert4rec/prepare_data_torch.py``.)
"""

from __future__ import annotations

import gzip
import json
import warnings
from typing import Iterable, Tuple

import numpy as np

from bert4clickpath_torch.vocab import Vocabulary


def _pairs_to_sequences(
    pairs: Iterable[Tuple[str, str]],
    max_seq_len: int,
    min_feedback: int = 0,
) -> tuple[list[np.ndarray], Vocabulary]:
    """(user, item) stream in interaction order -> per-user sequences + vocab.

    Shared tail of both loaders (data_prep/main.py:57-83): first-``max_seq_len``
    truncation per user (groupby cumcount < MAX_SEQ_LEN, main.py:69-70),
    first-appearance vocabulary over the *truncated* interactions
    (pd.unique, main.py:74), optional post-truncation min-length filter.
    """
    user_items: dict[str, list[str]] = {}
    kept_stream: list[tuple[str, str]] = []  # truncated (user, item), stream order
    for user, item in pairs:
        lst = user_items.setdefault(user, [])
        if len(lst) < max_seq_len:
            lst.append(item)
            kept_stream.append((user, item))
    if min_feedback:
        user_items = {u: s for u, s in user_items.items() if len(s) >= min_feedback}
    # first appearance in the truncated *stream* order, matching pd.unique
    # over the row-ordered frame (main.py:74) — for time-sorted input this
    # differs from per-user grouping order (min_feedback filters in place so
    # the stream order survives)
    vocab = Vocabulary.from_corpus(i for u, i in kept_stream if u in user_items)
    sequences = [vocab.encode_labels(items) for items in user_items.values()]
    return sequences, vocab


def load_beauty(
    path: str,
    max_seq_len: int = 50,
    min_feedback: int = 0,
) -> tuple[list[np.ndarray], Vocabulary]:
    """Returns (per-user label-space id sequences, item vocabulary).

    Sequences are int32 arrays of label-space ids (0..V-1) in interaction
    order; shift by NUM_RESERVED_TOKENS for model space
    (Vocabulary.label_to_model).
    """
    def pairs():
        with open(path, "r") as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2:
                    yield parts[0], parts[1]

    return _pairs_to_sequences(pairs(), max_seq_len, min_feedback)


def load_amazon_json(
    path: str,
    min_item_per_user: int = 5,
    max_seq_len: int = 50,
) -> tuple[list[np.ndarray], Vocabulary]:
    """Raw Amazon reviews json.gz -> per-user sequences + item vocabulary.

    The reference's advertised entry point for starting from the actual
    Amazon dumps (https://jmcauley.ucsd.edu/data/amazon/):
    ``read_raw_amazon_data`` at data_prep/main.py:9-42 — gzip JSON-lines
    parse keeping {reviewerID, asin, unixReviewTime}, drop users with fewer
    than ``min_item_per_user`` total reviews (count over the *unfiltered*
    stream, transform('count').ge, main.py:36-38), then order all
    interactions globally by ``unixReviewTime`` and drop the time column
    (main.py:40). One deliberate divergence: the sort is *stable* (the
    reference used pandas' default quicksort, so same-timestamp order — the
    common case with Amazon's day-resolution times — was arbitrary there;
    here it is file order, making runs reproducible). Truncation/vocab then
    follow the shared beauty.txt tail (main.py:57-83).
    """
    users: list[str] = []
    items: list[str] = []
    times: list[int] = []
    skipped = 0
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            # tolerate records missing the required keys (the reference's
            # pandas use_columns path carried them as NaN rows rather than
            # aborting, data_prep/main.py:9-42): skip and report, so one
            # malformed line can't kill a multi-GB ingestion
            try:
                u = str(rec["reviewerID"])
                a = str(rec["asin"])
                # null / non-numeric timestamps are as fatal as missing keys
                t = int(rec["unixReviewTime"])
            except (KeyError, TypeError, ValueError):
                skipped += 1
                continue
            users.append(u)
            items.append(a)
            times.append(t)
    if skipped:
        warnings.warn(
            f"load_amazon_json: skipped {skipped} record(s) missing or "
            "malformed reviewerID/asin/unixReviewTime"
        )
    if min_item_per_user:
        counts: dict[str, int] = {}
        for u in users:
            counts[u] = counts.get(u, 0) + 1
        keep = [i for i, u in enumerate(users) if counts[u] >= min_item_per_user]
    else:
        keep = range(len(users))
    order = sorted(keep, key=lambda i: times[i])  # stable: ties keep file order
    return _pairs_to_sequences(
        ((users[i], items[i]) for i in order), max_seq_len, min_feedback=0
    )
