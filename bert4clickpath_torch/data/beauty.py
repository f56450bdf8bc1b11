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

(Copied from ``bert4clickpath_tpu/data/beauty.py``, which is numpy only;
keep the two in step. The raw Amazon json loader of that module is not
copied: it feeds ``examples/bert4rec/prepare_data.py``, which the port does
not have yet.)
"""

from __future__ import annotations

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
