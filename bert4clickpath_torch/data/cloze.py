"""Token layout of the Cloze sequences (the part serving needs).

Counterpart of ``bert4clickpath_tpu/data/cloze.py:46-78``: a single item
sequence is laid out ``[CLS][SEP] items... [PAD]... [SEP]``. The Cloze
batch pipeline itself is ported with the training slice.
"""

from __future__ import annotations

# [CLS] [SEP] ... [SEP] around the single item sequence.
N_SPECIAL = 3
ITEM_OFFSET = 2  # token index of the first item


def token_length(max_items: int) -> int:
    return max_items + N_SPECIAL
