"""Host-side string<->id vocabularies.

(Copied whole from ``bert4clickpath_tpu/vocab.py``, which imports no jax,
so that the port never imports the JAX package. Keep the two in step:
both packages read the same artifacts.)

The reference baked ``tf.lookup.StaticVocabularyTable``s into the Keras model
so the exported SavedModel was string-in/self-contained
(clickstream_transformer.py:247-258, 354-375). XLA has no string tensors, so
in the TPU build the mapping lives here, on the host, and self-contained
serving is preserved by packaging the vocabulary artifact with every
checkpoint (:mod:`bert4clickpath_torch.training.serving`).

Two id spaces exist, exactly as in the reference:

* **model space** — ``NUM_RESERVED_TOKENS`` reserved rows are prepended, and
  one OOV bucket is appended, so a raw token at vocab index ``i`` maps to
  ``10 + i`` and unknowns map to ``10 + V`` (reference
  clickstream_transformer.py:253-256).
* **label space** — the raw vocab without reserved rows: index ``i`` maps to
  ``i``, unknowns to ``V`` (reference input_pipeline.py:187-192). Head output
  dimension is ``V`` (reference source/main.py:232,263), so OOV labels never
  legitimately occur; :meth:`encode_labels` raises on them by default.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Sequence

import numpy as np

from bert4clickpath_torch.constants import (
    LABEL_PAD,
    NUM_RESERVED_TOKENS,
    RESERVED_TOKENS,
)


class Vocabulary:
    """An ordered raw vocabulary plus its two integer id spaces."""

    def __init__(self, tokens: Sequence[str]):
        self.tokens = [str(t) for t in tokens]
        if len(set(self.tokens)) != len(self.tokens):
            raise ValueError("vocabulary contains duplicate tokens")
        for t in self.tokens:
            if t in RESERVED_TOKENS:
                raise ValueError(f"raw vocabulary may not contain reserved token {t!r}")
        self._label_ids = {t: i for i, t in enumerate(self.tokens)}
        self._model_ids = {t: i for i, t in enumerate(RESERVED_TOKENS)}
        for t, i in self._label_ids.items():
            self._model_ids[t] = NUM_RESERVED_TOKENS + i
        # hash lookup tables (pandas C index) for the vectorized encoders,
        # built lazily — at a 10M-item catalog the per-token dict loop was
        # the serving bottleneck (see _make_lut for the measured ranking)
        self._model_lut_cache = None
        self._label_lut_cache = None

    # -- sizes ------------------------------------------------------------
    @property
    def size(self) -> int:
        """Number of raw tokens, V."""
        return len(self.tokens)

    @property
    def model_vocab_size(self) -> int:
        """Embedding-table rows: reserved + raw + 1 OOV bucket."""
        return NUM_RESERVED_TOKENS + self.size + 1

    @property
    def model_oov_id(self) -> int:
        return NUM_RESERVED_TOKENS + self.size

    @property
    def label_vocab_size(self) -> int:
        """Head output dimension (reference parity: no OOV row)."""
        return self.size

    # -- construction -----------------------------------------------------
    @classmethod
    def from_file(cls, path: str) -> "Vocabulary":
        """Load one token per line (reference training_utils.py:5-12)."""
        if os.path.isdir(path):
            raise IsADirectoryError(f"{path} is a directory.")
        with open(path, "r") as f:
            tokens = [line.strip() for line in f if line.strip()]
        return cls(tokens)

    @classmethod
    def from_corpus(cls, tokens: Iterable[str]) -> "Vocabulary":
        """Build from first-appearance order over a token stream."""
        seen: dict[str, None] = {}
        for t in tokens:
            if t not in seen:
                seen[t] = None
        return cls(list(seen))

    # -- encoding ---------------------------------------------------------
    @staticmethod
    def _make_lut(id_map: dict):
        # measured at a 10M-item catalog (BASELINE.md): pandas' C hash table
        # is ~2x the per-token dict loop; a sorted-array searchsorted is
        # *slower* than the dict (O(log V) string compares beat O(1) hash
        # only on paper). Fall back to the dict when pandas is absent.
        try:
            import pandas as pd
        except ImportError:
            return None
        index = pd.Index(np.array(list(id_map), dtype=object))
        ids = np.fromiter(id_map.values(), np.int32, count=len(id_map))
        return index, ids

    def _lookup(self, lut, id_map: dict, arr: np.ndarray):
        """Vectorized token lookup: returns flat (ids, found_mask)."""
        flat = arr.reshape(-1)
        if lut is not None:
            index, ids = lut
            if flat.dtype.kind != "O":
                flat = flat.astype(object)
            pos = index.get_indexer(flat)
            found = pos >= 0
            return ids[np.where(found, pos, 0)], found
        out = np.empty(flat.shape, np.int32)
        found = np.empty(flat.shape, bool)
        for j, t in enumerate(flat):
            i = id_map.get(t)
            found[j] = i is not None
            out[j] = -1 if i is None else i
        return out, found

    def encode_model(self, tokens) -> np.ndarray:
        """Strings -> model-space int32 ids (reserved offset + OOV bucket).

        Vectorized (pandas C hash-table lookup) so serving a 10M-item
        catalog is not bottlenecked by a per-token Python loop.
        """
        arr = np.asarray(tokens)
        if self._model_lut_cache is None:
            self._model_lut_cache = (self._make_lut(self._model_ids),)
        got, found = self._lookup(self._model_lut_cache[0], self._model_ids, arr)
        out = np.where(found, got, np.int32(self.model_oov_id))
        return out.astype(np.int32).reshape(arr.shape)

    def encode_labels(self, tokens, allow_oov: bool = False) -> np.ndarray:
        """Strings -> label-space int32 ids (0..V-1)."""
        arr = np.asarray(tokens)
        if self._label_lut_cache is None:
            self._label_lut_cache = (self._make_lut(self._label_ids),)
        got, found = self._lookup(self._label_lut_cache[0], self._label_ids, arr)
        if not found.all():
            if not allow_oov:
                bad = arr.reshape(-1)[np.argmax(~found)]
                raise KeyError(f"label token {bad!r} not in vocabulary")
            got = np.where(found, got, np.int32(self.size))
        return got.astype(np.int32).reshape(arr.shape)

    def model_id(self, token: str) -> int:
        return self._model_ids.get(token, self.model_oov_id)

    # -- decoding ---------------------------------------------------------
    def decode_label(self, label_id: int) -> str:
        if label_id == LABEL_PAD:
            return RESERVED_TOKENS[0]
        return self.tokens[int(label_id)]

    def decode_model(self, model_id: int) -> str:
        i = int(model_id)
        if i < NUM_RESERVED_TOKENS:
            return RESERVED_TOKENS[i]
        if i == self.model_oov_id:
            return "[OOV]"
        return self.tokens[i - NUM_RESERVED_TOKENS]

    @staticmethod
    def label_to_model(label_ids: np.ndarray) -> np.ndarray:
        """Shift label-space ids into model space (the +10 reserved offset)."""
        return np.where(
            label_ids == LABEL_PAD, label_ids, label_ids + NUM_RESERVED_TOKENS
        )

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        """One token per line, same format the reference reads/writes
        (data_prep/main.py:80-83)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for t in self.tokens:
                f.write(t + "\n")

    def save_artifact(self, directory: str, name: str) -> str:
        """Save as a named artifact inside a checkpoint/serving directory."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"vocab_{name}.json")
        with open(path, "w") as f:
            json.dump({"name": name, "tokens": self.tokens}, f)
        return path

    @classmethod
    def load_artifact(cls, directory: str, name: str) -> "Vocabulary":
        with open(os.path.join(directory, f"vocab_{name}.json")) as f:
            payload = json.load(f)
        return cls(payload["tokens"])

    def __len__(self) -> int:
        return self.size

    def __repr__(self) -> str:
        return f"Vocabulary(V={self.size}, model_rows={self.model_vocab_size})"
