"""The Cloze training batches of a session list, worked out again.

A frozen copy of the semantics of the program's batch stream
(``bert4clickpath_torch/data/pipeline.py:ClozeDataset.train_batches`` with
its native batcher, ``bert4clickpath_torch/data/native/batcher.cpp``),
written in plain Python and numpy so that the reference reads the sessions
and the seed, never the program's batches:

* each epoch visits the sessions in the order of
  ``numpy.random.default_rng(seed).permutation(n)`` (one generator for the
  whole stream) and cuts it into full batches;
* each row drops its last item (the held-out one), keeps the most recent
  ``max_items``, and lays out ``[CLS][SEP] items [PAD]... [SEP]`` in model
  space (label + 10);
* ``int(n * pct)`` (at most ``max_masked``) unique positions are masked,
  chosen by a partial Fisher-Yates shuffle driven by splitmix64 seeded from
  (seed, batch counter, session index), with Lemire's bounded draw, and
  sorted.
"""

from __future__ import annotations

import numpy as np

CLS_ID, SEP_ID, MASK_ID, PAD_ID, LABEL_PAD = 3, 4, 1, 0, -1
NUM_RESERVED = 10
_M64 = (1 << 64) - 1


class _SplitMix64:
    def __init__(self, seed: int):
        self.state = seed & _M64

    def next(self) -> int:
        self.state = (self.state + 0x9E3779B97F4A7C15) & _M64
        z = self.state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        return z ^ (z >> 31)

    def bounded(self, n: int) -> int:
        m = (self.next() & 0xFFFFFFFF) * n
        low = m & 0xFFFFFFFF
        if low < n:
            t = ((1 << 32) - n) % n
            while low < t:
                m = (self.next() & 0xFFFFFFFF) * n
                low = m & 0xFFFFFFFF
        return m >> 32


def _row(seq: np.ndarray, session: int, counter: int, seed: int, max_items: int, max_masked: int,
         pct: float):
    length = max_items + 3
    tokens = np.full(length, PAD_ID, np.int32)
    tokens[0], tokens[1], tokens[-1] = CLS_ID, SEP_ID, SEP_ID
    positions = np.zeros(max_masked, np.int32)
    labels = np.full(max_masked, LABEL_PAD, np.int32)
    full = max(len(seq) - 1, 0)
    n = min(full, max_items)
    items = np.asarray(seq[full - n : full], np.int64)
    tokens[2 : 2 + n] = items + NUM_RESERVED
    n_masked = min(int(np.float32(n) * np.float32(pct)), max_masked)
    if n_masked > 0:
        rng = _SplitMix64(seed * 0x9E3779B97F4A7C15 + counter * 0x85EBCA77 + session + 1)
        idx = list(range(n))
        for m in range(n_masked):
            j = m + rng.bounded(n - m)
            idx[m], idx[j] = idx[j], idx[m]
        picks = sorted(idx[:n_masked])
        for m, p in enumerate(picks):
            labels[m] = items[p]
            positions[m] = p + 2
            tokens[2 + p] = MASK_ID
    return tokens, positions, labels


def train_batches(sessions, batch: int, seed: int, count: int, max_items: int, max_masked: int,
                  pct: float) -> list[dict]:
    """The first ``count`` batches of the stream, as dicts of numpy arrays
    ``tokens`` (B, max_items + 3), ``positions`` and ``labels`` (B,
    max_masked)."""
    rng = np.random.default_rng(seed)
    n = len(sessions)
    out = []
    counter = 0
    while len(out) < count:
        order = rng.permutation(n)
        for start in range(0, n - batch + 1, batch):
            if len(out) == count:
                break
            rows = [_row(sessions[i], int(i), counter, seed, max_items, max_masked, pct)
                    for i in order[start : start + batch]]
            counter += 1
            out.append({
                "tokens": np.stack([r[0] for r in rows]),
                "positions": np.stack([r[1] for r in rows]),
                "labels": np.stack([r[2] for r in rows]),
            })
    return out
