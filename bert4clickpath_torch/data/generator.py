"""Synthetic clickstream generator — the deterministic test/stress backend.

(Copied whole from ``bert4clickpath_tpu/data/generator.py``, which is
numpy only; keep the two in step.)

The reference toggles a ``ClickStreamGenerator(n_items, n_events,
session_cohesiveness, write_vocab_files, vocab_dir)`` for simulated data
(source/main.py:218-228) but the module itself is missing from the repo
(the import at source/main.py:17 fails); only the intended interface is
recoverable. This is a faithful reimplementation of that interface
(SURVEY.md §4b), seedable, used as:

* the deterministic pytest fixture,
* the 10M-item large-catalog stress source (BASELINE.json configs[4]).

Sessions are a Markov walk over items: from item ``i`` the next item is
drawn from a neighborhood of ``i`` with concentration controlled by
``session_cohesiveness`` (higher = more predictable sessions = a model can
learn them; 0 = uniform random).
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from bert4clickpath_torch.vocab import Vocabulary


class ClickStreamGenerator:
    def __init__(
        self,
        n_items: int,
        n_events: int = 10,
        session_cohesiveness: float = 100.0,
        write_vocab_files: bool = False,
        vocab_dir: str | None = None,
        min_len: int = 5,
        max_len: int = 50,
        seed: int = 0,
    ):
        self.n_items = n_items
        self.n_events = n_events
        self.session_cohesiveness = session_cohesiveness
        self.min_len = min_len
        self.max_len = max_len
        self.seed = seed
        self._item_tokens = [f"item_{i}" for i in range(n_items)]
        self._event_tokens = [f"event_{i}" for i in range(n_events)]
        if write_vocab_files:
            assert vocab_dir is not None
            os.makedirs(vocab_dir, exist_ok=True)
            self.item_vocab().save(os.path.join(vocab_dir, "item_vocab.txt"))
            self.event_vocab().save(os.path.join(vocab_dir, "event_vocab.txt"))

    def item_vocab(self) -> Vocabulary:
        return Vocabulary(self._item_tokens)

    def event_vocab(self) -> Vocabulary:
        return Vocabulary(self._event_tokens)

    def _next_item(self, rng: np.random.Generator, current: int) -> int:
        """Markov step: jump sizes are geometric-ish; cohesiveness sharpens."""
        if self.session_cohesiveness <= 0:
            return int(rng.integers(self.n_items))
        # Neighborhood walk: small forward jumps with occasional resets.
        jump = rng.geometric(
            p=min(0.95, self.session_cohesiveness / (self.session_cohesiveness + 10.0))
        )
        if rng.random() < 0.05:
            return int(rng.integers(self.n_items))
        return int((current + jump) % self.n_items)

    def generate_sessions(
        self, n_sessions: int
    ) -> tuple[list[np.ndarray], list[np.ndarray]]:
        """Returns (item label-id sequences, event label-id sequences)."""
        rng = np.random.default_rng(self.seed)
        items_out, events_out = [], []
        for _ in range(n_sessions):
            length = int(rng.integers(self.min_len, self.max_len + 1))
            current = int(rng.integers(self.n_items))
            items = np.empty(length, dtype=np.int32)
            for t in range(length):
                items[t] = current
                current = self._next_item(rng, current)
            events = rng.integers(self.n_events, size=length).astype(np.int32)
            items_out.append(items)
            events_out.append(events)
        return items_out, events_out

    def __call__(self) -> Iterator[dict]:
        """String-keyed generator matching the reference's from_generator
        contract (input_pipeline.py:161-177): dicts of raw string features."""
        rng = np.random.default_rng(self.seed)
        session_id = 0
        while True:
            length = int(rng.integers(self.min_len, self.max_len + 1))
            current = int(rng.integers(self.n_items))
            items = []
            for _ in range(length):
                items.append(self._item_tokens[current])
                current = self._next_item(rng, current)
            yield {
                "asin": np.array(items, dtype=object),
                "reviewerID": f"user_{session_id}",
            }
            session_id += 1
