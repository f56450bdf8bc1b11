"""Batching pipeline: shuffled infinite train stream + one-pass eval.

(Copied from ``bert4clickpath_tpu/data/pipeline.py``, which is numpy only;
keep the two in step. The port adds :func:`to_device`, which moves a
``ClozeBatch`` into the dict of tensors the train step takes.)

Replaces the reference's tf.data graph (create_cloze_dataset,
input_pipeline.py:136-231: shuffle(20000) -> repeat -> map(mask) ->
padded_batch -> prefetch) with a seedable host-side iterator producing
fixed-shape numpy batches.

Multi-host: each process takes a strided slice of the sequence list
(``sequences[process_index::process_count]``) and builds its *per-host*
share of the global batch; global loss/metric normalization is exact because
losses psum sums and counts (ops/losses.py), so no per-replica batch
gymnastics are needed (contrast source/utils.py:76-90).
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from bert4clickpath_torch.data.cloze import (
    ClozeBatch,
    make_eval_batch,
    make_train_batch,
    pad_batch,
)
from bert4clickpath_torch.vocab import Vocabulary


class ClozeDataset:
    """Holds per-user label-space id sequences + the item vocabulary."""

    def __init__(
        self,
        sequences: Sequence[np.ndarray],
        vocab: Vocabulary,
        max_items: int = 50,
        max_masked: int = 10,
        feature_name: str = "items",
        process_index: int = 0,
        process_count: int = 1,
        backend: str = "auto",  # auto | numpy | native
        masked_percentage: Optional[float] = None,
    ):
        if process_count > 1:
            sequences = list(sequences[process_index::process_count])
        else:
            sequences = list(sequences)
        self.sequences = sequences
        self.vocab = vocab
        self.max_items = max_items
        self.max_masked = max_masked
        self.feature_name = feature_name
        if masked_percentage is None:
            from bert4clickpath_torch.constants import MASKED_PERCENTAGE

            masked_percentage = MASKED_PERCENTAGE
        # Cloze mask rate (reference cloze_constants.py:2 = 0.4). Tunable:
        # Sun et al. 2019 report 0.6 as the Beauty optimum.
        self.masked_percentage = float(masked_percentage)
        self._packed = None
        if backend == "auto":
            from bert4clickpath_torch.data import native

            backend = (
                "native"
                if max_items <= native.MAX_ITEMS_NATIVE and native.available()
                else "numpy"
            )
        self.backend = backend

    def _packed_arrays(self):
        if self._packed is None:
            from bert4clickpath_torch.data.etl import pack_ragged

            p = pack_ragged(self.sequences)
            self._packed = (
                np.ascontiguousarray(p["values"], np.int32),
                np.ascontiguousarray(p["offsets"], np.int64),
            )
        return self._packed

    def __len__(self) -> int:
        return len(self.sequences)

    def train_batches(
        self, per_host_batch: int, seed: int = 0
    ) -> Iterator[ClozeBatch]:
        """Infinite epoch-shuffled stream of training batches.

        Deterministic in (seed, host): masking and order reproduce run to run
        — the multi-host reproducibility requirement of SURVEY.md §7.
        """
        rng = np.random.default_rng(seed)
        n = len(self.sequences)
        if per_host_batch > n:
            raise ValueError(
                f"per-host batch {per_host_batch} exceeds dataset size {n}; "
                "the stream would yield nothing"
            )
        use_native = self.backend == "native"
        if use_native:
            from bert4clickpath_torch.data.native import native_train_batch

            values, offsets = self._packed_arrays()
        counter = 0
        while True:
            order = rng.permutation(n)
            for start in range(0, n - per_host_batch + 1, per_host_batch):
                idx = order[start : start + per_host_batch]
                if use_native:
                    tokens, positions, labels = native_train_batch(
                        values,
                        offsets,
                        np.ascontiguousarray(idx, np.int64),
                        self.max_items,
                        self.max_masked,
                        self.masked_percentage,
                        seed,
                        counter,
                    )
                    counter += 1
                    yield ClozeBatch({self.feature_name: tokens}, positions, labels)
                else:
                    yield make_train_batch(
                        [self.sequences[i] for i in idx],
                        rng,
                        self.max_items,
                        self.max_masked,
                        masked_percentage=self.masked_percentage,
                        feature_name=self.feature_name,
                    )

    def eval_batches(
        self, per_host_batch: int, limit_batches: Optional[int] = None
    ) -> Iterator[ClozeBatch]:
        """One deterministic pass; final short batch padded to static shape."""
        n = len(self.sequences)
        count = 0
        use_native = self.backend == "native"
        if use_native:
            from bert4clickpath_torch.data.native import native_eval_batch

            values, offsets = self._packed_arrays()
        for start in range(0, n, per_host_batch):
            if limit_batches is not None and count >= limit_batches:
                return
            if use_native:
                idx = np.arange(start, min(start + per_host_batch, n), dtype=np.int64)
                # width-1 slots, matching make_eval_batch: leave-one-out
                # scores one position per user; wider batches multiply the
                # eval forward + catalog-scan cost by max_masked for nothing
                tokens, positions, labels = native_eval_batch(
                    values, offsets, idx, self.max_items, 1
                )
                batch = ClozeBatch(
                    {self.feature_name: tokens}, positions, labels
                )
            else:
                chunk = self.sequences[start : start + per_host_batch]
                batch = make_eval_batch(
                    chunk,
                    self.max_items,
                    self.max_masked,
                    feature_name=self.feature_name,
                )
            yield pad_batch(batch, per_host_batch)
            count += 1


def prefetch_to_device(iterator, to_device, depth: int = 2):
    """Wrap a host batch iterator so device transfer runs ahead of consumption.

    The tf.data ``prefetch(AUTOTUNE)`` equivalent (reference
    input_pipeline.py:229) for our host-side pipeline: keeps ``depth``
    batches already transferred (``to_device`` should copy without
    blocking, e.g. from pinned memory, so the copies queue behind the
    running step).
    """
    import collections

    queue = collections.deque()
    for batch in iterator:
        queue.append(to_device(batch))
        if len(queue) >= depth:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def to_device(batch, device) -> dict:
    """A host batch as the train step's dict of int32 tensors:
    ``{"features": {...}, "head_positions", "labels"}``. The batch is a
    ``ClozeBatch`` (or a stacked one, from ``stack_batches``) or a dict of
    numpy arrays with those keys, as the task scripts build them, whose
    ``head_positions`` may be None (segment routing)."""
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    if isinstance(batch, dict):
        features, positions, labels = batch["features"], batch.get("head_positions"), batch["labels"]
    else:
        features, positions, labels = batch.features, batch.head_positions, batch.labels
    return {
        "features": {k: put(v) for k, v in features.items()},
        "head_positions": None if positions is None else put(positions),
        "labels": put(labels),
    }
