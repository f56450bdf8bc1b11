"""The general generator of the benchmark's traffic mixes.

A mix is a data file ``portbench/traffic/<mix>.json``; its ``generator`` key
picks one of the two kinds below, and every other key is a parameter. The
catalog size comes from the cell's configuration (``n_items``).

* ``synthetic``: a pool of ``pool`` distinct batches of ``batch`` sessions,
  made in set-up and cycled, a new one each step. Copied from
  ``bert4clickpath_torch/data/synthetic.py:synthetic_batch`` (itself a copy
  of ``examples/large_catalog/stress.py``): items uniform over the catalog,
  ``[CLS][SEP] items [PAD]... [SEP]`` in model space, min(max_masked,
  max(1, int(0.4 n))) sorted masked positions.
* ``clickstream``: ``sessions`` label-space item sequences for the
  program's Cloze batcher. Copied from
  ``bert4clickpath_torch/data/generator.py:ClickStreamGenerator`` (a Markov
  walk: each next item is the current one plus a geometric jump with
  p = min(0.95, c / (c + 10)), or with probability 0.05 a uniform item),
  drawn for all sessions at once instead of item by item (the same walk,
  other draws).

Both take their session lengths from the mix's ``lengths``
(:func:`session_lengths`): a fixed set, the same for every seed, which the
seed only shuffles, so every seed asks for the same amount of work.

A synthetic mix may set ``negatives: S``: each pool batch then carries
``negatives``, S label ids uniform over the catalog drawn from a stream of
their own (``mix(seed, NEGATIVES)``), the batch-shared negatives of a
sampled softmax, which the program and the reference both read.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from portbench.harness.weights import NEGATIVES, TRAFFIC, mix

CLS_ID, SEP_ID, MASK_ID, PAD_ID, LABEL_PAD = 3, 4, 1, 0, -1
NUM_RESERVED = 10


@dataclass
class Traffic:
    kind: str
    params: dict
    pool: list = field(default_factory=list)  # synthetic: dicts of numpy arrays
    sessions: list = field(default_factory=list)  # clickstream: int32 arrays


def session_lengths(count: int, spec: dict) -> np.ndarray:
    """``count`` session lengths, in increasing order, as ``spec`` states:

    * ``{"kind": "uniform", "min": a, "max": b}``: spread evenly over
      [a, b], each value about equally often;
    * ``{"kind": "geometric", "min": a, "mean": m, "max": b}``: the
      quantiles at (i + 1/2) / count of a + a geometric number of further
      items with mean m - a (the long tail of logged sessions), capped at b.
    """
    low, high = spec["min"], spec["max"]
    if spec["kind"] == "uniform":
        return low + (np.arange(count, dtype=np.int64) * (high - low + 1)) // count
    if spec["kind"] == "geometric":
        p = 1.0 / (spec["mean"] - low + 1.0)  # a geometric count of failures has mean (1 - p) / p
        u = (np.arange(count) + 0.5) / count
        extra = np.floor(np.log1p(-u) / np.log1p(-p)).astype(np.int64)
        return np.minimum(low + extra, high)
    raise ValueError(f"unknown length distribution {spec['kind']!r}")


def synthetic_pool(rng: np.random.Generator, params: dict, n_items: int) -> list:
    """Every batch of the pool holds the same set of lengths, in its own
    order, so that every step asks for the same work."""
    lengths = session_lengths(params["batch"], params["lengths"])
    max_items, max_masked = params["max_items"], params["max_masked"]
    return [synthetic_batch(rng, rng.permutation(lengths), max_items, max_masked, n_items)
            for _ in range(params["pool"])]


def synthetic_batch(rng: np.random.Generator, lens: np.ndarray, max_items: int, max_masked: int,
                    n_items: int) -> dict:
    batch = len(lens)
    tokens = np.full((batch, max_items + 3), PAD_ID, np.int32)
    tokens[:, 0] = CLS_ID
    tokens[:, 1] = SEP_ID
    tokens[:, -1] = SEP_ID
    positions = np.zeros((batch, max_masked), np.int32)
    labels = np.full((batch, max_masked), LABEL_PAD, np.int32)
    for i in range(batch):
        n = int(lens[i])
        items = rng.integers(0, n_items, size=n).astype(np.int32)
        tokens[i, 2 : 2 + n] = items + NUM_RESERVED
        n_masked = min(max_masked, max(1, int(0.4 * n)))
        picks = np.sort(rng.permutation(n)[:n_masked])
        labels[i, :n_masked] = items[picks]
        tokens[i, 2 + picks] = MASK_ID
        positions[i, :n_masked] = picks + 2
    return {"tokens": tokens, "positions": positions, "labels": labels}


def clickstream_sessions(rng: np.random.Generator, params: dict, n_items: int) -> list:
    count = params["sessions"]
    lengths = rng.permutation(session_lengths(count, params["lengths"]))
    c = params["session_cohesiveness"]
    p = min(0.95, c / (c + 10.0))
    walk = np.empty((count, int(lengths.max())), np.int64)
    current = rng.integers(n_items, size=count)
    for t in range(walk.shape[1]):
        walk[:, t] = current
        jump = rng.geometric(p, size=count)
        reset = rng.random(count) < 0.05
        current = np.where(reset, rng.integers(n_items, size=count), (current + jump) % n_items)
    return [walk[i, : lengths[i]].astype(np.int32) for i in range(count)]


def make(params: dict, n_items: int, seed: int) -> Traffic:
    rng = np.random.default_rng(mix(seed, TRAFFIC))
    kind = params["generator"]
    if kind == "synthetic":
        pool = synthetic_pool(rng, params, n_items)
        if "negatives" in params:
            draw = np.random.default_rng(mix(seed, NEGATIVES))
            for batch in pool:
                batch["negatives"] = draw.integers(0, n_items, size=params["negatives"]).astype(np.int32)
        return Traffic(kind, params, pool=pool)
    if "negatives" in params:
        raise ValueError(f"a {kind!r} mix carries no negatives (only 'synthetic' does)")
    if kind == "clickstream":
        return Traffic(kind, params, sessions=clickstream_sessions(rng, params, n_items))
    raise ValueError(f"unknown traffic generator {kind!r}")


def batch_stats(batch: dict) -> dict:
    """What a batch asks of the model, counted from its arrays: labelled
    rows, real (non-pad) tokens, the sum over sessions of real tokens
    squared (attention's query-key pairs), and its negatives where it
    carries them."""
    real = (batch["tokens"] != PAD_ID).sum(axis=1).astype(np.int64)
    stats = {
        "labelled": int((batch["labels"] != LABEL_PAD).sum()),
        "tokens": int(real.sum()),
        "tokens_sq": int((real * real).sum()),
        "batch": int(batch["tokens"].shape[0]),
        "length": int(batch["tokens"].shape[1]),
    }
    if "negatives" in batch:
        stats["negatives"] = int(batch["negatives"].shape[0])
    return stats
