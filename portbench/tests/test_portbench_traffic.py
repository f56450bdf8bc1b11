"""The traffic generator: a seed fixes the traffic, and every seed asks for
the same amount of work."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.harness import traffic as traffic_lib
from portbench.reference import cloze

SYNTHETIC = {"generator": "synthetic", "batch": 8, "pool": 3, "lengths": {"kind": "uniform", "min": 5, "max": 50},
             "max_items": 50, "max_masked": 10}
CLICKSTREAM = {"generator": "clickstream", "sessions": 300, "session_cohesiveness": 200,
               "lengths": {"kind": "geometric", "min": 5, "mean": 8.8, "max": 50}, "batch": 16, "max_items": 50,
               "max_masked": 10, "masked_percentage": 0.4, "batcher": "native"}


def _flat(t: traffic_lib.Traffic) -> list:
    if t.kind == "synthetic":
        return [a for b in t.pool for a in (b["tokens"], b["positions"], b["labels"])]
    return t.sessions


@pytest.mark.parametrize("params", [SYNTHETIC, CLICKSTREAM], ids=["synthetic", "clickstream"])
def test_same_seed_same_traffic_other_seed_other_traffic(params):
    a = traffic_lib.make(params, 1000, 2**40 + 5)
    b = traffic_lib.make(params, 1000, 2**40 + 5)
    c = traffic_lib.make(params, 1000, 2**40 + 6)
    assert all(np.array_equal(x, y) for x, y in zip(_flat(a), _flat(b)))
    assert not all(np.array_equal(x, y) for x, y in zip(_flat(a), _flat(c)))


@pytest.mark.parametrize("params", [SYNTHETIC, CLICKSTREAM], ids=["synthetic", "clickstream"])
def test_every_seed_gives_the_same_lengths(params):
    def lengths(seed):
        t = traffic_lib.make(params, 1000, seed)
        if t.kind == "synthetic":
            return sorted(int(n) for b in t.pool for n in (b["tokens"] != 0).sum(axis=1))
        return sorted(len(s) for s in t.sessions)

    assert lengths(1) == lengths(99_999_999_999)


@pytest.mark.parametrize("spec", [{"kind": "uniform", "min": 5, "max": 50},
                                  {"kind": "geometric", "min": 5, "mean": 8.8, "max": 50}],
                         ids=["uniform", "geometric"])
def test_session_lengths_keep_their_distribution(spec):
    lengths = traffic_lib.session_lengths(40_226, spec)
    assert lengths.min() == 5 and lengths.max() <= 50 and (np.diff(lengths) >= 0).all()
    mean = spec.get("mean", (spec["min"] + spec["max"]) / 2)
    assert lengths.mean() == pytest.approx(mean, rel=2e-3)


def test_every_synthetic_batch_asks_the_same_work():
    t = traffic_lib.make(SYNTHETIC, 1000, 2**33 + 1)
    stats = [traffic_lib.batch_stats(b) for b in t.pool]
    assert all(s["tokens"] == stats[0]["tokens"] and s["labelled"] == stats[0]["labelled"] for s in stats)
    assert len({tuple(b["tokens"][:, 2]) for b in t.pool}) == len(t.pool)


def test_synthetic_batches_follow_the_layout():
    t = traffic_lib.make(SYNTHETIC, 1000, 3)
    for b in t.pool:
        tok, pos, lab = b["tokens"], b["positions"], b["labels"]
        assert tok.shape == (8, 53) and (tok[:, 0] == 3).all() and (tok[:, 1] == 4).all() and (tok[:, -1] == 4).all()
        live = lab != -1
        assert (tok[np.arange(8)[:, None].repeat(10, 1)[live], pos[live]] == 1).all()
        assert ((lab[live] >= 0) & (lab[live] < 1000)).all()
        stats = traffic_lib.batch_stats(b)
        assert stats["labelled"] == live.sum() and stats["batch"] == 8


def test_clickstream_walk_stays_in_the_catalog_and_is_cohesive():
    t = traffic_lib.make(dict(CLICKSTREAM, sessions=2000), 1000, 11)
    steps = np.concatenate([(np.diff(s.astype(np.int64)) % 1000) for s in t.sessions])
    assert all(((s >= 0) & (s < 1000)).all() for s in t.sessions)
    # geometric jumps of p = 200/210, with 5% uniform resets: most steps are +1
    assert 0.85 < np.mean(steps == 1) < 0.95


def test_reference_cloze_batches_match_the_program_batcher():
    from bert4clickpath_torch.data.pipeline import ClozeDataset
    from bert4clickpath_torch.vocab import Vocabulary

    t = traffic_lib.make(CLICKSTREAM, 1000, 21)
    ds = ClozeDataset(t.sessions, Vocabulary([f"i{i}" for i in range(1000)]), max_items=50, max_masked=10,
                      masked_percentage=0.4, backend="native")
    if ds.backend != "native":
        pytest.skip("the native batcher did not build (no g++)")
    stream = ds.train_batches(16, seed=2**62 + 3)
    ours = cloze.train_batches(t.sessions, 16, 2**62 + 3, 25, 50, 10, 0.4)
    for mine in ours:  # 25 batches: past the first epoch of 18
        b = next(stream)
        assert np.array_equal(mine["tokens"], b.features["items"])
        assert np.array_equal(mine["positions"], b.head_positions)
        assert np.array_equal(mine["labels"], b.labels)
