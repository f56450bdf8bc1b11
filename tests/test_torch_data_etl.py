"""The port's offline data path against the JAX package's, on the CPU.

Each function of ``bert4clickpath_torch/data/etl.py`` and
``data/beauty.py`` runs beside its ``bert4clickpath_tpu`` counterpart on
the same inputs (``tests/test_data_etl.py``'s cases, as parametrised
ones): the outputs are equal, arrays element for element, and the files
they write read back the same through either package. Then
``examples/bert4rec/prepare_data_torch.py`` writes a prepared directory
that ``prepare_data.py`` would write byte for byte in its arrays, and
``train_torch.py --device cpu --data <that directory>`` trains on it.
"""

import gzip
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from bert4clickpath_tpu.data import beauty as jbeauty
from bert4clickpath_tpu.data import etl as jetl
from bert4clickpath_torch.data import beauty, etl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
torch.set_num_threads(1)


def _same_sequences(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# -- pandas-shaped inputs, duck-typed ---------------------------------------------


def _frame():
    pd = pytest.importorskip("pandas")
    return pd.DataFrame({"user": ["u1", "u1", "u2", "u1", "u2"], "item": ["a", "b", "c", "d", "e"],
                         "event": ["v", "v", "w", "x", "w"]})


@pytest.mark.parametrize("max_seq_len", [None, 2])
def test_group_sequences_equals_jax(max_seq_len):
    df = _frame()
    gids, feats = etl.group_sequences(df, "user", max_seq_len=max_seq_len)
    jgids, jfeats = jetl.group_sequences(df, "user", max_seq_len=max_seq_len)
    assert gids == jgids and set(feats) == set(jfeats)
    for k in feats:
        _same_sequences(feats[k], jfeats[k])


@pytest.mark.parametrize("seed", [0, 3])
def test_train_test_split_equals_jax(seed):
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame({"user": [f"u{i}" for i in range(50) for _ in range(3)], "x": 0})
    train, test = etl.train_test_split(df, "user", 0.8, seed=seed)
    jtrain, jtest = jetl.train_test_split(df, "user", 0.8, seed=seed)
    assert train.equals(jtrain) and test.equals(jtest)
    assert not set(train["user"]) & set(test["user"])


# -- packed shards ----------------------------------------------------------------


def _ragged(seed, n, width=0):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 50, size=rng.integers(1, 9)).astype(np.int32) for _ in range(n)]
    return out if not width else [rng.normal(size=(len(s), width)).astype(np.float32) for s in out]


@pytest.mark.parametrize("sequences", ["ranges", "ragged", "empty"])
def test_pack_and_write_packed_equal_jax(sequences, tmp_path):
    seqs = {"ranges": [np.arange(i + 1, dtype=np.int32) for i in range(25)], "ragged": _ragged(0, 13),
            "empty": []}[sequences]
    packed, jpacked = etl.pack_ragged(seqs), jetl.pack_ragged(seqs)
    for k in ("values", "offsets"):
        assert packed[k].dtype == jpacked[k].dtype
        np.testing.assert_array_equal(packed[k], jpacked[k])
    _same_sequences(etl.unpack_ragged(packed), jetl.unpack_ragged(jpacked))
    files = etl.write_packed(seqs, str(tmp_path / "port"), "t", records_per_shard=10)
    jfiles = jetl.write_packed(seqs, str(tmp_path / "jax"), "t", records_per_shard=10)
    assert [os.path.basename(f) for f in files] == [os.path.basename(f) for f in jfiles]
    back = etl.read_packed(str(tmp_path / "port" / "t_*.npz"))
    _same_sequences(back, jetl.read_packed(str(tmp_path / "jax" / "t_*.npz")))
    _same_sequences(jetl.read_packed(str(tmp_path / "port" / "t_*.npz")), back)  # either reads either


DATASETS = {
    "multifeature": lambda: (dict(items=[np.arange(i + 2, dtype=np.int32) for i in range(12)],
                                  events=[np.arange(i + 2, dtype=np.int32) * 2 for i in range(12)]), None, False),
    "context and 2-D": lambda: (dict(items=_ragged(0, 12), embeds=_ragged(0, 12, width=4)),
                                dict(country=np.array([f"c{i % 3}" for i in range(12)]),
                                     age=np.arange(12, dtype=np.int32) + 20), False),
    "mmap": lambda: (dict(items=_ragged(1, 7)), dict(uid=np.arange(7)), True),
}


@pytest.mark.parametrize("case", list(DATASETS))
def test_packed_dataset_equals_jax(case, tmp_path):
    """write_packed_dataset / read_packed_dataset (and _pack_feature,
    _unpack_feature, _read_shard beneath them) against JAX's: the same
    shard names, the same arrays back through either package's reader;
    mmap shards come back as views of a memory map."""
    feats, ctx, mmap = DATASETS[case]()
    files = etl.write_packed_dataset(feats, str(tmp_path / "port"), records_per_shard=5, context=ctx, mmap=mmap)
    jfiles = jetl.write_packed_dataset(feats, str(tmp_path / "jax"), records_per_shard=5, context=ctx, mmap=mmap)
    assert [os.path.basename(f) for f in files] == [os.path.basename(f) for f in jfiles]
    pattern = "dataset_*" if mmap else "dataset_*.npz"
    back, back_ctx = etl.read_packed_dataset(str(tmp_path / "port" / pattern), mmap=mmap)
    for reader, where in ((jetl.read_packed_dataset, "jax"), (jetl.read_packed_dataset, "port")):
        want, want_ctx = reader(str(tmp_path / where / pattern), mmap=mmap)
        assert set(back) == set(want) and set(back_ctx) == set(want_ctx)
        for k in back:
            _same_sequences(back[k], want[k])
        for k in back_ctx:
            np.testing.assert_array_equal(back_ctx[k], want_ctx[k])
    for k in feats:
        _same_sequences(back[k], [np.asarray(s) for s in feats[k]])
    if mmap:
        base = back["items"][0].base
        while base is not None and not isinstance(base, np.memmap):
            base = base.base
        assert isinstance(base, np.memmap)


@pytest.mark.parametrize("bad", ["width mismatch", "misaligned features", "misaligned context"])
def test_packed_dataset_refuses_bad_input(bad, tmp_path):
    """A 2-D feature without one inner width raises ValueError, as in JAX;
    features or context that do not align on the group axis raise
    ValueError (the JAX module asserts)."""
    args = {"width mismatch": ({"x": [np.zeros((2, 3)), np.zeros((1, 4))]}, None),
            "misaligned features": ({"a": [np.zeros(2)], "b": [np.zeros(2), np.zeros(1)]}, None),
            "misaligned context": ({"a": [np.zeros(2)]}, {"c": np.arange(2)})}[bad]
    with pytest.raises(ValueError):
        etl.write_packed_dataset(args[0], str(tmp_path), context=args[1])


# -- Beauty and the raw Amazon dump ---------------------------------------------------


def _write_json(path, recs):
    with gzip.open(path, "wt") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


AMAZON = {
    "time order and ties": ([
        {"reviewerID": "u1", "asin": "b", "unixReviewTime": 200, "extra": 1},
        {"reviewerID": "u1", "asin": "a", "unixReviewTime": 100},
        {"reviewerID": "u1", "asin": "c", "unixReviewTime": 300},
        {"reviewerID": "u2", "asin": "z", "unixReviewTime": 50},
        {"reviewerID": "u3", "asin": "d", "unixReviewTime": 150},
        {"reviewerID": "u3", "asin": "e", "unixReviewTime": 150},
    ], dict(min_item_per_user=2, max_seq_len=50)),
    "truncation after the sort": (None, dict(min_item_per_user=2, max_seq_len=2)),
    "malformed records": ([
        {"reviewerID": "u1", "asin": "a", "unixReviewTime": 100},
        {"asin": "ghost", "unixReviewTime": 1},
        {"reviewerID": "u1", "unixReviewTime": 2},
        {"reviewerID": "u1", "asin": "b", "unixReviewTime": 200},
        {"reviewerID": "u1", "asin": "bad", "unixReviewTime": None},
        {"reviewerID": "u1", "asin": "bad2", "unixReviewTime": "n/a"},
    ], dict(min_item_per_user=2, max_seq_len=50)),
}


@pytest.mark.parametrize("case", list(AMAZON))
def test_load_amazon_json_equals_jax(case, tmp_path):
    recs, kw = AMAZON[case]
    recs = recs or AMAZON["time order and ties"][0]
    p = str(tmp_path / "reviews.json.gz")
    _write_json(p, recs)
    with warnings.catch_warnings(record=True) as got_warn:
        warnings.simplefilter("always")
        seqs, vocab = beauty.load_amazon_json(p, **kw)
    with warnings.catch_warnings(record=True) as want_warn:
        warnings.simplefilter("always")
        jseqs, jvocab = jbeauty.load_amazon_json(p, **kw)
    _same_sequences(seqs, jseqs)
    assert vocab.tokens == jvocab.tokens
    assert [str(w.message) for w in got_warn] == [str(w.message) for w in want_warn]


@pytest.mark.parametrize("max_seq_len, min_feedback", [(4, 0), (50, 6)])
def test_load_beauty_equals_jax(max_seq_len, min_feedback, tmp_path):
    p = tmp_path / "beauty.txt"
    p.write_text("".join(f"u{u} item{(u * 2 + i) % 8}\n" for u in range(3) for i in range(6 + u)))
    seqs, vocab = beauty.load_beauty(str(p), max_seq_len=max_seq_len, min_feedback=min_feedback)
    jseqs, jvocab = jbeauty.load_beauty(str(p), max_seq_len=max_seq_len, min_feedback=min_feedback)
    _same_sequences(seqs, jseqs)
    assert vocab.tokens == jvocab.tokens


# -- the prepare script, then training on its output -------------------------------------


@pytest.mark.parametrize("fmt", ["pairs_txt", "amazon_json"])
def test_prepare_data_torch_equals_jax_script(fmt, tmp_path):
    """prepare_data_torch.py's directory holds what prepare_data.py's does:
    the same vocabulary file and the same shards' arrays."""
    from examples.bert4rec.prepare_data import main as jprep
    from examples.bert4rec.prepare_data_torch import main as prep

    if fmt == "amazon_json":
        src = str(tmp_path / "reviews.json.gz")
        _write_json(src, [{"reviewerID": f"u{i % 3}", "asin": f"item{i % 5}", "unixReviewTime": 1000 + i}
                          for i in range(12)])
        extra = ["--format", "amazon_json", "--min_item_per_user", "2"]
    else:
        src = str(tmp_path / "beauty.txt")
        (tmp_path / "beauty.txt").write_text("".join(f"u{u} item{(u + i) % 7}\n" for u in range(5) for i in range(6)))
        extra = []
    for fn, out in ((prep, "port"), (jprep, "jax")):
        fn(["--input", src, "--output", str(tmp_path / out), "--records_per_shard", "2", *extra])
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    assert (port / "vocabs" / "item_vocab.txt").read_text() == (jax_dir / "vocabs" / "item_vocab.txt").read_text()
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_dir))
    _same_sequences(etl.read_packed(str(port / "sequences_*.npz")), jetl.read_packed(str(jax_dir / "sequences_*.npz")))


def test_prepared_directory_trains_with_train_torch(tmp_path):
    """prepare_data_torch.py -> train_torch.py --device cpu --data <dir>:
    one epoch trains on the prepared sequences and writes its history."""
    src = tmp_path / "beauty.txt"
    rng = np.random.default_rng(0)
    src.write_text("".join(f"u{u} item{rng.integers(0, 40)}\n" for u in range(60) for _ in range(8)))
    out = tmp_path / "prepared"
    subprocess.run([sys.executable, os.path.join(REPO, "examples", "bert4rec", "prepare_data_torch.py"),
                    "--input", str(src), "--output", str(out)], check=True, capture_output=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=""))
    run = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "bert4rec", "train_torch.py"), "--device", "cpu",
         "--data", str(out), "--model_dir", str(tmp_path / "run"), "--d_model", "16", "--layers", "1",
         "--heads", "2", "--epochs", "1", "--batch", "16", "--max_items", "10"],
        capture_output=True, text=True, timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert run.returncode == 0, run.stderr[-3000:]
    with open(tmp_path / "run" / "history.jsonl") as f:
        hist = [json.loads(line) for line in f]
    assert len(hist) == 1 and np.isfinite(hist[0]["train_loss"])
