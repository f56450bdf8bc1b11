"""The port's serving slice vs the JAX package's.

The same weights (seeded numpy values in the flax tree, moved across by
``state_dict_from_flax``) and the same vocab are exported by each package
and served by each ``ServingModel``; the port runs with ``device="cpu"``
(the kernels' plain versions). Scores are log-probs, compared at
rtol/atol 1e-4 (f32; sums in another order). Item ids are compared where
neighbouring scores differ by more than that, since torch.topk and
lax.top_k order exact ties differently.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert4clickpath_tpu.config import FeatureConfig as JFeature
from bert4clickpath_tpu.config import HeadConfig as JHead
from bert4clickpath_tpu.config import ModelConfig as JModelConfig
from bert4clickpath_tpu.models.model import ClickstreamModel as JModel
from bert4clickpath_tpu.training import checkpoint as jckpt
from bert4clickpath_tpu.training.serving import ServingModel as JServing
from bert4clickpath_tpu.vocab import Vocabulary as JVocab
from bert4clickpath_torch.config import ModelConfig
from bert4clickpath_torch.convert import state_dict_from_flax
from bert4clickpath_torch.training import checkpoint as tckpt
from bert4clickpath_torch.training.serving import ServingModel
from bert4clickpath_torch.vocab import Vocabulary

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ITEMS, D, L = 300, 32, 13  # max_items = L - 3 = 10
TOL = 1e-4


def _items(n=N_ITEMS, prefix="item_"):
    return [f"{prefix}{i}" for i in range(n)]


def _seeded_params(jcfg):
    model = JModel(jcfg)
    feats = {n: jnp.zeros((1, jcfg.max_len), jnp.int32) for n in jcfg.features}
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), feats, jnp.zeros((1, jcfg.head_width), jnp.int32))
    rng = np.random.default_rng(7)

    def fill(path, s):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + rng.normal(scale=0.1, size=s.shape)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _bundles(tmp, jcfg, vocab_tokens):
    """Export the same weights with both packages; load both servers."""
    jvocabs = {n: JVocab(t) for n, t in vocab_tokens.items()}
    tvocabs = {n: Vocabulary(t) for n, t in vocab_tokens.items()}
    params = _seeded_params(jcfg)
    jdir = jckpt.export_serving(str(tmp / "jax"), params, jcfg, jvocabs)
    cfg = ModelConfig.from_json(jcfg.to_json())
    tdir = tckpt.export_serving(str(tmp / "torch"), state_dict_from_flax(cfg, params), cfg, tvocabs)
    return JServing(jdir), ServingModel(tdir, device="cpu"), jdir, tdir


def _base_cfg(**kw):
    vocab = JVocab(_items())
    base = dict(
        features={"items": JFeature(vocab.model_vocab_size, D)},
        num_layers=2, num_heads=4, ffn_dim=64, max_len=L,
        head=JHead("tied_softmax", output_size=vocab.label_vocab_size),
        qkv_fused=True,
    )
    base.update(kw)
    return JModelConfig(**base)


@pytest.fixture(scope="module")
def tied(tmp_path_factory):
    return _bundles(tmp_path_factory.mktemp("tied"), _base_cfg(), {"items": _items()})


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        gs = np.array([s for _, s in g])
        ws = np.array([s for _, s in w])
        np.testing.assert_allclose(gs, ws, rtol=TOL, atol=TOL)
        assert (np.diff(gs) <= 0).all()  # descending log-probs
        sep = np.ones(len(g), bool)
        gaps = np.diff(ws) < -TOL
        sep[:-1] &= gaps
        sep[1:] &= gaps
        assert [n for (n, _), s in zip(g, sep) if s] == [n for (n, _), s in zip(w, sep) if s]


SESSIONS = [
    ["item_0", "item_1", "item_2"],
    [f"item_{i}" for i in range(40, 55)],  # 15 events: truncated to the last 8
    ["item_299", "not_an_item", "item_5"],  # OOV token
    [],  # empty session: only the [MASK] slot
    ["item_7"],
]


def test_recommend_matches_jax(tied):
    jserv, tserv, _, _ = tied
    # 5 sessions -> bucket 8, 3 sessions -> bucket 4
    for sessions in (SESSIONS, SESSIONS[:3]):
        got = tserv.recommend(sessions, k=5)
        _assert_same(got, jserv.recommend(sessions, k=5))
    assert all(name.startswith("item_") for name, _ in got[0])


def test_truncation_keeps_most_recent_window(tied):
    """Events before the last max_items-1 do not change the answer."""
    _, tserv, _, _ = tied
    long = [f"item_{i}" for i in range(100, 130)]
    assert tserv.recommend([long], k=5) == tserv.recommend([long[-9:]], k=5)
    assert tserv.recommend([long], k=5) != tserv.recommend([long[-8:]], k=5)


def test_instance_ids_pass_through(tied):
    jserv, tserv, _, _ = tied
    got = tserv.recommend(SESSIONS[:2], k=5, instance_ids=["req-a", "req-b"])
    want = jserv.recommend(SESSIONS[:2], k=5, instance_ids=["req-a", "req-b"])
    assert [r["instance_id"] for r in got] == ["req-a", "req-b"]
    _assert_same([r["items"] for r in got], [r["items"] for r in want])
    with pytest.raises(ValueError, match="instance_ids"):
        tserv.recommend(SESSIONS[:2], k=5, instance_ids=["only-one"])
    assert tserv.recommend([], k=5) == []


def test_warmup_buckets_and_ks(tied):
    _, _, _, tdir = tied
    served = ServingModel(tdir, device="cpu", warmup_batches=(3,), warmup_k=(3, 5))
    assert len(served.recommend(SESSIONS[:3], k=3)[0]) == 3


@pytest.mark.parametrize("head", ["tied_bias_transform", "softmax"])
def test_other_heads_match_jax(tmp_path, head):
    """A tied head with a bias and an MLM transform, and the parity softmax
    (MLP) head, whose catalog is its final Dense rows."""
    vocab = JVocab(_items())
    if head == "softmax":
        h = JHead("softmax", dense_dims=(48,), output_size=vocab.label_vocab_size)
    else:
        h = JHead("tied_softmax", dense_dims=(24,), output_size=vocab.label_vocab_size, tied_bias=True)
    jserv, tserv, _, _ = _bundles(tmp_path, _base_cfg(head=h, norm_style="pre", positional="learned"), {"items": _items()})
    _assert_same(tserv.recommend(SESSIONS[:4], k=5), jserv.recommend(SESSIONS[:4], k=5))


def test_multi_feature_dict_sessions(tmp_path):
    """(action, item) events: dict sessions, [NA] in the paired feature's
    appended slot, and the same ValueErrors as the JAX server."""
    items, actions = _items(), [f"act_{i}" for i in range(5)]
    jcfg = _base_cfg(
        features={
            "items": JFeature(JVocab(items).model_vocab_size, 24),
            "actions": JFeature(JVocab(actions).model_vocab_size, 8),
        },
        qkv_fused=False,
    )
    jserv, tserv, _, _ = _bundles(tmp_path, jcfg, {"items": items, "actions": actions})
    sessions = [
        {"items": ["item_3", "item_4"], "actions": ["act_0", "act_2"]},
        {"items": ["item_9"], "actions": ["act_1"]},
    ]
    _assert_same(tserv.recommend(sessions, k=5), jserv.recommend(sessions, k=5))
    bad = [
        [{"items": ["item_3"]}],  # missing feature
        [{"items": ["item_3", "item_4"], "actions": ["act_0"]}],  # misaligned
        [["item_3"]],  # list session on a multi-feature model
    ]
    for sessions in bad:
        with pytest.raises(ValueError) as t_err:
            tserv.recommend(sessions, k=5)
        with pytest.raises(ValueError) as j_err:
            jserv.recommend(sessions, k=5)
        assert str(t_err.value) == str(j_err.value)


def test_head_without_catalog_is_refused(tmp_path):
    cfg = ModelConfig.from_json(_base_cfg(head=JHead("binary", (8,))).to_json())
    tdir = tckpt.export_serving(str(tmp_path / "b"), {}, cfg, {"items": Vocabulary(_items())})
    with pytest.raises(ValueError, match="no catalog to rank"):
        ServingModel(tdir, device="cpu")


def test_artifacts_load_in_both_packages(tied, tmp_path):
    """model_config.json and vocab_<name>.json are byte-compatible both ways."""
    _, _, jdir, tdir = tied
    for name in ("model_config.json", "vocab_items.json", "MANIFEST.json"):
        with open(os.path.join(jdir, name), "rb") as a, open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    jcfg = _base_cfg(
        positional="learned", norm_style="pre", segment_bounds=(0, 1), routing="segment",
        head=JHead("tied_softmax", dense_dims=(4, 2), tied_bias=True),
    )
    assert ModelConfig.from_json(jcfg.to_json()).to_json() == jcfg.to_json()
    assert JModelConfig.from_json(ModelConfig.from_json(jcfg.to_json()).to_json()) == jcfg
    tokens = ["a", "b c", "ü", "item_1"]
    JVocab(tokens).save_artifact(str(tmp_path / "j"), "x")
    Vocabulary(tokens).save_artifact(str(tmp_path / "t"), "x")
    with open(tmp_path / "j" / "vocab_x.json", "rb") as a, open(tmp_path / "t" / "vocab_x.json", "rb") as b:
        assert a.read() == b.read()
    assert Vocabulary.load_artifact(str(tmp_path / "j"), "x").tokens == tokens
    assert JVocab.load_artifact(str(tmp_path / "t"), "x").tokens == tokens


def test_port_never_imports_jax():
    """Importing the serving and training paths, the trainer, the training
    CLI, the task drivers, the sampled-softmax path, every module of the
    parallel tiers (and the tests' worker module), the large-catalog
    stress, the multi-host demo, the data-prep script, the utility modules
    and chip_smoke pulls in no jax, flax, optax, orbax or JAX-package
    module."""
    code = (
        "import sys, bert4clickpath_torch.training.serving, bert4clickpath_torch.convert, chip_smoke\n"
        "import bert4clickpath_torch.training.train_state, bert4clickpath_torch.ops.fused_ce\n"
        "import bert4clickpath_torch.data.pipeline, bert4clickpath_torch.data.native\n"
        "import bert4clickpath_torch.data.generator, bert4clickpath_torch.training.schedules\n"
        "import bert4clickpath_torch.ops.losses, bert4clickpath_torch.ops.kernels.dropout\n"
        "import bert4clickpath_torch.data.synthetic, examples.long_context.bench_torch\n"
        "import bert4clickpath_torch.ops.metrics, bert4clickpath_torch.ops.chunked_eval\n"
        "import bert4clickpath_torch.training.trainer, bert4clickpath_torch.training.checkpoint\n"
        "import bert4clickpath_torch.utils.tb, bert4clickpath_torch.data.beauty, bert4clickpath_torch.data.etl\n"
        "import bert4clickpath_torch.ops.kernels.fused_ce, examples.bert4rec.train_torch\n"
        "import bert4clickpath_torch.data.chaining, bert4clickpath_torch.models.heads\n"
        "import examples.chained.train_torch, examples.tasks.multilabel_torch\n"
        "import examples.bert4rec.transfer_torch, examples.bert4rec.multivariable_torch\n"
        "import bert4clickpath_torch.parallel.mesh, bert4clickpath_torch.parallel.support\n"
        "import bert4clickpath_torch.parallel.embedding, bert4clickpath_torch.parallel.spmd\n"
        "import bert4clickpath_torch.parallel.drive, tests.torch_parallel_workers\n"
        "from bert4clickpath_torch.ops.losses import sampled_softmax_ce, sample_negatives\n"
        "from bert4clickpath_torch.training.train_state import sampled_head_ce_sums\n"
        "import bert4clickpath_torch.parallel.tp, bert4clickpath_torch.parallel.tp_spmd\n"
        "import bert4clickpath_torch.utils.profiling, bert4clickpath_torch.utils.debug\n"
        "import bert4clickpath_torch.utils.cli, examples.large_catalog.stress_torch\n"
        "import examples.multihost.demo_torch, examples.bert4rec.prepare_data_torch\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'bert4clickpath_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)


def test_cuda_server_refuses_to_fall_back(tied):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-GPU refusal")
    _, _, _, tdir = tied
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingModel(tdir)  # the default device is cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingModel(tdir, device="cuda:0")


def test_dataclasses_match_jax_fields():
    """The copied config keeps the JAX package's fields and defaults; the
    port's own fields (``PORT_ONLY_FIELDS``) follow them, defaulting to
    None (BERT4Rec's block, as the JAX package builds it)."""
    from bert4clickpath_torch import config as tc
    from bert4clickpath_tpu import config as jc

    for name in ("FeatureConfig", "HeadConfig", "ModelConfig", "TrainConfig", "MeshConfig"):
        jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jc, name))]
        tf = [(f.name, f.default) for f in dataclasses.fields(getattr(tc, name))]
        extra = tc.PORT_ONLY_FIELDS if name == "ModelConfig" else ()
        assert jf == tf[: len(tf) - len(extra)], name
        assert tf[len(jf):] == [(f, None) for f in extra], name
