"""The port's parallel tiers against the JAX package's, on the CPU.

The port's worlds are spawned processes over gloo and a ``FileStore`` under
``tmp_path`` (``parallel/mesh.py:spawn``), one thread each; their targets
live in ``tests/torch_parallel_workers.py``, which imports no JAX. Each
world runs several checks and returns numpy. The JAX side runs its tiers
under ``shard_map`` on the 8-device CPU mesh of ``tests/conftest.py``
(Pallas in interpret mode). Weights are made with numpy from a seed in the
flax tree and moved across with ``convert.py``; f32, dropout 0 unless
stated. Sizes follow ``tests/test_parallel.py``: 22 items, d 16, one
layer, two heads, B = 8, a (2, 2) mesh for the vocab-sharded tier and (2,
1) for the data-parallel one, the table padded by ``padded_vocab_rows``.

Tolerances: losses 1e-5 relative, parameters after the steps 1e-4
absolute. The key bias is held only to the size of its steps (2 * lr *
steps): its gradient is zero in exact arithmetic, so both sides step on the
noise's sign (``tests/test_torch_train.py``).
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
from jax.sharding import PartitionSpec as P

from bert4clickpath_tpu.config import FeatureConfig as JFeature
from bert4clickpath_tpu.config import HeadConfig as JHead
from bert4clickpath_tpu.config import MeshConfig as JMeshConfig
from bert4clickpath_tpu.config import ModelConfig as JModelConfig
from bert4clickpath_tpu.config import TrainConfig as JTrainConfig
from bert4clickpath_tpu.data.generator import ClickStreamGenerator as JGenerator
from bert4clickpath_tpu.data.pipeline import ClozeDataset as JDataset
from bert4clickpath_tpu.models.model import ClickstreamModel as JModel
from bert4clickpath_tpu.ops.pallas import fused_ce as jfused
from bert4clickpath_tpu.parallel import spmd as jspmd
from bert4clickpath_tpu.parallel import support as jsupport
from bert4clickpath_tpu.parallel.mesh import make_mesh as jmake_mesh
from bert4clickpath_tpu.training import schedules as jsched
from bert4clickpath_tpu.training import train_state as jts
from bert4clickpath_torch.config import ModelConfig, TrainConfig
from bert4clickpath_torch.constants import LABEL_PAD
from bert4clickpath_torch.convert import state_dict_from_flax
from bert4clickpath_torch.data.pipeline import to_device
from bert4clickpath_torch.models.model import ClickstreamModel
from bert4clickpath_torch.ops.chunked_eval import chunked_eval_stats, pick_chunk
from bert4clickpath_torch.ops.fused_ce import dense_softmax_ce
from bert4clickpath_torch.ops.kernels import fused_ce as kce
from bert4clickpath_torch.parallel import support
from bert4clickpath_torch.parallel.mesh import spawn
from bert4clickpath_torch.training import schedules
from bert4clickpath_torch.training import train_state as tts

import torch_parallel_workers as workers
from test_torch_cli import BASE, _RUNNER, REPO, SCRIPT, _history

torch.set_num_threads(1)

LR = 1e-3
B = 8
STEPS = 3

# -- data, configs, weights ------------------------------------------------


def _dataset():
    gen = JGenerator(n_items=22, session_cohesiveness=200, seed=0)
    items, _ = gen.generate_sessions(64)
    vocab = gen.item_vocab()
    return JDataset(items, vocab, max_items=20, backend="numpy"), vocab


DS, VOCAB = _dataset()
V = VOCAB.label_vocab_size


def _host(k, seed=0):
    it = DS.train_batches(B, seed=seed)
    return [next(it) for _ in range(k)]


def _np_batch(b) -> dict:
    return {"features": dict(b.features), "head_positions": b.head_positions, "labels": b.labels}


def _jax_batch(b) -> dict:
    return {
        "features": {k: jnp.asarray(v) for k, v in b.features.items()},
        "head_positions": jnp.asarray(b.head_positions),
        "labels": jnp.asarray(b.labels),
    }


def _jcfg(model_shards: int, **kw) -> JModelConfig:
    rows = jspmd.padded_vocab_rows(VOCAB.model_vocab_size, model_shards)
    base = dict(
        features={"items": JFeature(rows, 16)}, num_layers=1, num_heads=2, ffn_dim=32, max_len=23,
        dropout_rate=0.0, head=JHead("tied_softmax"),
    )
    base.update(kw)
    return JModelConfig(**base)


def _seeded(jmodel, batch, seed=1):
    """numpy weights in the flax tree: LayerNorm scales near 1, every other
    leaf N(0, 0.1) (so biases, tied_out_bias and segment rows are live)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch["features"], batch["head_positions"])
    rng = np.random.default_rng(seed)

    def fill(path, s):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + rng.normal(scale=0.1, size=s.shape)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)["params"]


def _port_state(jcfg, params) -> tuple[ModelConfig, dict]:
    cfg = ModelConfig.from_json(jcfg.to_json())
    return cfg, {k: v.numpy() for k, v in state_dict_from_flax(cfg, params).items()}


def _is_key_bias(name: str) -> bool:
    return name.endswith("wk.bias") or name.endswith("wqkv.bias")


def _params_close(cfg, got: dict, want_flax, steps: int, what: str) -> None:
    """The port's params (torch names) against a flax tree: 1e-4, the key
    bias within its steps' size."""
    want = {k: v.numpy() for k, v in state_dict_from_flax(cfg, jax.device_get(want_flax)).items()}
    assert set(got) == set(want), what
    for k, w in want.items():
        atol = 2 * LR * steps if _is_key_bias(k) else 1e-4
        np.testing.assert_allclose(got[k], w, rtol=0, atol=atol, err_msg=f"{what} {k}")


def _world(tmp_path_factory, n: int, jobs: list) -> list:
    """Spawn a gloo world of n ranks that runs the jobs; per rank, the list
    of the jobs' results."""
    store = str(tmp_path_factory.mktemp("world") / "store")
    return spawn(workers.run_jobs, n, store, (jobs,))


def _jmesh(data: int, model: int):
    return jmake_mesh(JMeshConfig(data=data, model=model), devices=jax.devices()[: data * model])


# -- the support matrix -----------------------------------------------------


# the cells the port accepts where the JAX package refuses: its tiers are
# explicit per-rank programs and its attention kernel takes any head slice
# (parallel/support.py:PORT_ACCEPTS)
DEPARTURES = {
    "tp": {"attn:pallas", "dropout:pallas", "embed:pallas"},
    "tp_spmd": {"attn:pallas", "dropout:pallas"},
    "sampled_spmd": {"attn:pallas", "dropout:pallas"},
}


@pytest.mark.parametrize("tier", jsupport.TIERS)
def test_support_rules_equal_jax(tier, monkeypatch):
    """The port's RULES are the JAX package's, feature for feature, but for
    the named departure cells, which the port accepts; its validate_tier
    accepts and refuses on every head and flag combination what the JAX
    validate_tier does on the JAX table without those cells (same
    messages); its render_matrix differs from the JAX one in exactly those
    cells."""
    assert support.TIERS == jsupport.TIERS and support.HEAD_KINDS == jsupport.HEAD_KINDS
    assert {t: set(c) for t, c in support.PORT_ACCEPTS.items()} == DEPARTURES
    gone = DEPARTURES.get(tier, set())
    assert gone <= {f for f, why in jsupport.RULES[tier].items() if why is not None}
    assert support.RULES[tier] == {f: why for f, why in jsupport.RULES[tier].items() if f not in gone}
    combos = [
        dict(attn_impl=a, dropout_impl=dr, embed_impl=e, qkv_fused=q, sampled=s)
        for a in ("xla", "pallas", "auto") for dr in ("xla", "pallas") for e in ("xla", "pallas")
        for q in (False, True) for s in (0, 16)
    ]
    jax_matrix = jsupport.render_matrix()
    monkeypatch.setitem(jsupport.RULES, tier, {f: w for f, w in jsupport.RULES[tier].items() if f not in gone})
    accepted = 0
    for head in jsupport.HEAD_KINDS:
        for kw in combos:
            try:
                jsupport.validate_tier(tier, head, **kw)
                want = None
            except ValueError as e:
                want = str(e)
            try:
                support.validate_tier(tier, head, **kw)
                got = None
            except ValueError as e:
                got = str(e)
            assert got == want, (tier, head, kw)
            accepted += got is None
    assert accepted
    labels = {"attn:pallas": "attn_impl pallas", "dropout:pallas": "dropout_impl pallas",
              "embed:pallas": "embed_impl pallas"}
    changed = set()
    for mine, theirs in zip(support.render_matrix().splitlines(), jax_matrix.splitlines()):
        cells, jcells = mine.strip("|").split("|"), theirs.strip("|").split("|")
        for t, a, c in zip(support.TIERS, cells[1:], jcells[1:]):
            if a != c:
                assert (a.strip(), c.strip()) == ("yes", "no")
                changed.add((t, cells[0].strip()))
    assert changed == {(t, labels[f]) for t, fs in DEPARTURES.items() for f in fs}


@pytest.mark.parametrize("tier", jsupport.TIERS)
def test_tiers_refuse_the_deepseek_block_by_name(tier):
    """Every tier but the single-device step refuses the DeepSeek-V2 block
    by name, through validate_tier and through check_tier on such a model
    (none of them shards the experts or adds the balance loss); BERT4Rec's
    block is left to the matrix."""
    from bert4clickpath_torch.config import DeepSeekV2Config, FeatureConfig, HeadConfig
    from bert4clickpath_torch.parallel import spmd

    cfg = ModelConfig(features={"items": FeatureConfig(128, 64)}, num_layers=2, num_heads=2, ffn_dim=64,
                      dropout_rate=0.0, positional="rope", norm_style="pre",
                      head=HeadConfig("tied_softmax", output_size=100),
                      block=DeepSeekV2Config(kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                                             n_routed_experts=4, num_experts_per_tok=2, moe_intermediate_size=8))
    model = ClickstreamModel(cfg, device="meta")
    if tier == "single":
        support.validate_tier(tier, "tied_softmax", block="deepseek_v2")
        spmd.check_tier(model, tier)
        return
    with pytest.raises(ValueError, match=f"tier {tier!r} rejects block 'deepseek_v2'"):
        support.validate_tier(tier, "tied_softmax", block="deepseek_v2")
    with pytest.raises(ValueError, match="rejects block 'deepseek_v2'"):
        spmd.check_tier(model, tier)
    support.validate_tier("single", "tied_softmax", block="bert4rec")


# -- the plain CE versions with row_start ------------------------------------


def _ce_case(seed=0, n=40, v=256, d=24, off=5, nv=200):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    table = torch.from_numpy(rng.normal(scale=0.4, size=(v, d)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(scale=0.3, size=(v,)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, nv, size=(n,)).astype(np.int64))
    labels[::7] = LABEL_PAD
    dnll = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32)) * (labels != LABEL_PAD).float()
    lab_model = torch.where(labels == LABEL_PAD, -1, labels + off).to(torch.int32)
    return x, table, bias, labels, lab_model, dnll, off, nv


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("entry", ["stats", "merged", "two_pass"])
def test_plain_ce_with_row_start_matches_dense(entry, with_bias):
    """Each CE entry (on the CPU: its plain version) on 4 row shards, each
    with its row_start, against the dense reference: the shards' (m, l)
    combine to the dense logsumexp; dW and db shards are the dense
    gradients' rows; dx summed over the shards is the dense dx (labels on
    other shards keep their softmax share). row_start 0 is bit-equal to the
    call without it."""
    x, table, bias, labels, lab, dnll, off, nv = _ce_case()
    b = bias if with_bias else None
    # dense oracle: logz and, by autograd, dx / dW / db of sum(dnll * nll)
    xr, tr = x.clone().requires_grad_(True), table.clone().requires_grad_(True)
    br = bias.clone().requires_grad_(True) if with_bias else None
    nll = dense_softmax_ce(xr, tr, labels, off, nv, bias=br)
    (nll * dnll).sum().backward()
    rows = slice(off, off + nv)
    dense = x @ table[rows].T + (bias[rows] if with_bias else 0.0)
    logz = torch.logsumexp(dense, dim=-1)
    shards = 4
    v_local = table.shape[0] // shards
    m_all, l_all, dx, dws, dbs = [], [], torch.zeros_like(x), [], []
    for s in range(shards):
        lo = s * v_local
        tb, bb = table[lo : lo + v_local], None if b is None else b[lo : lo + v_local]
        m, l = kce.ce_stats(x, tb, bb, off, nv, row_start=lo)
        m_all.append(m)
        l_all.append(l)
        if entry == "merged":
            sdx, sdw, sdb = kce.ce_backward_merged(x, tb, bb, lab, logz, dnll, off, nv, row_start=lo)
        elif entry == "two_pass":
            sdx = kce.ce_backward_dx(x, tb, bb, lab, logz, dnll, off, nv, row_start=lo)
            sdw, sdb = kce.ce_backward_dw(x, tb, bb, lab, logz, dnll, off, nv, row_start=lo)
        else:
            continue
        dx += sdx
        dws.append(sdw)
        dbs.append(sdb)
    m = torch.stack(m_all)
    gmax = m.max(dim=0).values
    got_logz = gmax + torch.log((torch.stack(l_all) * torch.exp(m - gmax)).sum(dim=0))
    np.testing.assert_allclose(got_logz.numpy(), logz.numpy(), rtol=1e-6, atol=1e-6)
    # row_start 0 is the call without it, bit for bit
    assert all(torch.equal(a, c) for a, c in zip(kce.ce_stats(x, table, b, off, nv),
                                                  kce.ce_stats(x, table, b, off, nv, row_start=0)))
    if entry == "stats":
        return
    np.testing.assert_allclose(dx.numpy(), xr.grad.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(torch.cat(dws).numpy(), tr.grad.numpy(), rtol=1e-5, atol=1e-6)
    if with_bias:
        np.testing.assert_allclose(torch.cat(dbs).numpy(), br.grad.numpy(), rtol=1e-5, atol=1e-6)
    full = kce.ce_backward(x, table, b, lab, logz, dnll, off, nv)
    zero = kce.ce_backward(x, table, b, lab, logz, dnll, off, nv, row_start=0)
    assert all(a is None and c is None or torch.equal(a, c) for a, c in zip(full, zero))


# -- the row-sharded embedding ops (port worlds of 2 and 4, against dense) --


def _embedding_job(model: int) -> dict:
    rng = np.random.default_rng(model)
    v, d, off, nv = 64 * model, 8, 3, 64 * model - 7
    labels = rng.integers(0, nv, size=(4, 3)).astype(np.int64)
    labels[0, 1] = LABEL_PAD
    return dict(
        kind="embedding", model=model, table=rng.normal(size=(v, d)).astype(np.float32),
        ids=rng.integers(0, v, size=(4, 6)).astype(np.int64),
        g_out=rng.normal(size=(4, 6, d)).astype(np.float32), x=rng.normal(size=(4, 3, d)).astype(np.float32),
        labels=labels, bias=rng.normal(scale=0.3, size=(v,)).astype(np.float32), row_offset=off,
        num_valid=nv, k=10,
    )


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One world of 2: the embedding ops at model 2, and the DP tier at
    (2, 1) in its two variants."""
    jobs = [_embedding_job(2)] + [_dp_job(name)[0] for name in DP_VARIANTS]
    return _world(tmp_path_factory, 2, jobs)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """One world of 4: the embedding ops at model 4, the sharded fused CE
    at (2, 2), every SPMD variant and the dropout rule."""
    jobs = [_embedding_job(4)] + [_sharded_ce_job(wb) for wb in (False, True)]
    jobs += [_spmd_job(name)[0] for name in SPMD_VARIANTS] + [_dropout_job(impl) for impl in DROPOUT_IMPLS]
    return _world(tmp_path_factory, 4, jobs)


@pytest.mark.parametrize("model", [2, 4])
def test_embedding_ops_match_dense(model, world2, world4):
    """At model = 2 and 4: the lookup and its gradient (each shard's rows
    of the dense scatter-add), the blinded partial logits, the global CE,
    the top-k and the chunked eval sums against dense references."""
    outs = [r[0] for r in (world2 if model == 2 else world4)]
    job = _embedding_job(model)
    table, ids, x, labels = job["table"], job["ids"], job["x"], job["labels"]
    off, nv = job["row_offset"], job["num_valid"]
    v_local = table.shape[0] // model
    d_table = np.zeros_like(table)
    np.add.at(d_table, ids.reshape(-1), job["g_out"].reshape(-1, table.shape[1]))
    dense = torch.from_numpy(x) @ torch.from_numpy(table).T
    valid = (np.arange(table.shape[0]) >= off) & (np.arange(table.shape[0]) < off + nv)
    blinded = torch.where(torch.from_numpy(valid), dense, torch.full_like(dense, -1e30))
    want_ce = float(dense_softmax_ce(torch.from_numpy(x).reshape(-1, x.shape[-1]), torch.from_numpy(table),
                                     torch.from_numpy(labels).reshape(-1), off, nv).sum()
                    / (labels != LABEL_PAD).sum())
    top_vals, top_idx = torch.topk(blinded, job["k"], dim=-1)
    tb = torch.from_numpy(table)
    want_stats = chunked_eval_stats(torch.from_numpy(x), tb, torch.from_numpy(labels), row_offset=off,
                                    num_valid=nv, chunk=pick_chunk(tb.shape[0]), bias=torch.from_numpy(job["bias"]))
    for r, out in enumerate(outs):
        lo = r * v_local
        np.testing.assert_array_equal(out["lookup"], table[ids])
        np.testing.assert_allclose(out["d_shard"], d_table[lo : lo + v_local], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out["logits"], blinded[..., lo : lo + v_local].numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out["ce"], want_ce, rtol=1e-5)
        np.testing.assert_allclose(out["top_vals"], top_vals.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(out["top_idx"], top_idx.numpy())
        for k, w in want_stats.items():
            np.testing.assert_allclose(out["stats"][k], float(w), rtol=1e-5, err_msg=k)


# -- the vocab-sharded fused CE at (2, 2) against JAX under shard_map -------


def _sharded_ce_inputs(with_bias: bool):
    rng = np.random.default_rng(11)
    v, d, nv = 512, 16, 400  # 256 rows a shard
    x = rng.normal(size=(4, 6, d)).astype(np.float32)
    table = rng.normal(scale=0.5, size=(v, d)).astype(np.float32)
    labels = rng.integers(0, nv, size=(4, 6)).astype(np.int32)
    labels[0, 3] = labels[3, 5] = LABEL_PAD
    bias = rng.normal(scale=0.3, size=(v,)).astype(np.float32) if with_bias else None
    return x, table, labels, bias, 10, nv


def _sharded_ce_job(with_bias: bool) -> dict:
    x, table, labels, bias, off, nv = _sharded_ce_inputs(with_bias)
    return dict(kind="sharded_ce", mesh=(2, 2), x=x, table=table, labels=labels.astype(np.int64), bias=bias,
                row_offset=off, num_valid=nv)


@pytest.mark.parametrize("with_bias", [False, True])
def test_sharded_fused_ce_matches_jax(with_bias, world4):
    """loss, dx, the dW shards (summed over the data group, as a train step
    does) and db within 1e-5 of JAX's sharded_fused_softmax_ce[_bias] on a
    (2, 2) mesh."""
    x, table, labels, bias, off, nv = _sharded_ce_inputs(with_bias)
    mesh = _jmesh(2, 2)

    def mapped(x, t, lbl, *b):
        if b:
            f = lambda x, t, b: jfused.sharded_fused_softmax_ce_bias(x, t, b, lbl, off, nv, "model", "data")  # noqa: E731
            loss, (gx, gt, gb) = jax.value_and_grad(f, argnums=(0, 1, 2))(x, t, b[0])
            return loss, (gx, jax.lax.psum(gt, "data"), jax.lax.psum(gb, "data"))
        f = lambda x, t: jfused.sharded_fused_softmax_ce(x, t, lbl, off, nv, "model", "data")  # noqa: E731
        loss, (gx, gt) = jax.value_and_grad(f, argnums=(0, 1))(x, t)
        return loss, (gx, jax.lax.psum(gt, "data"))

    specs = (P("data", None, None), P("model", None), P("data", None)) + ((P(),) if with_bias else ())
    outs = (P("data", None, None), P("model", None)) + ((P(),) if with_bias else ())
    args = (x, table, labels) + ((bias,) if with_bias else ())
    jloss, jgrads = jax.jit(jax.shard_map(mapped, mesh=mesh, in_specs=specs, out_specs=(P(), outs),
                                          check_vma=False))(*args)
    idx = 1 + int(with_bias)
    res = {tuple(r[idx]["coords"]): r[idx] for r in world4}
    for r in res.values():
        np.testing.assert_allclose(r["loss"], float(jloss), rtol=1e-5)
    dx = np.concatenate([res[(d, 0)]["dx"] for d in range(2)])
    np.testing.assert_array_equal(dx, np.concatenate([res[(d, 1)]["dx"] for d in range(2)]))
    dw = np.concatenate([res[(0, m)]["dw"] + res[(1, m)]["dw"] for m in range(2)])

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))

    close(dx, jgrads[0])
    close(dw, jgrads[1])
    if with_bias:
        close(res[(0, 0)]["db"] + res[(1, 0)]["db"], jgrads[2])
        np.testing.assert_array_equal(res[(0, 0)]["db"], res[(0, 1)]["db"])


# -- the SPMD tier at (2, 2) against JAX's make_spmd_train_step -------------

SPMD_VARIANTS = {
    "plain": {},
    "tied_bias": dict(head=JHead("tied_softmax", output_size=V, tied_bias=True)),
    # the tied transform's last width 24 != d_item 16: tied_proj too
    "transform_segments": dict(use_segment_embeddings=True, head=JHead("tied_softmax", dense_dims=(24,))),
    "learned_positions": dict(positional="learned"),
    "factorized": dict(features={"items": JFeature(jspmd.padded_vocab_rows(VOCAB.model_vocab_size, 2), 8)},
                       encoder_dim=16),
    "steps_per_call": {},
    "ema": {},
}
EMA_DECAY = 0.9


def _spmd_job(name: str):
    jcfg = _jcfg(2, **SPMD_VARIANTS[name])
    spc = 2 if name == "steps_per_call" else 1
    host = _host(4 if spc > 1 else STEPS)
    params = _seeded(JModel(jcfg), _jax_batch(host[0]))
    cfg, state = _port_state(jcfg, params)
    batches = [_np_batch(b) for b in host]
    if spc > 1:
        batches = [
            {"features": {k: np.stack([a["features"][k], c["features"][k]]) for k in a["features"]},
             "head_positions": np.stack([a["head_positions"], c["head_positions"]]),
             "labels": np.stack([a["labels"], c["labels"]])}
            for a, c in zip(batches[::2], batches[1::2])
        ]
    ev = _np_batch(next(DS.eval_batches(B)))
    job = dict(kind="tier", tier="spmd", config=cfg.to_json(), state=state, mesh=(2, 2), device="cpu",
               batches=batches, eval_batches=[ev], num_valid=V, lr=LR, steps_per_call=spc,
               ema_decay=EMA_DECAY if name == "ema" else 0.0)
    return job, jcfg, params, host


@pytest.mark.parametrize("name", list(SPMD_VARIANTS))
def test_spmd_train_step_matches_jax(name, world4):
    """STEPS steps (4 for steps_per_call = 2, in two calls of a stacked
    batch, against the JAX step's four sequential calls) of the port's SPMD
    step at (2, 2): the loss of every step within 1e-5 and the gathered
    parameters within 1e-4 of JAX's (with ema, the sharded EMA shadow
    too); the eval sums on the trained parameters (the EMA shadow) against
    JAX's make_spmd_eval_step."""
    job, jcfg, params, host = _spmd_job(name)
    cfg = ModelConfig.from_json(job["config"])
    mesh = _jmesh(2, 2)
    jtx = jts.make_optimizer(JTrainConfig())
    ema = job["ema_decay"] > 0
    jstate = jspmd.shard_state(jts.TrainState.create(params, jtx, ema=ema), mesh, jcfg)
    jstep = jspmd.make_spmd_train_step(jcfg, mesh, jtx, jsched.constant(LR), V, ema_decay=job["ema_decay"])
    jl = []
    for b in host:
        jstate, loss = jstep(jstate, jspmd.shard_batch(_jax_batch(b), mesh, jcfg), jax.random.PRNGKey(1))
        jl.append(float(loss))
    jev = jspmd.make_spmd_eval_step(jcfg, mesh, V)(jts.eval_params(jstate), jspmd.shard_batch(
        _jax_batch(next(DS.eval_batches(B))), mesh, jcfg))
    out = [r[3 + list(SPMD_VARIANTS).index(name)] for r in world4]
    for r in out:
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5)
    _params_close(cfg, out[0]["params"], jstate.params, len(host), name)
    if ema:
        _params_close(cfg, out[0]["ema"], jstate.ema_params, len(host), f"{name} ema")
    for r in out[1:]:
        for k, t in out[0]["params"].items():
            np.testing.assert_array_equal(r["params"][k], t, err_msg=k)
    for k, w in jev.items():
        np.testing.assert_allclose(out[0]["evals"][0][k], float(w), rtol=1e-5, atol=1e-6, err_msg=k)
    launches = out[0]["train_launches"]
    assert sum(launches.values()) == 0  # the CPU takes the plain versions


DROPOUT_IMPLS = ("mask", "fused")


def _dropout_job(impl: str) -> dict:
    job, *_ = _spmd_job("plain")
    cfg = ModelConfig.from_json(job["config"])
    job["config"] = dataclasses.replace(cfg, dropout_rate=0.1).to_json()
    return {**job, "dropout_seed": 5, "dropout_impl": impl, "eval_batches": []}


@pytest.mark.parametrize("impl", DROPOUT_IMPLS)
def test_spmd_dropout_keeps_model_ranks_bit_equal(impl, world4):
    """Dropout 0.1 (each back end's plain version), 3 steps at (2, 2): the
    generator is seeded from (seed, data index) only, so the model ranks of
    a data group draw the same masks and every rank's replicated
    parameters (and the table) stay bit-equal; the losses differ from the
    dropout-free run's."""
    out = {tuple(r[3 + len(SPMD_VARIANTS) + DROPOUT_IMPLS.index(impl)]["coords"]):
           r[3 + len(SPMD_VARIANTS) + DROPOUT_IMPLS.index(impl)] for r in world4}
    for k, t in out[(0, 0)]["params"].items():
        for coords in ((0, 1), (1, 0), (1, 1)):
            np.testing.assert_array_equal(out[coords]["params"][k], t, err_msg=f"{k} {coords}")
    plain = world4[0][3]["losses"]
    assert np.all(np.isfinite(out[(0, 0)]["losses"])) and not np.allclose(out[(0, 0)]["losses"], plain)


# -- the DP tier at (2, 1) against JAX's make_dp_*_step and one process ----

DP_VARIANTS = {
    "tied_fused": dict(),
    "softmax_dense": dict(features={"items": JFeature(VOCAB.model_vocab_size, 16)},
                          head=JHead("softmax", (32, 24), V)),
}


def _dp_job(name: str):
    jcfg = _jcfg(1, **DP_VARIANTS[name])
    host = _host(STEPS)
    params = _seeded(JModel(jcfg), _jax_batch(host[0]))
    cfg, state = _port_state(jcfg, params)
    ev = _np_batch(next(DS.eval_batches(B)))
    job = dict(kind="tier", tier="dp", config=cfg.to_json(), state=state, mesh=(2, 1), device="cpu",
               batches=[_np_batch(b) for b in host], eval_batches=[ev], num_valid=V, lr=LR,
               fused=name == "tied_fused")
    return job, jcfg, params, host


@pytest.mark.parametrize("name", list(DP_VARIANTS))
def test_dp_train_and_eval_match_jax_and_one_process(name, world2):
    """3 DP steps at (2, 1): losses 1e-5 and params 1e-4 against JAX's
    make_dp_train_step on a (2, 1) mesh and against the port's one-process
    step on the full batch; the eval sums against JAX's make_dp_eval_step
    and the one-process eval step."""
    job, jcfg, params, host = _dp_job(name)
    cfg = ModelConfig.from_json(job["config"])
    fused = job["fused"]
    mesh = _jmesh(2, 1)
    jmodel = JModel(jcfg)
    jtx = jts.make_optimizer(JTrainConfig())
    jstate = jspmd.replicate_state(jts.TrainState.create({"params": params}, jtx), mesh)
    jstep = jspmd.make_dp_train_step(jmodel, mesh, jtx, jsched.constant(LR), fused_ce_num_valid=V if fused else None)
    jl = []
    for b in host:
        jstate, loss = jstep(jstate, jspmd.shard_batch(_jax_batch(b), mesh, jcfg), jax.random.PRNGKey(1))
        jl.append(float(loss))
    ev = next(DS.eval_batches(B))
    jev = jspmd.make_dp_eval_step(jmodel, mesh, chunked_num_valid=V if fused else None)(
        jstate.params, jspmd.shard_batch(_jax_batch(ev), mesh, jcfg))
    # the port in one process, on the full batches
    model = ClickstreamModel(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in job["state"].items()})
    tx = tts.make_optimizer(TrainConfig())
    step = tts.make_train_step(model, tx, schedules.constant(LR), fused_ce_num_valid=V if fused else None)
    state = tts.TrainState.create(dict(model.named_parameters()), tx)
    one = []
    for b in host:
        state, loss = step(state, to_device(b, "cpu"))
        one.append(loss.item())
    one_eval = tts.make_eval_step(model, chunked_num_valid=V if fused else None)(state.params, to_device(ev, "cpu"))
    idx = 1 + list(DP_VARIANTS).index(name)
    for r in (world2[0][idx], world2[1][idx]):
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5)
        np.testing.assert_allclose(r["losses"], one, rtol=1e-5)
    got = world2[0][idx]["params"]
    _params_close(cfg, got, jstate.params["params"], STEPS, name)
    for k, p in state.params.items():
        atol = 2 * LR * STEPS if _is_key_bias(k) else 1e-4
        np.testing.assert_allclose(got[k], p.detach().numpy(), rtol=0, atol=atol, err_msg=k)
    for k, w in jev.items():
        np.testing.assert_allclose(world2[0][idx]["evals"][0][k], float(w), rtol=1e-5, atol=1e-6, err_msg=k)
    for k, w in one_eval.items():
        np.testing.assert_allclose(world2[1][idx]["evals"][0][k], float(w), rtol=1e-5, atol=1e-6, err_msg=k)


# -- the training CLI, data-parallel over two ranks ---------------------------


def test_cli_dp_two_ranks_matches_one_process(tmp_path):
    """``train_torch.py --parallel dp --device cpu`` under torchrun with two
    ranks writes the history the one-process run writes at the same global
    batch (f32): every loss and metric within 1e-4; rank 0 alone writes."""
    flags = ["--preset", "tpu", "--d_model", "32", "--layers", "1", "--heads", "2", "--epochs", "2",
             "--dtype", "float32", "--dropout", "0", "--steps_per_epoch", "3"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    dp = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2", "--no-python",
         sys.executable, "-c", _RUNNER, SCRIPT, *BASE, "--model_dir", str(tmp_path / "dp"), "--parallel", "dp",
         *flags],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO,
    )
    assert dp.returncode == 0, dp.stderr[-3000:]
    assert "data-parallel over 2 ranks" in dp.stdout and "JAX_SIDE_MODULES []" in dp.stdout
    one = subprocess.run(
        [sys.executable, "-c", _RUNNER, SCRIPT, *BASE, "--model_dir", str(tmp_path / "one"), *flags],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO,
    )
    assert one.returncode == 0, one.stderr[-3000:]
    got, want = _history(tmp_path / "dp"), _history(tmp_path / "one")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k, v in w.items():
            if k in ("epoch_seconds", "eval_seconds"):
                continue
            np.testing.assert_allclose(g[k], v, rtol=1e-4, err_msg=k)
    assert os.path.isdir(tmp_path / "dp" / "export")
    assert sorted(os.listdir(tmp_path / "dp" / "ckpts")) == sorted(os.listdir(tmp_path / "one" / "ckpts"))
