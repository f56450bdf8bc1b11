"""The port's tensor-parallel tier, its composition with the vocab-sharded
tier and sampled softmax over the row-sharded table, against the JAX
package's tiers on the CPU.

As in ``tests/test_torch_parallel.py`` (whose helpers this file shares):
the port's worlds are spawned gloo processes (one world of 2 and one of 4
ranks for the module, each running all its jobs through
``parallel/drive.py`` or ``tests/torch_parallel_workers.py``); the JAX side
runs its tiers on the 8-device CPU mesh of ``tests/conftest.py``; weights
are made with numpy from a seed in the flax tree and moved across with
``convert.py``; f32 and dropout 0 unless stated. Sizes follow
``tests/test_parallel.py``: the TP tier on 40 items, d 32, two layers, four
heads, FFN 64 (its lines 708-727); the composed and sampled tiers on 22
items, d 16, two layers, two heads, FFN 32 (lines 1087-1106); B = 8 global
rows, at (data, model) = (1, 2) and (2, 2).

The JAX tiers refuse their Pallas kernels where the port runs its
attention kernel (``parallel/support.py:PORT_ACCEPTS``): they run with
``attn_impl="xla"``, the function the port's kernel computes.

Tolerances: losses 1e-5 relative (the sampled tier 2e-4, bf16 2e-2),
parameters after the steps 1e-4 absolute, the key bias within its steps'
size (2 * lr * steps: its gradient is zero in exact arithmetic), eval sums
1e-5.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from bert4clickpath_tpu.config import FeatureConfig as JFeature
from bert4clickpath_tpu.config import HeadConfig as JHead
from bert4clickpath_tpu.config import TrainConfig as JTrainConfig
from bert4clickpath_tpu.data.generator import ClickStreamGenerator as JGenerator
from bert4clickpath_tpu.data.pipeline import ClozeDataset as JDataset
from bert4clickpath_tpu.models.model import ClickstreamModel as JModel
from bert4clickpath_tpu.parallel import spmd as jspmd
from bert4clickpath_tpu.parallel import tp as jtp
from bert4clickpath_tpu.parallel import tp_spmd as jtp_spmd
from bert4clickpath_tpu.training import schedules as jsched
from bert4clickpath_tpu.training import train_state as jts
from bert4clickpath_torch.config import MeshConfig, ModelConfig, TrainConfig
from bert4clickpath_torch.constants import LABEL_PAD
from bert4clickpath_torch.convert import state_dict_from_flax
from bert4clickpath_torch.data.pipeline import to_device
from bert4clickpath_torch.models.model import ClickstreamModel
from bert4clickpath_torch.ops import losses as tlosses
from bert4clickpath_torch.parallel import spmd, support, tp, tp_spmd
from bert4clickpath_torch.parallel.mesh import Mesh
from bert4clickpath_torch.training import schedules
from bert4clickpath_torch.training import train_state as tts

from test_torch_parallel import (
    B, DS, LR, STEPS, V, _host, _is_key_bias, _jax_batch, _jcfg, _jmesh, _np_batch, _params_close, _port_state,
    _seeded, _world,
)

torch.set_num_threads(1)

S = 16  # sampled softmax: negatives a step
KEY = jax.random.PRNGKey(1)


def _tp_dataset():
    gen = JGenerator(n_items=40, session_cohesiveness=200, seed=0)
    items, _ = gen.generate_sessions(96)
    vocab = gen.item_vocab()
    return JDataset(items, vocab, max_items=16, backend="numpy"), vocab


TP_DS, TP_VOCAB = _tp_dataset()
TP_V = TP_VOCAB.label_vocab_size


def _tp_jcfg(head: str):
    return _jcfg(
        1, features={"items": JFeature(TP_VOCAB.model_vocab_size, 32)}, num_layers=2, num_heads=4, ffn_dim=64,
        max_len=19,
        head=JHead("tied_softmax", tied_bias=True) if head == "tied_softmax" else JHead("softmax", (24,), TP_V),
    )


def _stacked(batches: list) -> list:
    return [
        {"features": {k: np.stack([a["features"][k], c["features"][k]]) for k in a["features"]},
         "head_positions": np.stack([a["head_positions"], c["head_positions"]]),
         "labels": np.stack([a["labels"], c["labels"]])}
        for a, c in zip(batches[::2], batches[1::2])
    ]


def _one_process(cfg, state: dict, host: list, num_valid=None, negatives=None, ev=None):
    """The port's one-process step on the full global batches: (losses,
    params, eval sums); dense logits unless ``negatives`` (sampled)."""
    model = ClickstreamModel(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    tx = tts.make_optimizer(TrainConfig())
    step = tts.make_train_step(model, tx, schedules.constant(LR), fused_ce_num_valid=num_valid,
                               sampled_softmax_samples=S if negatives is not None else None)
    st = tts.TrainState.create(dict(model.named_parameters()), tx)
    losses = []
    for i, b in enumerate(host):
        extra = () if negatives is None else (torch.from_numpy(np.asarray(negatives[i])),)
        st, loss = step(st, to_device(b, "cpu"), None, *extra)
        losses.append(loss.item())
    stats = None if ev is None else tts.make_eval_step(model)(st.params, to_device(ev, "cpu"))
    return losses, {k: p.detach().numpy() for k, p in st.params.items()}, stats


# -- jobs --------------------------------------------------------------------


def _tp_job(head: str, mesh: tuple):
    jcfg = _tp_jcfg(head)
    host = [next(TP_DS.train_batches(B, seed=s)) for s in range(STEPS)]
    params = _seeded(JModel(jcfg), _jax_batch(host[0]))
    cfg, state = _port_state(jcfg, params)
    ev = next(TP_DS.eval_batches(B))
    job = dict(kind="tier", tier="tp", config=cfg.to_json(), state=state, mesh=mesh, device="cpu",
               batches=[_np_batch(b) for b in host], eval_batches=[_np_batch(ev)], num_valid=TP_V, lr=LR,
               fused=False)
    return job, jcfg, params, host, ev


TP_SPMD_VARIANTS = {
    "post": dict(head=JHead("tied_softmax", output_size=V, tied_bias=True)),
    "pre": dict(norm_style="pre"),
    "bf16": dict(dtype="bfloat16"),
    "steps_per_call": dict(head=JHead("tied_softmax", output_size=V, tied_bias=True)),
}


def _tp_spmd_job(name: str, mesh: tuple = (2, 2)):
    jcfg = _jcfg(2, num_layers=2, **TP_SPMD_VARIANTS[name])
    spc = 2 if name == "steps_per_call" else 1
    host = _host(4 if spc > 1 else STEPS)
    # seed 2: seed 1's weights put a pre-activation of layer 1's FFN at
    # 1e-6 from the ReLU's kink after one step, where f32 rounding (a sum
    # in another order on the TP ranks) decides its side and moves one
    # gradient element by a whole row's share
    params = _seeded(JModel(jcfg), _jax_batch(host[0]), seed=2)
    cfg, state = _port_state(jcfg, params)
    batches = [_np_batch(b) for b in host]
    ev = next(DS.eval_batches(B))
    job = dict(kind="tier", tier="tp_spmd", config=cfg.to_json(), state=state, mesh=mesh, device="cpu",
               batches=_stacked(batches) if spc > 1 else batches, eval_batches=[_np_batch(ev)], num_valid=V,
               lr=LR, steps_per_call=spc)
    return job, jcfg, params, host, ev


SAMPLED_VARIANTS = {
    "tied_softmax": dict(head=JHead("tied_softmax", output_size=V, tied_bias=True)),
    "softmax": dict(head=JHead("softmax", (24,), V)),
}


def _jax_negatives(steps: int) -> list:
    """The JAX step's negatives at step t: fold_in(fold_in(key, t), 1)."""
    return [np.asarray(jax.random.randint(jax.random.fold_in(jax.random.fold_in(KEY, t), 1), (S,), 0, V))
            for t in range(steps)]


def _sampled_job(name: str, given: bool = True):
    jcfg = _jcfg(2, num_layers=2, **SAMPLED_VARIANTS[name])
    host = _host(STEPS)
    params = _seeded(JModel(jcfg), _jax_batch(host[0]))
    cfg, state = _port_state(jcfg, params)
    job = dict(kind="tier", tier="sampled_spmd", config=cfg.to_json(), state=state, mesh=(2, 2), device="cpu",
               batches=[_np_batch(b) for b in host], num_valid=V, lr=LR, num_samples=S,
               **(dict(negatives=_jax_negatives(STEPS)) if given else dict(negatives_seed=3)))
    return job, jcfg, params, host


DROPOUT_IMPLS = ("mask", "fused")


def _dropout_job(tier: str, impl: str) -> dict:
    job = _tp_job("tied_softmax", (2, 2))[0] if tier == "tp" else _tp_spmd_job("post")[0]
    cfg = ModelConfig.from_json(job["config"])
    return {**job, "config": dataclasses.replace(cfg, dropout_rate=0.1).to_json(), "dropout_seed": 5,
            "dropout_impl": impl, "eval_batches": [], "batches": job["batches"][:2], "probe_activations": True}


def _collectives_job(mesh: tuple) -> dict:
    rng = np.random.default_rng(mesh[1])
    n = mesh[0] * mesh[1]
    return dict(kind="collectives", mesh=mesh, x=rng.normal(size=(n, 3, 5)).astype(np.float32),
                g=rng.normal(size=(n, 3, 5)).astype(np.float32))


WORLD2 = {
    "collectives": lambda: _collectives_job((1, 2)),
    "tp tied_softmax (1, 2)": lambda: _tp_job("tied_softmax", (1, 2))[0],
    "tp softmax (1, 2)": lambda: _tp_job("softmax", (1, 2))[0],
    "tp_spmd post (1, 2)": lambda: _tp_spmd_job("post", (1, 2))[0],
}
WORLD4 = {
    "collectives": lambda: _collectives_job((1, 4)),
    "tp tied_softmax (2, 2)": lambda: _tp_job("tied_softmax", (2, 2))[0],
    "tp softmax (2, 2)": lambda: _tp_job("softmax", (2, 2))[0],
    **{f"tp_spmd {name} (2, 2)": (lambda name=name: _tp_spmd_job(name)[0]) for name in TP_SPMD_VARIANTS},
    **{f"sampled {name}": (lambda name=name: _sampled_job(name)[0]) for name in SAMPLED_VARIANTS},
    "sampled drawn": lambda: _sampled_job("tied_softmax", given=False)[0],
    **{f"dropout {tier} {impl}": (lambda tier=tier, impl=impl: _dropout_job(tier, impl))
       for tier in ("tp", "tp_spmd") for impl in DROPOUT_IMPLS},
}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    ranks = _world(tmp_path_factory, 2, [make() for make in WORLD2.values()])
    return {name: [r[i] for r in ranks] for i, name in enumerate(WORLD2)}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    ranks = _world(tmp_path_factory, 4, [make() for make in WORLD4.values()])
    return {name: [r[i] for r in ranks] for i, name in enumerate(WORLD4)}


def _results(world2, world4, name: str, mesh: tuple) -> list:
    return (world2 if mesh == (1, 2) else world4)[f"{name} {mesh}"]


# -- the f/g pair ---------------------------------------------------------------


@pytest.mark.parametrize("model", [2, 4])
def test_psum_pair_matches_closed_forms(model, world2, world4):
    """Over a model group of 2 and 4: f is the identity forward and the sum
    of the output gradients backward, g the sum forward and the identity
    backward; f32 and bf16 (summed in f32, rounded once), the input's dtype
    kept."""
    out = (world2 if model == 2 else world4)["collectives"]
    job = _collectives_job((1, model))
    total_x, total_g = job["x"].sum(axis=0), job["g"].sum(axis=0)
    for rank, r in enumerate(out):
        for dtype, rnd in ((torch.float32, lambda a: a), (torch.bfloat16, lambda a: torch.from_numpy(a).bfloat16()
                                                          .float().numpy())):
            y, dx, kept = r[f"f {dtype}"]
            assert kept
            np.testing.assert_array_equal(y, rnd(job["x"][rank]))
            want = rnd(np.stack([rnd(g) for g in job["g"]]).sum(axis=0)) if dtype == torch.bfloat16 else total_g
            np.testing.assert_allclose(dx, want, rtol=1e-6, atol=1e-6)
            y, dx, kept = r[f"g {dtype}"]
            assert kept
            want = rnd(np.stack([rnd(x) for x in job["x"]]).sum(axis=0)) if dtype == torch.bfloat16 else total_x
            np.testing.assert_allclose(y, want, rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(dx, rnd(job["g"][rank]))


# -- the tensor-parallel tier against JAX's tp and one process ------------------


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
@pytest.mark.parametrize("head", ["tied_softmax", "softmax"])
def test_tp_train_and_eval_match_jax_and_one_process(head, mesh, world2, world4):
    """3 steps of make_tp_train_step (dense loss): losses 1e-5 and the
    parameters gathered back 1e-4 against JAX's tp.make_tp_train_step on
    the same mesh and against the port's one-process step on the global
    batches; every rank's copy of the replicated parameters equal; the
    eval sums of make_tp_eval_step against JAX's (1e-5) and the
    one-process eval."""
    job, jcfg, params, host, ev = _tp_job(head, mesh)
    cfg = ModelConfig.from_json(job["config"])
    jmesh = _jmesh(*mesh)
    jmodel = JModel(jcfg)
    jtx = jts.make_optimizer(JTrainConfig())
    jstate = jtp.shard_tp_state(jts.TrainState.create({"params": params}, jtx), jmesh, jcfg)
    jstep = jtp.make_tp_train_step(jmodel, jtx, jsched.constant(LR), jmesh, donate=False)
    jl = []
    for b in host:
        jstate, loss = jstep(jstate, jtp.shard_tp_batch(_jax_batch(b), jmesh, jcfg), KEY)
        jl.append(float(loss))
    jev = jtp.make_tp_eval_step(jmodel, jmesh)(jstate.params, jtp.shard_tp_batch(_jax_batch(ev), jmesh, jcfg))
    one, one_params, one_eval = _one_process(cfg, job["state"], host, ev=ev)
    out = _results(world2, world4, f"tp {head}", mesh)
    for r in out:
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5)
        np.testing.assert_allclose(r["losses"], one, rtol=1e-5)
        for stats in (jev, one_eval):
            for k, w in stats.items():
                np.testing.assert_allclose(r["evals"][0][k], float(w), rtol=1e-5, atol=1e-6, err_msg=k)
        for k, t in out[0]["params"].items():
            np.testing.assert_array_equal(r["params"][k], t, err_msg=k)
    _params_close(cfg, out[0]["params"], jstate.params["params"], STEPS, f"tp {head}")
    for k, p in one_params.items():
        atol = 2 * LR * STEPS if _is_key_bias(k) else 1e-4
        np.testing.assert_allclose(out[0]["params"][k], p, rtol=0, atol=atol, err_msg=k)
    assert sum(out[0]["train_launches"].values()) == 0  # the CPU takes the plain versions


# -- the composed tier against JAX's tp_spmd ----------------------------------


@pytest.mark.parametrize("name,mesh", [("post", (1, 2))] + [(n, (2, 2)) for n in TP_SPMD_VARIANTS])
def test_tp_spmd_matches_jax(name, mesh, world2, world4):
    """make_tp_spmd_train_step against JAX's tp_spmd.make_tp_spmd_train_step:
    3 steps post-LN (with tied_bias) and pre-LN, losses 1e-5 and parameters
    1e-4, and the eval sums of make_tp_spmd_eval_step against JAX's (1e-5);
    bf16, the losses within 2e-2; steps_per_call = 2 (two calls of a
    stacked batch) against JAX's four sequential steps."""
    job, jcfg, params, host, ev = _tp_spmd_job(name, mesh)
    cfg = ModelConfig.from_json(job["config"])
    jmesh = _jmesh(*mesh)
    jtx = jts.make_optimizer(JTrainConfig())
    jstate = jtp_spmd.shard_state(jts.TrainState.create(params, jtx), jmesh, jcfg)
    jstep = jtp_spmd.make_tp_spmd_train_step(jcfg, jmesh, jtx, jsched.constant(LR), V)
    jl = []
    for b in host:
        jstate, loss = jstep(jstate, jspmd.shard_batch(_jax_batch(b), jmesh, jcfg), KEY)
        jl.append(float(loss))
    out = _results(world2, world4, f"tp_spmd {name}", mesh)
    bf16 = name == "bf16"
    for r in out:
        np.testing.assert_allclose(r["losses"], jl, rtol=2e-2 if bf16 else 1e-5)
    if bf16:
        return
    _params_close(cfg, out[0]["params"], jstate.params, len(host), name)
    jev = jtp_spmd.make_tp_spmd_eval_step(jcfg, jmesh, V)(jstate.params, jspmd.shard_batch(
        _jax_batch(ev), jmesh, jcfg))
    for r in out:
        for k, w in jev.items():
            np.testing.assert_allclose(r["evals"][0][k], float(w), rtol=1e-5, atol=1e-6, err_msg=k)


# -- sampled softmax over the row-sharded table ---------------------------------


@pytest.mark.parametrize("name", list(SAMPLED_VARIANTS))
def test_sampled_spmd_matches_jax(name, world4):
    """3 steps of make_sampled_spmd_train_step at (2, 2), given the JAX
    step's negatives, against JAX's make_sampled_spmd_train_step: losses
    and parameters within 2e-4 (the key bias within its steps)."""
    job, jcfg, params, host = _sampled_job(name)
    cfg = ModelConfig.from_json(job["config"])
    jmesh = _jmesh(2, 2)
    jtx = jts.make_optimizer(JTrainConfig())
    jstate = jspmd.shard_state(jts.TrainState.create({"params": params}, jtx), jmesh, jcfg)
    jstep = jspmd.make_sampled_spmd_train_step(JModel(jcfg), jmesh, jtx, jsched.constant(LR), V, S, donate=False)
    jl = []
    for b in host:
        jstate, loss = jstep(jstate, jspmd.shard_batch(_jax_batch(b), jmesh, jcfg), KEY)
        jl.append(float(loss))
    out = world4[f"sampled {name}"]
    for r in out:
        np.testing.assert_allclose(r["losses"], jl, rtol=2e-4)
    want = {k: v.numpy() for k, v in state_dict_from_flax(cfg, jax.device_get(jstate.params["params"])).items()}
    for k, w in want.items():
        atol = 2 * LR * STEPS if _is_key_bias(k) else 2e-4
        np.testing.assert_allclose(out[0]["params"][k], w, rtol=0, atol=atol, err_msg=k)


def test_sampled_spmd_draws_one_set_of_negatives_for_the_world(world4):
    """Drawing its own negatives, every rank of a (2, 2) world takes the
    same set each step (a generator seeded from neither mesh index), and
    the losses are the one-process sampled step's on those negatives."""
    job, _, _, host = _sampled_job("tied_softmax", given=False)
    out = world4["sampled drawn"]
    for r in out[1:]:
        for a, c in zip(r["negatives"], out[0]["negatives"]):
            np.testing.assert_array_equal(a, c)
    assert not np.array_equal(out[0]["negatives"][0], out[0]["negatives"][1])
    one, _, _ = _one_process(ModelConfig.from_json(job["config"]), job["state"], host, num_valid=V,
                             negatives=out[0]["negatives"])
    for r in out:
        np.testing.assert_allclose(r["losses"], one, rtol=1e-5)


# -- dropout keeps the model ranks equal ----------------------------------------


@pytest.mark.parametrize("impl", DROPOUT_IMPLS)
@pytest.mark.parametrize("tier", ["tp", "tp_spmd"])
def test_tp_dropout_keeps_model_ranks_bit_equal(tier, impl, world4):
    """Dropout 0.1 (each back end's plain version), 2 steps at (2, 2): the
    generator is seeded from (seed, data index) only and dropout acts only
    on replicated tensors, so the model ranks of a data group draw the same
    masks: the encoder's output under dropout is bit-equal on them, and so
    is every parameter gathered back; the data groups' outputs differ."""
    out = {tuple(r["coords"]): r for r in world4[f"dropout {tier} {impl}"]}
    for d in range(2):
        np.testing.assert_array_equal(out[(d, 0)]["activations"], out[(d, 1)]["activations"])
    assert not np.array_equal(out[(0, 0)]["activations"], out[(1, 0)]["activations"])
    for k, t in out[(0, 0)]["params"].items():
        for coords in ((0, 1), (1, 0), (1, 1)):
            np.testing.assert_array_equal(out[coords]["params"][k], t, err_msg=f"{k} {coords}")
    assert np.all(np.isfinite(out[(0, 0)]["losses"]))


# -- refusals -------------------------------------------------------------------


def _mesh(model: int) -> Mesh:
    """A mesh description for the checks that run before any collective."""
    return Mesh(MeshConfig(data=1, model=model), 0, 0, 0, None, None, torch.device("cpu"))


def _model(**kw) -> ClickstreamModel:
    return ClickstreamModel(ModelConfig.from_json(dataclasses.replace(_jcfg(2, num_layers=2), **kw).to_json()),
                            device="cpu")


@pytest.mark.parametrize("case", ["heads", "ffn", "qkv_fused tp", "qkv_fused tp_spmd", "sampled tp",
                                  "binary sampled_spmd", "unsharded tp", "tp encoder on spmd"])
def test_tiers_refuse_what_they_cannot_run(case):
    """Heads or the FFN not divisible by the model group, qkv_fused on the
    TP tiers, sampled softmax on tp, a binary head on sampled_spmd; and a
    TP step built before its state was sharded, or an SPMD step on a model
    that carries the TP encoder."""
    tx, sched, mesh = tts.make_optimizer(TrainConfig()), schedules.constant(LR), _mesh(2)
    build = {
        "heads": (lambda: tp.make_tp_train_step(_model(num_heads=3, features={"items": JFeature(2048, 18)}), tx,
                                                sched, mesh), "num_heads"),
        "ffn": (lambda: tp_spmd.make_tp_spmd_train_step(_model(ffn_dim=33), mesh, tx, sched, V), "ffn_dim"),
        "qkv_fused tp": (lambda: tp.make_tp_train_step(_model(qkv_fused=True), tx, sched, mesh), "qkv_fused"),
        "qkv_fused tp_spmd": (lambda: tp_spmd.shard_state(None, _model(qkv_fused=True), mesh), "qkv_fused"),
        "sampled tp": (lambda: support.validate_tier("tp", "tied_softmax", sampled=S), "'sampled'"),
        "binary sampled_spmd": (lambda: spmd.make_sampled_spmd_train_step(
            _model(head=JHead("binary", (8,))), mesh, tx, sched, V, S), "head:binary"),
        "unsharded tp": (lambda: tp.make_tp_train_step(_model(), tx, sched, mesh), "shard the state"),
    }
    if case == "tp encoder on spmd":
        model = _model()
        tp.install_tp_encoder(model, mesh)
        build[case] = (lambda: spmd.make_spmd_train_step(model, mesh, tx, sched, V), "tensor-parallel")
    fn, message = build[case]
    with pytest.raises(ValueError, match=message):
        fn()


# -- sampled_softmax_ce keeps its single-device numbers ---------------------------


def _sampled_before_take(x, table, labels, row_offset, num_valid, negatives, bias=None):
    """``ops/losses.py:sampled_softmax_ce`` as it was before it took
    ``take``, line for line."""
    s = negatives.shape[0]
    neg_lab = negatives.long()
    lab_safe = labels.long().clamp(min=0)
    xf = x.float()
    w_pos = table[lab_safe + row_offset].to(x.dtype).float()
    w_neg = table[neg_lab + row_offset].to(x.dtype).float()
    pos = (xf * w_pos).sum(dim=-1)
    neg = xf @ w_neg.T
    if bias is not None:
        b = bias.float()
        pos = pos + b[lab_safe + row_offset]
        neg = neg + b[neg_lab + row_offset]
    correction = float(np.log(np.float32(num_valid) / np.float32(s)))
    neg = neg + correction
    hit = neg_lab[None, :] == lab_safe[:, None]
    neg = torch.where(hit, torch.full_like(neg, -1e30), neg)
    m = torch.maximum(pos, neg.max(dim=-1).values)
    logz = m + torch.log(torch.exp(pos - m) + torch.exp(neg - m[:, None]).sum(dim=-1))
    mask = (labels != LABEL_PAD).float()
    return (logz - pos) * mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [False, True])
def test_sampled_softmax_default_take_is_bit_equal(with_bias, dtype):
    """With the default row take, sampled_softmax_ce and its gradients are
    bit-equal to the function before the argument existed, and to an
    explicit ``table[ids]`` take."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(24, 8)).astype(np.float32)).to(dtype)
    table = torch.from_numpy(rng.normal(scale=0.5, size=(64, 8)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(scale=0.3, size=(64,)).astype(np.float32)) if with_bias else None
    labels = torch.from_numpy(rng.integers(0, 50, size=(24,)).astype(np.int64))
    labels[::5] = LABEL_PAD
    neg = tlosses.sample_negatives(50, S, torch.Generator().manual_seed(1))
    w = torch.from_numpy(rng.normal(size=(24,)).astype(np.float32))
    results = []
    for fn in (_sampled_before_take, tlosses.sampled_softmax_ce,
               lambda *a, **k: tlosses.sampled_softmax_ce(*a, **k, take=lambda idx: tt[idx])):
        tx = x.clone().requires_grad_(True)
        tt = table.clone().requires_grad_(True)
        nll = fn(tx, tt, labels, 3, 50, neg, bias=bias)
        (nll * w).sum().backward()
        results.append((nll.detach(), tx.grad, tt.grad))
    for got in results[1:]:
        for a, c in zip(got, results[0]):
            assert torch.equal(a, c)
