"""The large-catalog path (``examples/large_catalog/stress_torch.py``,
BASELINE configs[4]) against the JAX package's, on the CPU.

The stress model (``stress_torch.stress_config``: 2 layers, 4 heads, FFN
4 d, tied softmax, the table padded by ``padded_vocab_rows``) at items
5,000, d 16, batch 16, dropout 0, f32, on the stress script's synthetic
batches. The port's state is built in place
(``spmd.init_sharded_state`` from the same numpy weights as the JAX
state: only a rank's table rows reach it) in spawned gloo worlds
(``tests/torch_parallel_workers.py``, ``parallel/drive.py``); the JAX
side runs ``make_spmd_train_step`` / ``make_sampled_spmd_train_step`` on
the 8-device CPU mesh of ``tests/conftest.py``.

Tolerances: losses 1e-5 relative and the gathered parameters 1e-4
absolute (``test_torch_parallel.py:test_spmd_train_step_matches_jax``'s),
the key bias within its steps' size (2 * lr * steps: its gradient is zero
in exact arithmetic); the sampled tier 2e-4 for both
(``test_torch_tp.py:test_sampled_spmd_matches_jax``'s).
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

from bert4clickpath_tpu.config import ModelConfig as JModelConfig
from bert4clickpath_tpu.config import TrainConfig as JTrainConfig
from bert4clickpath_tpu.models.model import ClickstreamModel as JModel
from bert4clickpath_tpu.parallel import spmd as jspmd
from bert4clickpath_tpu.training import schedules as jsched
from bert4clickpath_tpu.training import train_state as jts
from bert4clickpath_torch.config import MeshConfig, TrainConfig
from bert4clickpath_torch.convert import state_dict_from_flax
from bert4clickpath_torch.data.synthetic import seeded_state_dict, synthetic_batch
from bert4clickpath_torch.parallel import spmd
from bert4clickpath_torch.parallel.mesh import Mesh
from bert4clickpath_torch.training.train_state import make_optimizer

from test_torch_parallel import _is_key_bias, _jmesh, _seeded, _world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples", "large_catalog"))
import stress_torch  # noqa: E402

torch.set_num_threads(1)

ITEMS, D, BATCH, MAX_ITEMS = 5_000, 16, 16, 50
STEPS, LR, S = 3, 1e-3, 64
KEY = jax.random.PRNGKey(1)


def _config(model_shards: int):
    cfg = stress_torch.stress_config(ITEMS, D, MAX_ITEMS, model_shards, "float32")
    return dataclasses.replace(cfg, dropout_rate=0.0)


def _batches() -> list:
    rng = np.random.default_rng(0)
    return [synthetic_batch(rng, BATCH, MAX_ITEMS, stress_torch.MAX_MASKED, ITEMS) for _ in range(STEPS)]


def _jax_batch(b: dict) -> dict:
    return {"features": {k: jnp.asarray(v) for k, v in b["features"].items()},
            "head_positions": jnp.asarray(b["head_positions"]), "labels": jnp.asarray(b["labels"])}


def _setup(model_shards: int):
    """(port config, JAX config, flax params, port weights, batches)."""
    cfg = _config(model_shards)
    jcfg = JModelConfig.from_json(cfg.to_json())
    host = _batches()
    params = _seeded(JModel(jcfg), _jax_batch(host[0]))
    weights = {k: v.numpy() for k, v in state_dict_from_flax(cfg, params).items()}
    return cfg, jcfg, params, weights, host


def _jax_negatives() -> list:
    """The JAX sampled step's negatives at step t: fold_in(fold_in(key, t), 1)."""
    return [np.asarray(jax.random.randint(jax.random.fold_in(jax.random.fold_in(KEY, t), 1), (S,), 0, ITEMS))
            for t in range(STEPS)]


def _job(tier: str, mesh: tuple) -> dict:
    cfg, _, _, weights, host = _setup(mesh[1])
    job = dict(kind="tier", tier=tier, in_place=True, config=cfg.to_json(), state=weights, mesh=mesh,
               device="cpu", batches=host, eval_batches=[], num_valid=ITEMS, lr=LR)
    if tier == "sampled_spmd":
        job.update(num_samples=S, negatives=_jax_negatives())
    return job


WORLDS = {2: {"spmd (1, 2)": ("spmd", (1, 2))},
          4: {"spmd (2, 2)": ("spmd", (2, 2)), "sampled (2, 2)": ("sampled_spmd", (2, 2))}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for world, jobs in WORLDS.items():
        ranks = _world(tmp_path_factory, world, [_job(*spec) for spec in jobs.values()])
        out.update({name: [r[i] for r in ranks] for i, name in enumerate(jobs)})
    return out


def _hold(cfg, got: dict, want_flax, atol: float, what: str) -> None:
    want = {k: v.numpy() for k, v in state_dict_from_flax(cfg, jax.device_get(want_flax)).items()}
    assert set(got) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=2 * LR * STEPS if _is_key_bias(k) else atol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_stress_step_matches_jax(mesh, runs):
    """STEPS stress steps from the in-place state against JAX's
    make_spmd_train_step from the same weights and batches: every rank's
    losses within 1e-5, the gathered parameters within 1e-4."""
    cfg, jcfg, params, _, host = _setup(mesh[1])
    jmesh = _jmesh(*mesh)
    jtx = jts.make_optimizer(JTrainConfig())
    jstate = jspmd.shard_state(jts.TrainState.create(params, jtx), jmesh, jcfg)
    jstep = jspmd.make_spmd_train_step(jcfg, jmesh, jtx, jsched.constant(LR), ITEMS)
    jl = []
    for b in host:
        jstate, loss = jstep(jstate, jspmd.shard_batch(_jax_batch(b), jmesh, jcfg), KEY)
        jl.append(float(loss))
    out = runs[f"spmd {mesh}"]
    for r in out:
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5)
    _hold(cfg, out[0]["params"], jstate.params, 1e-4, f"spmd {mesh}")


def test_sampled_stress_step_matches_jax(runs):
    """``--sampled``: STEPS steps of make_sampled_spmd_train_step at (2, 2)
    from the in-place state, on the JAX step's negatives, against JAX's
    make_sampled_spmd_train_step: losses and parameters within 2e-4."""
    cfg, jcfg, params, _, host = _setup(2)
    jmesh = _jmesh(2, 2)
    jtx = jts.make_optimizer(JTrainConfig())
    jstate = jspmd.shard_state(jts.TrainState.create({"params": params}, jtx), jmesh, jcfg)
    jstep = jspmd.make_sampled_spmd_train_step(JModel(jcfg), jmesh, jtx, jsched.constant(LR), ITEMS, S, donate=False)
    jl = []
    for b in host:
        jstate, loss = jstep(jstate, jspmd.shard_batch(_jax_batch(b), jmesh, jcfg), KEY)
        jl.append(float(loss))
    out = runs["sampled (2, 2)"]
    for r in out:
        np.testing.assert_allclose(r["losses"], jl, rtol=2e-4)
    _hold(cfg, out[0]["params"], jstate.params["params"], 2e-4, "sampled (2, 2)")


def _mesh(model_shards: int, model_index: int, data_index: int = 0) -> Mesh:
    """A rank's place in a (2, model) mesh without a world: the in-place
    builder runs no collective."""
    return Mesh(MeshConfig(data=2, model=model_shards), data_index * model_shards + model_index, data_index,
                model_index, None, None, torch.device("cpu"))


@pytest.mark.parametrize("model_shards", [1, 2, 4])
def test_in_place_state_holds_only_its_rows(model_shards):
    """init_sharded_state: the model's item table, Adam's moments and the
    EMA are (V_local, D), no parameter has more than V_local rows; with
    given weights the shards are the table's row slices and every other
    parameter the given one; drawn, a shard depends on (seed, model index)
    alone (the data ranks of one model index hold the same rows), the
    shards differ, each is N(0, 0.02^2)."""
    cfg = stress_torch.stress_config(ITEMS, D, MAX_ITEMS, model_shards, "float32")
    rows = cfg.features["items"].vocab_rows
    v_local = rows // model_shards
    name = spmd.table_name(cfg)
    weights = {k: v.numpy() for k, v in seeded_state_dict(cfg, 1).items()}
    tx = make_optimizer(TrainConfig())
    drawn = []
    for m in range(model_shards):
        model, state = spmd.init_sharded_state(cfg, _mesh(model_shards, m), tx, weights=weights, ema=True)
        assert model.config == cfg
        for k, p in model.named_parameters():
            assert p.shape[0] <= v_local, (k, tuple(p.shape))
        for tensors in (state.params, state.opt_state.mu, state.opt_state.nu, state.ema_params):
            assert tuple(tensors[name].shape) == (v_local, D)
        np.testing.assert_array_equal(state.params[name].detach().numpy(), weights[name][m * v_local : (m + 1) * v_local])
        for k, p in state.params.items():
            if k != name:
                np.testing.assert_array_equal(p.detach().numpy(), weights[k], err_msg=k)
        _, mine = spmd.init_sharded_state(cfg, _mesh(model_shards, m), tx, seed=3)
        _, other_data = spmd.init_sharded_state(cfg, _mesh(model_shards, m, data_index=1), tx, seed=3)
        torch.testing.assert_close(mine.params[name], other_data.params[name], rtol=0, atol=0)
        drawn.append(mine.params[name].detach())
    table = torch.cat(drawn)
    assert table.shape == (rows, D)
    assert abs(table.std().item() - 0.02) < 1e-3 and abs(table.mean().item()) < 1e-3
    if model_shards > 1:
        assert not torch.equal(drawn[0], drawn[1])


def test_stress_script_runs_on_the_cpu():
    """``stress_torch.py --device cpu`` at a small size, in a subprocess:
    the script's prints, a first loss near ln(V) and finite losses."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "large_catalog", "stress_torch.py"),
         "--device", "cpu", "--items", "5000", "--d_model", "16", "--steps", "2"],
        capture_output=True, text=True, timeout=240, env=dict(os.environ, PYTHONPATH=""),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    text = out.stdout
    for expected in ("mesh: data=1 model=1 on cpu", "table rows=5,120", "dense (B,P,V) logits would be",
                     "steady:", "kernel launches per step: {}", "peak device memory not measured (CPU)"):
        assert expected in text, (expected, text)
    first = float(text.split("first step loss=")[1].split()[0])
    assert abs(first - np.log(ITEMS)) < 0.1
