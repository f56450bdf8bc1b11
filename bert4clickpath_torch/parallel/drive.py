"""Run a parallel tier for a few steps inside a world and hand back numpy.

:func:`run_jobs` is a worker for ``parallel/mesh.py:spawn`` (a list of jobs
in one world; :func:`run_job` runs one): every rank builds the same model
from a full state, shards or replicates it for its tier, takes its rows of
each global batch, trains and evaluates, and returns the losses, the eval
sums, the full state gathered back (``spmd.gather_state`` with the tier's
specs: parameters, Adam's first moment, the EMA), the kernel launches, its
step times, the negatives of the sampled tier and, on request, the
encoder's output under dropout. The caller compares them with a
one-process run. Everything crosses the process boundary as numpy, so the
caller needs no distributed state.

The job is a dict:

* ``config``: ``ModelConfig.to_json()``; ``state``: {name: array}, keyed
  like ``named_parameters()`` (the table already padded for the tiers that
  shard it);
* ``mesh``: (data, model); ``tier``: "dp", "spmd", "tp", "tp_spmd" or
  "sampled_spmd"; ``device``: "cpu" or "cuda" (required; every rank on
  ``cuda:0``);
* ``batches``: global train batches, dicts of arrays (``features``,
  ``head_positions``, ``labels``), stacked (K, B, ...) when
  ``steps_per_call`` > 1; ``eval_batches``: global eval batches (none for
  ``sampled_spmd``, which has no eval step of its own);
* ``num_valid`` (the label vocabulary), ``lr``, ``ema_decay``,
  ``steps_per_call``, ``dropout_impl``, ``dropout_seed`` (None: no
  dropout), ``fused`` (DP: the fused CE; DP and TP: the chunked eval);
  ``num_samples`` and ``negatives_seed`` (the sampled tier's generator) or
  ``negatives`` (one array a step); ``probe_activations``; ``mu_dtype``
  ("bfloat16": Adam's first moment in bf16; default f32);
* ``in_place`` (spmd, sampled_spmd): the state built by
  ``spmd.init_sharded_state`` from ``state`` (only this rank's table rows
  reach the device) instead of cut from a full one;
* ``resume_after`` (a sharding tier): after that many steps the state is
  checkpointed under ``checkpoint_dir`` (``spmd.save_sharded_checkpoint``),
  restored onto a freshly built model (``spmd.restore_sharded_state`` with
  the tier's shard function) and the run goes on with steps built anew, as
  a resumed run would; ``restore_apart`` names the restored tensors that
  are not bit-equal to the saved ones (none: the route is exact).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bert4clickpath_torch.config import MeshConfig, ModelConfig, TrainConfig
from bert4clickpath_torch.models.model import ClickstreamModel
from bert4clickpath_torch.ops.kernels import _build
from bert4clickpath_torch.ops.losses import sample_negatives
from bert4clickpath_torch.parallel import spmd, tp, tp_spmd
from bert4clickpath_torch.parallel.mesh import make_mesh
from bert4clickpath_torch.training import schedules
from bert4clickpath_torch.training.train_state import TrainState, eval_params, make_optimizer


def _tensors(batch: dict, device) -> dict:
    put = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return {
        "features": {k: put(v) for k, v in batch["features"].items()},
        "head_positions": put(batch.get("head_positions")),
        "labels": put(batch["labels"]),
    }


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


_SHARD = {"spmd": spmd.shard_state, "sampled_spmd": spmd.shard_state, "tp_spmd": tp_spmd.shard_state,
          "tp": tp.shard_tp_state}


def _tx(job: dict):
    return make_optimizer(TrainConfig(), mu_dtype=torch.bfloat16 if job.get("mu_dtype") == "bfloat16" else None)


def _shard(tier: str, model, mesh, state):
    """This rank's state of the tier from a full single-device state."""
    if tier == "dp":
        return spmd.replicate_state(state, mesh)
    if tier not in _SHARD:
        raise ValueError(f"unknown tier {tier!r}")
    return _SHARD[tier](state, model, mesh)


def _steps(tier: str, model, mesh, state, job: dict):
    """(train step, eval step, gather specs or None) of a tier on a model
    whose state is cut for it."""
    tx = _tx(job)
    ema_decay = job.get("ema_decay", 0.0)
    spc = job.get("steps_per_call", 1)
    schedule = schedules.constant(job.get("lr", 1e-3))
    nv = job["num_valid"]
    if tier == "spmd":
        step = spmd.make_spmd_train_step(model, mesh, tx, schedule, nv, ema_decay=ema_decay, steps_per_call=spc)
        return step, spmd.make_spmd_eval_step(model, mesh, nv), spmd.param_specs(state.params, model.config)
    if tier == "tp_spmd":
        step = tp_spmd.make_tp_spmd_train_step(model, mesh, tx, schedule, nv, ema_decay=ema_decay, steps_per_call=spc)
        return step, tp_spmd.make_tp_spmd_eval_step(model, mesh, nv), tp_spmd.param_specs(state.params, model.config)
    chunked = nv if job.get("fused", True) else None
    if tier == "tp":
        step = tp.make_tp_train_step(model, tx, schedule, mesh, ema_decay=ema_decay)
        return (step, tp.make_tp_eval_step(model, mesh, chunked_num_valid=chunked),
                tp.tp_param_specs(state.params, model.config))
    if tier == "sampled_spmd":
        step = spmd.make_sampled_spmd_train_step(
            model, mesh, tx, schedule, nv, job["num_samples"], ema_decay=ema_decay,
            negatives_from=spmd.negatives_generator(mesh.device, job.get("negatives_seed", 0)),
        )
        return step, None, spmd.param_specs(state.params, model.config)
    step = spmd.make_dp_train_step(model, mesh, tx, schedule, ema_decay=ema_decay, fused_ce_num_valid=chunked,
                                   steps_per_call=spc)
    return step, spmd.make_dp_eval_step(model, mesh, chunked_num_valid=chunked), None


def _state_tensors(state) -> dict:
    """Every tensor and counter of a state, by name (the restore check)."""
    out = {"step": torch.tensor(state.step), "count": torch.tensor(state.opt_state.count),
           "lr_scale": state.lr_scale}
    for what, d in (("params", state.params), ("mu", state.opt_state.mu), ("nu", state.opt_state.nu),
                    ("ema", state.ema_params or {})):
        out.update({f"{what} {k}": t for k, t in d.items()})
    return out


def _resume(tier: str, model, mesh, state, specs, job: dict):
    """Checkpoint the sharded state, restore it onto a freshly built model
    and build the tier's steps on that model: (model, state, step, eval
    step, the names of the restored state's tensors that are not bit-equal
    to the saved state's: none when the route is exact)."""
    if tier not in _SHARD:
        raise ValueError(f"resume_after: tier {tier!r} has no sharded state")
    saved = {k: t.detach().clone() for k, t in _state_tensors(state).items()}
    path = spmd.save_sharded_checkpoint(job["checkpoint_dir"], state, mesh, model.config, specs)
    model = ClickstreamModel(model.config, device=mesh.device, dropout_impl=job.get("dropout_impl", "mask"))
    state = spmd.restore_sharded_state(path, model, mesh, _tx(job), _SHARD[tier],
                                       ema=job.get("ema_decay", 0.0) > 0)
    restored = _state_tensors(state)
    apart = sorted(k for k, t in saved.items() if k not in restored or not torch.equal(
        t, restored[k].detach().to(t.device)))
    step, evaluate, _ = _steps(tier, model, mesh, state, job)
    return model, state, step, evaluate, apart


def run_job(rank: int, world: int, job: dict) -> dict:
    data, model_shards = job["mesh"]
    device = torch.device(job["device"])
    if device.type == "cuda":
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    mesh = make_mesh(MeshConfig(data=data, model=model_shards), device)
    cfg = ModelConfig.from_json(job["config"])
    tier = job["tier"]
    ema = job.get("ema_decay", 0.0) > 0
    if job.get("in_place"):
        # the table shard built in place: no rank holds the whole table
        if tier not in ("spmd", "sampled_spmd"):
            raise ValueError(f"in_place: tier {tier!r} does not row-shard the table alone")
        model, state = spmd.init_sharded_state(cfg, mesh, _tx(job), weights=job["state"],
                                               dropout_impl=job.get("dropout_impl", "mask"), ema=ema)
    else:
        model = ClickstreamModel(cfg, device=device, dropout_impl=job.get("dropout_impl", "mask"))
        own = dict(model.named_parameters())
        with torch.no_grad():
            for k, p in own.items():
                p.copy_(torch.from_numpy(np.asarray(job["state"][k])))
        # the full state: a sharding tier cuts it for this rank
        state = _shard(tier, model, mesh, TrainState.create(own, _tx(job), ema=ema))
    step, evaluate, specs = _steps(tier, model, mesh, state, job)
    seed = job.get("dropout_seed")
    generator = None if seed is None else spmd.tier_generator(mesh, seed)
    shard = spmd.shard_stacked_batch if job.get("steps_per_call", 1) > 1 else spmd.shard_batch
    batches = [shard(_tensors(b, device), mesh) for b in job["batches"]]
    # the negatives each step takes: given (the JAX package's), or drawn by
    # the step; a twin of its generator records the ones it draws
    given = job.get("negatives")
    twin = spmd.negatives_generator(device, job.get("negatives_seed", 0)) if tier == "sampled_spmd" else None
    negatives = []
    restore_apart = None
    _sync(device)
    _build.reset_launch_counts()
    losses, times = [], []
    for i, b in enumerate(batches):
        if i and i == job.get("resume_after"):
            model, state, step, evaluate, restore_apart = _resume(tier, model, mesh, state, specs, job)
        extra = ()
        if given is not None:
            extra = (torch.from_numpy(np.asarray(given[i])).to(device),)
            negatives.append(np.asarray(given[i]))
        elif twin is not None:
            negatives.append(sample_negatives(job["num_valid"], job["num_samples"], twin).cpu().numpy())
        t0 = time.perf_counter()
        state, loss = step(state, b, generator, *extra)
        _sync(device)
        times.append(time.perf_counter() - t0)
        losses.append(loss.detach().float().cpu().numpy().reshape(-1))
    train_launches = _build.launch_counts()
    _build.reset_launch_counts()
    evals = []
    for b in job.get("eval_batches", []):
        stats = evaluate(eval_params(state), spmd.shard_batch(_tensors(b, device), mesh))
        evals.append({k: float(v) for k, v in stats.items()})
    eval_launches = _build.launch_counts()
    activations = None
    if job.get("probe_activations"):
        # the encoder's output on the first batch with dropout live: equal
        # on the model ranks of a data group, bit for bit
        lookup = None if specs is None or tier == "tp" else spmd.sharded_item_lookup(model, mesh, model.dtype)
        with torch.no_grad():
            activations = model.encode(batches[0]["features"], spmd.tier_generator(mesh, seed, 1), lookup).float()
        activations = activations.cpu().numpy()
    whole = state if specs is None else spmd.gather_state(state, mesh, cfg, specs)
    to_np = lambda d: None if d is None else {k: v.detach().float().cpu().numpy() for k, v in d.items()}  # noqa: E731
    return {
        "losses": np.concatenate(losses) if losses else np.zeros(0),
        "params": to_np(whole.params),
        "mu": to_np(whole.opt_state.mu),
        "ema": to_np(whole.ema_params),
        "evals": evals,
        "train_launches": train_launches,
        "eval_launches": eval_launches,
        "step_seconds": times,
        "coords": (mesh.data_index, mesh.model_index),
        "step": state.step,
        "count": state.opt_state.count,
        "restore_apart": restore_apart,
        "negatives": negatives,
        "activations": activations,
    }


def run_jobs(rank: int, world: int, jobs: list) -> list:
    """Each job of the list in turn, in one world."""
    return [run_job(rank, world, job) for job in jobs]
