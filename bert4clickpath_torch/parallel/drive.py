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
  ``negatives`` (one array a step); ``probe_activations``. Adam's moments
  are f32.
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


def _build_tier(tier: str, model, mesh, full: dict, job: dict):
    """(state, train step, eval step, gather specs or None) of a tier."""
    tx = make_optimizer(TrainConfig())
    ema_decay = job.get("ema_decay", 0.0)
    spc = job.get("steps_per_call", 1)
    schedule = schedules.constant(job.get("lr", 1e-3))
    nv = job["num_valid"]
    own = dict(model.named_parameters())
    with torch.no_grad():
        for k, p in own.items():
            p.copy_(full[k])
    # the full state: a sharding tier cuts it for this rank
    state = TrainState.create(own, tx, ema=ema_decay > 0)
    if tier == "spmd":
        state = spmd.shard_state(state, model, mesh)
        step = spmd.make_spmd_train_step(model, mesh, tx, schedule, nv, ema_decay=ema_decay, steps_per_call=spc)
        return state, step, spmd.make_spmd_eval_step(model, mesh, nv), spmd.param_specs(state.params, model.config)
    if tier == "tp_spmd":
        state = tp_spmd.shard_state(state, model, mesh)
        step = tp_spmd.make_tp_spmd_train_step(model, mesh, tx, schedule, nv, ema_decay=ema_decay, steps_per_call=spc)
        return (state, step, tp_spmd.make_tp_spmd_eval_step(model, mesh, nv),
                tp_spmd.param_specs(state.params, model.config))
    chunked = nv if job.get("fused", True) else None
    if tier == "tp":
        state = tp.shard_tp_state(state, model, mesh)
        step = tp.make_tp_train_step(model, tx, schedule, mesh, ema_decay=ema_decay)
        return (state, step, tp.make_tp_eval_step(model, mesh, chunked_num_valid=chunked),
                tp.tp_param_specs(state.params, model.config))
    if tier == "sampled_spmd":
        state = spmd.shard_state(state, model, mesh)
        step = spmd.make_sampled_spmd_train_step(
            model, mesh, tx, schedule, nv, job["num_samples"], ema_decay=ema_decay,
            negatives_from=spmd.negatives_generator(mesh.device, job.get("negatives_seed", 0)),
        )
        return state, step, None, spmd.param_specs(state.params, model.config)
    if tier != "dp":
        raise ValueError(f"unknown tier {tier!r}")
    state = spmd.replicate_state(state, mesh)
    step = spmd.make_dp_train_step(model, mesh, tx, schedule, ema_decay=ema_decay, fused_ce_num_valid=chunked,
                                   steps_per_call=spc)
    return state, step, spmd.make_dp_eval_step(model, mesh, chunked_num_valid=chunked), None


def run_job(rank: int, world: int, job: dict) -> dict:
    data, model_shards = job["mesh"]
    device = torch.device(job["device"])
    if device.type == "cuda":
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    mesh = make_mesh(MeshConfig(data=data, model=model_shards), device)
    cfg = ModelConfig.from_json(job["config"])
    model = ClickstreamModel(cfg, device=device, dropout_impl=job.get("dropout_impl", "mask"))
    full = {k: torch.from_numpy(np.asarray(v)) for k, v in job["state"].items()}
    tier = job["tier"]
    state, step, evaluate, specs = _build_tier(tier, model, mesh, full, job)
    seed = job.get("dropout_seed")
    generator = None if seed is None else spmd.tier_generator(mesh, seed)
    shard = spmd.shard_stacked_batch if job.get("steps_per_call", 1) > 1 else spmd.shard_batch
    batches = [shard(_tensors(b, device), mesh) for b in job["batches"]]
    # the negatives each step takes: given (the JAX package's), or drawn by
    # the step; a twin of its generator records the ones it draws
    given = job.get("negatives")
    twin = spmd.negatives_generator(device, job.get("negatives_seed", 0)) if tier == "sampled_spmd" else None
    negatives = []
    _sync(device)
    _build.reset_launch_counts()
    losses, times = [], []
    for i, b in enumerate(batches):
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
        "negatives": negatives,
        "activations": activations,
    }


def run_jobs(rank: int, world: int, jobs: list) -> list:
    """Each job of the list in turn, in one world."""
    return [run_job(rank, world, job) for job in jobs]
