"""Run a parallel tier for a few steps inside a world and hand back numpy.

:func:`run_jobs` is a worker for ``parallel/mesh.py:spawn`` (a list of jobs
in one world; :func:`run_job` runs one): every rank
builds the same model from a full state, shards or replicates it for its
tier (``dp`` or ``spmd``), takes its rows of each global batch, trains and
evaluates, and returns the losses, the eval sums, the full state gathered
back (``spmd.gather_state``: parameters, Adam's first moment, the EMA), the
kernel launches and its step times. The
caller compares them with a one-process run. Everything crosses the process
boundary as numpy, so the caller needs no distributed state.

The job is a dict:

* ``config``: ``ModelConfig.to_json()``; ``state``: {name: array}, keyed
  like ``named_parameters()`` (the table already padded for ``spmd``);
* ``mesh``: (data, model); ``tier``: "dp" or "spmd"; ``device``: "cpu" or
  "cuda" (required; every rank on ``cuda:0``);
* ``batches``: global train batches, dicts of arrays (``features``,
  ``head_positions``, ``labels``), stacked (K, B, ...) when
  ``steps_per_call`` > 1; ``eval_batches``: global eval batches;
* ``num_valid`` (the label vocabulary), ``lr``, ``ema_decay``,
  ``steps_per_call``, ``dropout_impl``, ``dropout_seed`` (None: no
  dropout), ``fused`` (DP: the fused CE). Adam's moments are f32.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bert4clickpath_torch.config import MeshConfig, ModelConfig, TrainConfig
from bert4clickpath_torch.models.model import ClickstreamModel
from bert4clickpath_torch.ops.kernels import _build
from bert4clickpath_torch.parallel import spmd
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
    own = dict(model.named_parameters())
    with torch.no_grad():
        for k, p in own.items():
            if tuple(p.shape) == tuple(full[k].shape):
                p.copy_(full[k])
    tx = make_optimizer(TrainConfig())
    ema = job.get("ema_decay", 0.0) > 0
    spc = job.get("steps_per_call", 1)
    schedule = schedules.constant(job.get("lr", 1e-3))
    tier = job["tier"]
    if tier == "spmd":
        # the full state, with the full table, then this rank's shard
        state = TrainState.create({k: full[k].to(device) for k in own}, tx, ema=ema)
        state = spmd.shard_state(state, model, mesh)
        step = spmd.make_spmd_train_step(
            model, mesh, tx, schedule, job["num_valid"], ema_decay=job.get("ema_decay", 0.0), steps_per_call=spc,
        )
        evaluate = spmd.make_spmd_eval_step(model, mesh, job["num_valid"])
    else:
        state = spmd.replicate_state(TrainState.create(own, tx, ema=ema), mesh)
        step = spmd.make_dp_train_step(
            model, mesh, tx, schedule, ema_decay=job.get("ema_decay", 0.0),
            fused_ce_num_valid=job["num_valid"] if job.get("fused", True) else None, steps_per_call=spc,
        )
        evaluate = spmd.make_dp_eval_step(
            model, mesh, chunked_num_valid=job["num_valid"] if job.get("fused", True) else None
        )
    seed = job.get("dropout_seed")
    generator = None if seed is None else spmd.tier_generator(mesh, seed)
    shard = spmd.shard_stacked_batch if spc > 1 else spmd.shard_batch
    batches = [shard(_tensors(b, device), mesh) for b in job["batches"]]
    _sync(device)
    _build.reset_launch_counts()
    losses, times = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, loss = step(state, b, generator)
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
    whole = spmd.gather_state(state, mesh, cfg) if tier == "spmd" else state
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
    }


def run_jobs(rank: int, world: int, jobs: list) -> list:
    """Each job of the list in turn, in one world."""
    return [run_job(rank, world, job) for job in jobs]
