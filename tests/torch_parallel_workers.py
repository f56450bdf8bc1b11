"""Worker targets of the port's parallel tests (``tests/test_torch_parallel.py``).

A spawned child imports the module that defines its target, so the targets
live here, in a module that imports the port and never JAX. Each world runs
a list of jobs (several checks per world) and returns numpy results; the
parent compares them with the JAX package and with dense references.
"""

from __future__ import annotations

import numpy as np
import torch

from bert4clickpath_torch.config import MeshConfig
from bert4clickpath_torch.parallel import drive
from bert4clickpath_torch.parallel import embedding as emb
from bert4clickpath_torch.parallel.mesh import make_mesh


def _local(a, lo, hi):
    return torch.from_numpy(np.ascontiguousarray(a[lo:hi]))


def _embedding_checks(job: dict) -> dict:
    """The row-sharded embedding ops on this rank's shard."""
    mesh = make_mesh(MeshConfig(data=1, model=job["model"]), "cpu")
    table = job["table"]
    v_local = table.shape[0] // job["model"]
    lo = mesh.model_index * v_local
    shard = _local(table, lo, lo + v_local).requires_grad_(True)
    ids = torch.from_numpy(job["ids"])
    out = emb.sharded_embedding_lookup(shard, ids, mesh)
    (out * torch.from_numpy(job["g_out"])).sum().backward()
    x = torch.from_numpy(job["x"])
    labels = torch.from_numpy(job["labels"])
    off, nv = job["row_offset"], job["num_valid"]
    logits = emb.sharded_logits_local(x, shard.detach(), lo, off, nv)
    ce = emb.sharded_softmax_cross_entropy(x, shard.detach(), labels, mesh, row_offset=off, num_valid=nv)
    vals, idx = emb.sharded_top_k(logits, job["k"], mesh)
    stats = emb.sharded_chunked_eval_stats(
        x, shard.detach(), labels, mesh, ks=(5, 10), row_offset=off, num_valid=nv,
        bias_shard=_local(job["bias"], lo, lo + v_local),
    )
    return {
        "lookup": out.detach().numpy(),
        "d_shard": shard.grad.numpy(),
        "logits": logits.numpy(),
        "ce": float(ce),
        "top_vals": vals.numpy(),
        "top_idx": idx.numpy(),
        "stats": {k: float(v) for k, v in stats.items()},
    }


def _sharded_ce(job: dict) -> dict:
    """The sharded fused CE's loss and gradients on this rank's rows and
    shard (the table's gradient not yet summed over the data group)."""
    data, model = job["mesh"]
    mesh = make_mesh(MeshConfig(data=data, model=model), "cpu")
    x_all, table = job["x"], job["table"]
    b_local = x_all.shape[0] // data
    v_local = table.shape[0] // model
    xb = _local(x_all, mesh.data_index * b_local, (mesh.data_index + 1) * b_local).requires_grad_(True)
    shard = _local(table, mesh.model_index * v_local, (mesh.model_index + 1) * v_local).requires_grad_(True)
    labels = _local(job["labels"], mesh.data_index * b_local, (mesh.data_index + 1) * b_local)
    off, nv = job["row_offset"], job["num_valid"]
    bias = None
    if job.get("bias") is not None:
        bias = torch.from_numpy(job["bias"]).requires_grad_(True)
        loss = emb.sharded_fused_softmax_ce_bias(xb, shard, bias, labels, off, nv, mesh)
    else:
        loss = emb.sharded_fused_softmax_ce(xb, shard, labels, off, nv, mesh)
    loss.backward()
    return {
        "coords": (mesh.data_index, mesh.model_index),
        "loss": float(loss),
        "dx": xb.grad.numpy(),
        "dw": shard.grad.numpy(),
        "db": None if bias is None else bias.grad.numpy(),
    }


def run_jobs(rank: int, world: int, jobs: list) -> list:
    out = []
    for job in jobs:
        kind = job["kind"]
        if kind == "embedding":
            out.append(_embedding_checks(job))
        elif kind == "sharded_ce":
            out.append(_sharded_ce(job))
        else:
            out.append(drive.run_job(rank, world, job))  # a tier
    return out
