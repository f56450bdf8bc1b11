"""The vocab-sharded train step over the full catalog, on a mesh of one rank.

``bert4clickpath_torch/parallel/spmd.py:make_spmd_train_step`` over a state
from ``init_sharded_state``, as ``examples/large_catalog/stress_torch.py``
wires it: the tied softmax through the fused CE kernels, the item lookup
through the sharded lookup, Adam on every parameter. The traffic is a pool
of synthetic batches moved to the device in set-up and cycled.
"""

from __future__ import annotations

import torch

from bert4clickpath_torch.config import MeshConfig
from bert4clickpath_torch.parallel import spmd
from bert4clickpath_torch.parallel.mesh import initialize_distributed, make_mesh
from bert4clickpath_torch.training import schedules
from bert4clickpath_torch.training.train_state import Adam

from portbench.harness import traffic as traffic_lib
from portbench.reference.model import param_specs
from portbench.entries.program_config import layout, model_config
from portbench.harness.session import Session, put, views


def build(cfg: dict, traffic: traffic_lib.Traffic, fill_weights, seeds: dict, device) -> Session:
    _, _, device = initialize_distributed(device.type)
    mesh = make_mesh(MeshConfig(data=1, model=1), device)
    opt = cfg["optimizer"]
    tx = Adam(opt["b1"], opt["b2"], opt["eps"], mu_dtype=getattr(torch, opt["mu_dtype"]))
    model, state = spmd.init_sharded_state(model_config(cfg), mesh, tx, seed=0)
    lay = layout(cfg, [n for n, _, _ in param_specs(cfg)])
    fill_weights(views(state.params, lay))
    step_fn = spmd.make_spmd_train_step(model, mesh, tx, schedules.constant(opt["lr"]), cfg["n_items"])
    pool = [
        {"features": {"items": put(b["tokens"], device)}, "head_positions": put(b["positions"], device),
         "labels": put(b["labels"], device)}
        for b in traffic.pool
    ]
    pool_stats = [traffic_lib.batch_stats(b) for b in traffic.pool]
    generator = torch.Generator(device).manual_seed(seeds["dropout"])
    return Session(
        model=model, state=state, step_fn=step_fn, generator=generator, device=device, layout=lay,
        batch_size=traffic.params["batch"], feed=_cycle(pool, pool_stats), _teardown=_leave_group,
    )


def _cycle(pool, stats):
    while True:
        for batch, s in zip(pool, stats):
            yield batch, s


def _leave_group() -> None:
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
