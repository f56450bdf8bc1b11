"""The toy architecture's train step, written apart from its reference
(``reference.py`` beside this file) as a program would write it, on the
program's own Adam and ``apply_gradients``; fed the mix's pool, cycled."""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from bert4clickpath_torch.training import schedules
from bert4clickpath_torch.training.train_state import Adam, TrainState, apply_gradients

from portbench.harness import traffic as traffic_lib
from portbench.harness.session import Session, put

RESERVED = 10


def _loss(p: dict, batch: dict, cfg: dict) -> torch.Tensor:
    d = cfg["d_model"]
    x = F.embedding(batch["tokens"].long(), p["embed_items.weight"]) * d**0.5
    h = F.layer_norm(x, (d,), p["block.norm.weight"], p["block.norm.bias"], 1e-5)
    gate, up = torch.einsum("bld,kfd->kblf", h, p["block.w_in"]).unbind(0)
    x = x + F.linear(F.silu(gate) * up, p["block.w_out"])
    x = F.layer_norm(x, (d,), p["final_norm.weight"], p["final_norm.bias"], 1e-5)
    rows = torch.gather(x, 1, batch["positions"].long()[..., None].expand(-1, -1, d)).reshape(-1, d)
    logits = rows @ p["embed_items.weight"][RESERVED : RESERVED + cfg["n_items"]].t()
    return F.cross_entropy(logits, batch["labels"].reshape(-1).long(), ignore_index=-1)


def build(cfg: dict, traffic: traffic_lib.Traffic, fill_weights, seeds: dict, device) -> Session:
    d, f = cfg["d_model"], cfg["ffn_dim"]
    shapes = {
        "embed_items.weight": (cfg["table_rows"], d), "block.norm.weight": (d,), "block.norm.bias": (d,),
        "block.w_in": (2, f, d), "block.w_out": (d, f), "final_norm.weight": (d,), "final_norm.bias": (d,),
    }
    params = {n: torch.empty(s, device=device, requires_grad=True) for n, s in shapes.items()}
    fill_weights(params)
    opt = cfg["optimizer"]
    tx = Adam(opt["b1"], opt["b2"], opt["eps"], mu_dtype=getattr(torch, opt["mu_dtype"]))
    schedule = schedules.constant(opt["lr"])

    def step_fn(state, batch, generator):
        names = list(state.params)
        loss = _loss(state.params, batch, cfg)
        grads = torch.autograd.grad(loss, [state.params[n] for n in names])
        return apply_gradients(state, dict(zip(names, grads)), tx, schedule), loss.detach()

    pool = [{k: put(v, device) for k, v in b.items()} for b in traffic.pool]
    stats = [traffic_lib.batch_stats(b) for b in traffic.pool]
    return Session(model=None, state=TrainState.create(params, tx), step_fn=step_fn, generator=None, device=device,
                   batch_size=traffic.params["batch"], feed=itertools.cycle(list(zip(pool, stats))),
                   layout={n: (n, None) for n in shapes})
