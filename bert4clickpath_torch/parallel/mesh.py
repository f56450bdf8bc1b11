"""The (data, model) process mesh over ``torch.distributed`` (counterpart of
``bert4clickpath_tpu/parallel/mesh.py``).

A world of ``data * model`` processes, one per card (or several sharing a
card or the CPU over gloo), laid out as the JAX mesh lays out its devices:
rank = data_index * model + model_index. Each rank holds

* its **data group** (the ranks with its model index): the batch's rows
  shard over it and gradients, losses and eval sums are summed over it;
* its **model group** (the ranks with its data index): the item table's
  rows shard over it, lookups and CE statistics combine over it.

Every collective of the tiers is an ``all_reduce`` (sum or max) or a
``broadcast``: gloo carries CUDA tensors for those two only, so one code
path runs on gloo-CPU, gloo-CUDA (two ranks sharing one card) and NCCL. An
all-gather is an ``all_reduce`` sum of a zero-padded buffer.

:func:`initialize_distributed` starts a world from the ``torchrun``
environment; :func:`spawn` starts a local world over a ``FileStore`` (tests
and ``chip_smoke.py``).
"""

from __future__ import annotations

import multiprocessing
import os
import queue as queue_lib
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from bert4clickpath_torch.config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass
class Mesh:
    """This rank's place in the (data, model) mesh and its two groups."""

    config: MeshConfig
    rank: int
    data_index: int
    model_index: int
    data_group: Any  # ProcessGroup of the ranks sharing model_index
    model_group: Any  # ProcessGroup of the ranks sharing data_index
    device: torch.device

    @property
    def data_size(self) -> int:
        return self.config.data

    @property
    def model_size(self) -> int:
        return self.config.model

    def group(self, axis: str):
        return self.data_group if axis == DATA_AXIS else self.model_group

    def size(self, axis: str) -> int:
        return self.data_size if axis == DATA_AXIS else self.model_size


def make_mesh(cfg: Optional[MeshConfig], device) -> Mesh:
    """This rank's mesh over the initialised default group, its tensors on
    ``device`` (named by the caller: "cuda" or "cpu"). With no config, every
    rank goes data-parallel. Every rank must call it (each group is created
    by all ranks, in one order)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    cfg = cfg or MeshConfig(data=world, model=1)
    if cfg.num_devices != world:
        raise ValueError(f"mesh {cfg.data}x{cfg.model} needs {cfg.num_devices} ranks, got {world}")
    data_index, model_index = divmod(rank, cfg.model)
    model_group = data_group = None
    for d in range(cfg.data):
        g = dist.new_group([d * cfg.model + m for m in range(cfg.model)])
        if d == data_index:
            model_group = g
    for m in range(cfg.model):
        g = dist.new_group([d * cfg.model + m for d in range(cfg.data)])
        if m == model_index:
            data_group = g
    return Mesh(cfg, rank, data_index, model_index, data_group, model_group, torch.device(device))


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """In-place sum (or max) of ``t`` over the mesh axis; a no-op over a
    group of one. Never traced by autograd: callers pass plain tensors."""
    if mesh.size(axis) > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM, group=mesh.group(axis))
    return t


def all_gather_stacked(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """(S, *t.shape): every rank's ``t`` along the axis, by its index, as
    an ``all_reduce`` sum of a zero-padded buffer (exact: one term per
    slot is nonzero)."""
    s = mesh.size(axis)
    index = mesh.data_index if axis == DATA_AXIS else mesh.model_index
    buf = torch.zeros((s, *t.shape), dtype=t.dtype, device=t.device)
    buf[index] = t
    return all_reduce(buf, mesh, axis)


def sum_flat(tensors: Sequence[torch.Tensor], mesh: Mesh, axis: str) -> list[torch.Tensor]:
    """Each tensor summed over the axis, in one ``all_reduce`` of an f32
    buffer they are packed into; returned in their own shapes and dtypes."""
    if mesh.size(axis) == 1:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    all_reduce(flat, mesh, axis)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at : at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(device: str) -> tuple[int, int, torch.device]:
    """Start the default group from the ``torchrun`` environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) on the
    device the caller names: NCCL on the card (each rank on
    ``cuda:LOCAL_RANK``; raises without one), gloo on the CPU. Outside
    ``torchrun``, a world of one over an in-process store. Returns (rank,
    world size, device)."""
    under_torchrun = "WORLD_SIZE" in os.environ and "RANK" in os.environ
    rank = int(os.environ["RANK"]) if under_torchrun else 0
    world = int(os.environ["WORLD_SIZE"]) if under_torchrun else 1
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed('cuda'): no CUDA card")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if under_torchrun:
            dist.init_process_group(backend_for(dev), init_method="env://", rank=rank, world_size=world)
        else:
            dist.init_process_group(backend_for(dev), store=dist.HashStore(), rank=0, world_size=1)
    return rank, world, dev


def _worker(rank, world, fn, args, store_path, backend, results, timeout_s):
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))


def spawn(
    fn: Callable, world: int, store_path: str, args: tuple = (), backend: str = "gloo",
    timeout_s: float = 600.0,
) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes (the spawn
    method) that form a world over a ``FileStore`` at ``store_path`` (a
    fresh file per world), and return their results by rank. ``fn`` must be
    a module-level function of a module that imports no JAX (a child
    imports the module that defines it). Raises with the child's traceback
    if a rank fails; every process is joined or killed before returning."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_worker, args=(r, world, fn, args, store_path, backend, results, timeout_s))
        for r in range(world)
    ]
    for p in procs:
        p.start()
    got: dict[int, Any] = {}
    errors = []
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < world and not errors:
            try:
                rank, ok, out = results.get(timeout=5.0)
            except queue_lib.Empty:
                # a rank that died without reporting (a crash) ends the wait
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    errors.append(f"ranks {dead} exited with codes {[procs[r].exitcode for r in dead]}")
                elif time.monotonic() > deadline:
                    raise TimeoutError(f"spawned world of {world}: no result within {timeout_s} s") from None
                continue
            if ok:
                got[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
    finally:
        for p in procs:
            p.join(timeout=5 if errors else 60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("spawned rank failed: " + "\n".join(errors))
    return [got[r] for r in range(world)]
