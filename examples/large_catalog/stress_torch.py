"""Large-catalog stress of the PyTorch port: a 10M-item tied softmax trained
over a row-sharded item table.

The counterpart of ``examples/large_catalog/stress.py`` (BASELINE.json
configs[4]): the same flags, model and synthetic batch. The item table is
row-sharded over the mesh's model group and built in place
(``parallel/spmd.py:init_sharded_state``: each rank draws only its own
rows, so the whole table never exists on one device); lookups go through
the sharded lookup and the loss through the vocab-parallel fused CE (the
CE kernels with their ``row_start``), so the (B, P, V) logits never exist
either. ``--sampled S`` trains on S batch-shared sampled-softmax negatives
instead (``make_sampled_spmd_train_step``: no CE kernel).

The mesh is the ``torchrun`` world (``parallel/mesh.py:initialize_distributed``;
outside ``torchrun`` a world of one): model = min(4, world) and data =
world / model unless given. On one card that is one rank holding the whole
table (10,000,384 x 128 f32 rows: 5.12 GB).

  python3 examples/large_catalog/stress_torch.py
  torchrun --nproc_per_node 4 examples/large_catalog/stress_torch.py
  python3 examples/large_catalog/stress_torch.py --sampled 8192
  python3 examples/large_catalog/stress_torch.py --device cpu --items 5000 --d_model 16 --steps 2

Runs on the card and raises where there is none; ``--device cpu`` (gloo)
is for a smoke run through the kernels' plain versions at a small size.
Prints the mesh, the table's size in all and per shard, the dense logits
it avoids, the first loss against ln(V), steady ms/step and examples/s,
the kernel launches per step and each rank's peak device memory.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

from bert4clickpath_torch.config import FeatureConfig, HeadConfig, MeshConfig, ModelConfig, TrainConfig
from bert4clickpath_torch.constants import NUM_RESERVED_TOKENS
from bert4clickpath_torch.data.synthetic import synthetic_batch
from bert4clickpath_torch.ops.kernels import _build
from bert4clickpath_torch.parallel import spmd
from bert4clickpath_torch.parallel.mesh import initialize_distributed, make_mesh
from bert4clickpath_torch.training import schedules
from bert4clickpath_torch.training.train_state import make_optimizer

MAX_MASKED = 10  # masked positions per session (stress.py's synthetic_batch call)
PROFILED_STEPS = 3  # steps run for a caller's profiler, after the timed window


def stress_config(items: int, d_model: int, max_items: int, model_axis: int, dtype: str) -> ModelConfig:
    """The model of ``stress.py:93-102``: 2 layers, 4 heads, FFN 4 d, a tied
    softmax over ``items`` labels whose table rows are padded to divide
    over the model group."""
    rows = spmd.padded_vocab_rows(NUM_RESERVED_TOKENS + items + 1, model_axis)
    return ModelConfig(
        features={"items": FeatureConfig(rows, d_model)},
        num_layers=2,
        num_heads=4,
        ffn_dim=4 * d_model,
        max_len=max_items + 3,
        head=HeadConfig("tied_softmax", output_size=items),
        dtype=dtype,
    )


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--items", type=int, default=10_000_000)
    p.add_argument("--d_model", type=int, default=128)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--max_items", type=int, default=50)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--data_axis", type=int, default=0, help="0 = auto")
    p.add_argument("--model_axis", type=int, default=0, help="0 = auto")
    p.add_argument(
        "--sampled", type=int, default=0,
        help="train with S batch-shared sampled-softmax negatives instead of the full-catalog fused CE "
        "(parallel.spmd.make_sampled_spmd_train_step)",
    )
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, profile=None) -> dict:
    """Run the stress; returns what it printed as numbers: the first and
    last loss, every loss, ms/step, examples/s, launches per step and the
    peak device memory in bytes (None on the CPU). ``profile(steps, fn)``:
    called after the timed window with a function that runs ``steps`` more
    steps (a profiler around them; ``chip_smoke.py``'s device profile); its
    result is returned as ``profile``."""
    args = parse_args(argv)
    rank, world, device = initialize_distributed(args.device)
    model_axis = args.model_axis or min(4, world)
    data_axis = args.data_axis or world // model_axis
    mesh = make_mesh(MeshConfig(data=data_axis, model=model_axis), device)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"mesh: data={data_axis} model={model_axis} on {device.type}"
        + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    cfg = stress_config(args.items, args.d_model, args.max_items, model_axis,
                        "bfloat16" if device.type == "cuda" else "float32")
    rows = cfg.features["items"].vocab_rows
    table_gb = rows * args.d_model * 4 / 1e9
    say(f"catalog={args.items:,} table rows={rows:,} table={table_gb:.2f} GB f32 "
        f"({table_gb / model_axis:.2f} GB/shard; x3 with Adam moments)")
    dense_logits_gb = args.batch * MAX_MASKED * args.items * 4 / 1e9
    say(f"dense (B,P,V) logits would be {dense_logits_gb:.1f} GB -> vocab-parallel CE instead")
    shard_gb = table_gb / model_axis
    say(f"reckoned per rank: shard {shard_gb:.2f} GB + Adam's two moments {2 * shard_gb:.2f} + its two gradients "
        f"(the CE kernel's dW, the lookup's scatter-add) {2 * shard_gb:.2f} = {5 * shard_gb:.2f} GB, before the "
        "optimizer's temporaries")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tx = make_optimizer(TrainConfig())
    model, state = spmd.init_sharded_state(cfg, mesh, tx, seed=0)
    if args.sampled:
        step = spmd.make_sampled_spmd_train_step(model, mesh, tx, schedules.constant(1e-3), args.items, args.sampled)
        say(f"sampled softmax: S={args.sampled} negatives/step")
    else:
        step = spmd.make_spmd_train_step(model, mesh, tx, schedules.constant(1e-3), args.items)

    rng = np.random.default_rng(0)
    host = synthetic_batch(rng, args.batch, args.max_items, MAX_MASKED, args.items)
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    batch = spmd.shard_batch({"features": {k: put(v) for k, v in host["features"].items()},
                              "head_positions": put(host["head_positions"]), "labels": put(host["labels"])}, mesh)
    generator = spmd.tier_generator(mesh, 1)
    state, loss = step(state, batch, generator)  # builds the kernels
    first = float(loss)
    say(f"first step loss={first:.4f} (expect ~ln(V)={math.log(args.items):.2f})")

    _sync(device)
    _build.reset_launch_counts()
    losses = [first]
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, loss = step(state, batch, generator)
        losses.append(loss)
    _sync(device)
    dt = (time.perf_counter() - t0) / max(args.steps, 1)
    per = max(args.steps, 1)
    launches = {k: v // per if v % per == 0 else v / per for k, v in _build.launch_counts().items() if v}
    losses = [float(v) for v in losses]
    say(f"steady: {dt * 1e3:.1f} ms/step -> {args.batch / dt:,.0f} examples/s (loss {losses[-1]:.4f})")
    say(f"kernel launches per step: {launches}")
    profiled = None
    if profile is not None:
        def more_steps():
            nonlocal state
            for _ in range(PROFILED_STEPS):
                state, _ = step(state, batch, generator)

        profiled = profile(PROFILED_STEPS, more_steps)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    where = f"{peak / 1e9:.2f} GB" if peak is not None else "not measured (CPU)"
    print(f"rank {rank}: peak device memory {where}; table shard {tuple(model.embed_items.weight.shape)}", flush=True)
    return dict(first_loss=first, loss=losses[-1], losses=losses, ms_per_step=dt * 1e3,
                examples_per_s=args.batch / dt, launches=launches, peak_bytes=peak, rows=rows,
                shard_rows=int(model.embed_items.weight.shape[0]), profile=profiled)


if __name__ == "__main__":
    main()
