"""Long-session bench of the PyTorch port: the train step on sessions of
hundreds to thousands of events.

The counterpart of ``examples/long_context/bench.py``: the same 4-layer /
256-wide model, the same synthetic batch, the same plain train step (one
step per call, Adam, fused tied-softmax CE). At these lengths attention runs
through the blockwise (K/V-streaming) CUDA kernels, which never hold a
(B, H, L, L) score tensor in device memory; ``--dropout_impls`` times the
train step once per dropout back end (``mask``: ``torch.rand`` masks;
``fused``: the dropout kernel with its in-kernel generator).

Runs on the card and raises where there is none; ``--device cpu`` is for a
smoke run through the kernels' plain versions at a small size.

  python3 examples/long_context/bench_torch.py --seq_len 1024 --batch 16
  python3 examples/long_context/bench_torch.py --seq_len 512 --batch 32 --dropout_impls mask,fused
  python3 examples/long_context/bench_torch.py --device cpu --seq_len 64 --batch 2 --items 500 \\
      --d_model 32 --layers 1 --steps 2
Prints one ms/step line per dropout back end, with the card's name and
power limit on it.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

from bert4clickpath_torch.config import TrainConfig
from bert4clickpath_torch.data.synthetic import long_context_config, seeded_state_dict, synthetic_batch
from bert4clickpath_torch.models.model import ClickstreamModel
from bert4clickpath_torch.ops.kernels import _build
from bert4clickpath_torch.training import schedules
from bert4clickpath_torch.training.train_state import TrainState, make_optimizer, make_train_step


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_one(cfg, batch_np, dropout_impl, steps, num_valid, device):
    """(seconds per step, last loss, kernel launches per step) of ``steps``
    train steps after one warm-up step."""
    model = ClickstreamModel(cfg, device=device, dropout_impl=dropout_impl)
    model.load_state_dict(seeded_state_dict(cfg, 0))
    batch = {
        "features": {k: torch.from_numpy(v).to(device) for k, v in batch_np["features"].items()},
        "head_positions": torch.from_numpy(batch_np["head_positions"]).to(device),
        "labels": torch.from_numpy(batch_np["labels"]).to(device),
    }
    tx = make_optimizer(TrainConfig(batch_size=batch["labels"].shape[0]))
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, tx, schedules.constant(1e-3), fused_ce_num_valid=num_valid)
    rng = torch.Generator(device).manual_seed(1)
    state, loss = step(state, batch, rng)  # builds the kernels, warms the allocator
    loss.item()
    _build.reset_launch_counts()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = step(state, batch, rng)
    lv = loss.item()  # the fetch waits for the last step
    dt = (time.perf_counter() - t0) / steps
    launches = {k: n / steps for k, n in _build.launch_counts().items() if n}
    return dt, lv, launches


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seq_len", type=int, default=512, help="L incl. [CLS]/[SEP]s")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--items", type=int, default=20_000)
    p.add_argument("--d_model", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument(
        "--dropout_impls", default="mask",
        help="comma list of dropout back ends to time (mask, fused)",
    )
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu for a smoke run")
        where = card_line()
    else:
        where = "cpu (plain versions; not a measurement of the port)"

    max_items = args.seq_len - 3  # [CLS] [SEP] ... [SEP]
    cfg = long_context_config(
        args.seq_len, args.items, args.d_model, args.layers, args.heads, args.dropout,
        dtype="bfloat16" if device.type == "cuda" else "float32",
    )
    scores_mb = args.batch * args.heads * args.seq_len * args.seq_len * 4 / 1e6
    print(
        f"L={args.seq_len} B={args.batch} H={args.heads}: a dense (B,H,L,L) f32 score tensor "
        f"would be {scores_mb:.0f} MB per layer; the blockwise kernels keep it in shared memory"
    )
    batch_np = synthetic_batch(np.random.default_rng(0), args.batch, max_items, 10, args.items)
    for drop in args.dropout_impls.split(","):
        dt, lv, launches = run_one(cfg, batch_np, drop, args.steps, args.items, device)
        print(
            f"dropout={drop:6s}: {dt * 1e3:8.2f} ms/step {args.batch / dt:10,.0f} examples/s "
            f"(loss {lv:.3f}) launches/step {launches} [{where}]"
        )


if __name__ == "__main__":
    main()
