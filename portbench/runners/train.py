"""The runner of training cells.

1. Set-up: the traffic and the weights from the seed, the program's step
   from the cell's entry, then the checked steps (``harness/check.py``) and
   the rest of the cell's ``warm_steps``, all through the window's own call
   and feed. ``setup_s`` runs from the process's start to the window's.
2. The window: steps back to back for ``--seconds`` of wall time, then a
   synchronise; every step's feed wait and host time are the benchmark's
   spans. The rate is all examples over all the window's time.
3. ``--trace 1``: one step to start the profiler, ``profile_steps`` more
   steps under it, then as many with Python frames (``harness/trace.py``).
4. The peak device memory is read, the program's state freed, and the
   reference runs the checked steps; each number is compared with its limit.
5. The line is printed, unless the process has loaded JAX.
"""

from __future__ import annotations

import functools
import gc
import json
import math
import sys
import time
from dataclasses import dataclass
from typing import Optional

import torch

from portbench.harness import check, manifest, isolation
from portbench.harness import trace as trace_lib
from portbench.harness import traffic as traffic_lib
from portbench.harness import weights as weights_lib
from portbench.reference import model as ref


@dataclass
class Window:
    start: float  # host clock at the window's start
    seconds: float
    steps: int
    batch: int
    wait_s: float  # in the feed
    host_s: float  # in the step call
    stats: list  # traffic batch_stats of each step
    last_loss: float


@dataclass
class Context:
    """What a metric reader reads."""

    cell: manifest.Cell
    setup_s: float
    window: Window
    trace: Optional[trace_lib.Trace] = None  # the timeline, without Python frames
    stack_trace: Optional[trace_lib.Trace] = None  # with frames: which layer launched what

    @property
    def config(self) -> dict:
        return self.cell.config


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(session, seconds: float, device) -> Window:
    sync(device)
    first = len(session.stats)
    wait = host = 0.0
    steps = 0
    start = time.perf_counter()
    while True:
        a = time.perf_counter()
        batch = session.next()
        b = time.perf_counter()
        loss = session.step(batch)
        c = time.perf_counter()
        wait += b - a
        host += c - b
        steps += 1
        if c - start >= seconds:
            break
    sync(device)
    end = time.perf_counter()
    return Window(start, end - start, steps, session.batch_size, wait, host,
                  session.stats[first : first + steps], float(loss))


def seeds_of(seed: int) -> dict:
    return {"dropout": weights_lib.mix(seed, weights_lib.DROPOUT),
            "batches": weights_lib.mix(seed, weights_lib.BATCHES)}


def build_session(cell: manifest.Cell, seed: int, device):
    """(session, traffic, seeds) of a run seeded with ``seed``."""
    cfg = cell.config
    traffic = traffic_lib.make(cell.traffic, cfg["n_items"], seed)
    seeds = seeds_of(seed)
    specs = ref.param_specs(cfg)
    std = cfg["init"]["table_std"]
    session = manifest.entry(cell.spec["entry"]).build(
        cfg, traffic, lambda params: weights_lib.fill(params, specs, seed, std), seeds, device,
    )
    return session, traffic, seeds


def run(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device, start: float) -> int:
    """One run; prints its line and returns the exit code."""
    cfg, spec = cell.config, cell.spec
    session, traffic, seeds = build_session(cell, seed, device)
    from bert4clickpath_torch.ops.kernels import _build

    batches = functools.cache(lambda: check.reference_batches(traffic, cfg, seeds))
    rows = check.kept_rows(cfg, seed, batches)
    ours = check.program_steps(session, cfg, seed, rows)
    for _ in range(spec["warm_steps"] - check.CHECKED_STEPS):
        session.step(session.next())
    _build.reset_launch_counts()
    window = measure(session, seconds, device)
    launches = {k: v / window.steps for k, v in _build.launch_counts().items() if v}
    ctx = Context(cell, window.start - start, window)
    if trace:
        trace_lib.warm(session)
        ctx.trace = trace_lib.profile(session, spec["profile_steps"], stacks=False)
        ctx.stack_trace = trace_lib.profile(session, spec["profile_steps"], stacks=True)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    print(f"portbench: {cell.name} seed {seed}: {window.steps} steps in {window.seconds:.3f} s, "
          f"kernel launches per step {launches}, peak device memory {peak} bytes", flush=True)
    session.close()
    del session
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    theirs, rms = check.reference_steps(cfg, batches(), seed, seeds, device, rows)
    numbers, where = check.compare(ours, theirs, rms)
    limits = spec["limits"]
    correct = check.judge(numbers, limits)
    worst = {k: where[k] for k in ("grad_gap", "grad_diff", "change_gap", "left_out")}
    print(f"portbench: losses {ours.losses}, reference {theirs.losses}; worst: {worst}", file=sys.stderr)

    metrics = cell.per_layer if trace else cell.end_to_end
    values = {}
    for m in metrics:
        value = manifest.metric_reader(m["name"])(ctx)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    found = isolation.forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}: no result", file=sys.stderr)
        return 4
    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": peak,
    }
    line = {"correct": correct, "attempted": window.steps, "failed": int(not math.isfinite(window.last_loss)),
            "metrics": values, "device": device_info}
    if ctx.trace is not None:
        device_info["busy_s"] = ctx.trace.busy_s()
        device_info["window_s"] = ctx.trace.window_s
        line["breakdown"] = trace_lib.breakdown(ctx.trace)
    line["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in check.NUMBERS}
    print(json.dumps(line), flush=True)
    print(f"portbench: correct {correct}", file=sys.stderr)
    for k in check.NUMBERS:
        print(f"check {k} {numbers[k]!r} limit {limits[k]!r}", file=sys.stderr, flush=True)
    return 0
