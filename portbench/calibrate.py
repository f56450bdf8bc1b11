"""Readings that the limits of a cell's check are set from (not run by the
benchmark's runs).

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --faults 3 [--out FILE]

In one process, on the card at the cell's own size:

* the program: for each of ``--seeds`` seeds, its checked steps against the
  reference's (the lower readings: the largest over the seeds);
* for the first ``--faults`` seeds, the reference put in the program's place
  with a fault, against the plain reference (the upper readings):
  ``fp8`` (the control: every product's operands rounded to fp8, the
  precision below the configuration's bf16), ``half_batch`` (half of each
  batch left out, the mean taken over the rest), ``frozen`` (a step that
  leaves the state unchanged) and ``label_shift`` (every label altered
  where the batch is made: the next item of the catalog): the faults a
  training cell on one card can have (it has no exchange between chips);
  where the batches carry a sampled softmax's negatives, also
  ``negatives_shift`` (other negatives scored than the ones passed: the
  next item of each, as a program that draws its own would).

Prints one JSON line per reading and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench.harness import check, manifest  # noqa: E402
from portbench.reference import common  # noqa: E402
from portbench.runners import train  # noqa: E402

FAULTS = ("fp8", "half_batch", "frozen", "label_shift")
NEGATIVE_FAULTS = ("negatives_shift",)  # where the batches carry negatives
SESSION_KEYS = ("tokens", "positions", "labels")  # a batch's arrays of one row a session
FIRST_SEED = 7_000_000_000


def half_batch(batches: list) -> list:
    """Half of each batch's sessions; batch-shared arrays (negatives) whole."""
    return [{k: v[: v.shape[0] // 2] if k in SESSION_KEYS else v for k, v in b.items()} for b in batches]


def label_shift(batches: list, n_items: int) -> list:
    return [dict(b, labels=np.where(b["labels"] == common.LABEL_PAD, b["labels"], (b["labels"] + 1) % n_items))
            for b in batches]


def negatives_shift(batches: list, n_items: int) -> list:
    return [dict(b, negatives=(b["negatives"] + 1) % n_items) for b in batches]


def faults_of(batches: list) -> tuple:
    """The faults read on these batches."""
    return FAULTS + (NEGATIVE_FAULTS if "negatives" in batches[0] else ())


def program_readings(cell, seed: int, device):
    """(the program's readings, the checked batches, the table's kept
    rows, the run's seeds)."""
    session, traffic, seeds = train.build_session(cell, seed, device)
    cfg = cell.config
    batches = check.reference_batches(traffic, cfg, seeds)
    rows = check.kept_rows(cfg, seed, lambda: batches)
    ours = check.program_steps(session, cfg, seed, rows, cell.root)
    session.close()
    del session
    gc.collect()
    torch.cuda.empty_cache()
    return ours, batches, rows, seeds


def calibrate(cell, seeds: list, faults: int, device, emit) -> None:
    cfg = cell.config
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        ours, batches, rows, run_seeds = program_readings(cell, seed, device)
        theirs, rms = check.reference_steps(cfg, batches, seed, run_seeds, device, rows, root=cell.root)
        numbers, where = check.compare(ours, theirs, rms)
        emit({"cell": cell.name, "seed": seed, "side": "program", "numbers": numbers, "where": where,
              "losses": ours.losses, "reference_losses": theirs.losses, "seconds": time.perf_counter() - t0})
        if i >= faults:
            continue
        variants = {
            "fp8": lambda: dict(batches=batches, numerics="fp8"),
            "half_batch": lambda: dict(batches=half_batch(batches)),
            "frozen": lambda: dict(batches=batches, frozen=True),
            "label_shift": lambda: dict(batches=label_shift(batches, cfg["n_items"])),
            "negatives_shift": lambda: dict(batches=negatives_shift(batches, cfg["n_items"])),
        }
        for name in faults_of(batches):
            kw = variants[name]()
            faulty, _ = check.reference_steps(cfg, kw.pop("batches"), seed, run_seeds, device, rows, root=cell.root,
                                              **kw)
            numbers, where = check.compare(faulty, theirs, rms)
            emit({"cell": cell.name, "seed": seed, "side": name, "numbers": numbers, "where": where})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--first_seed", type=int, default=FIRST_SEED)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    cell = manifest.cell(args.workload, ROOT)
    lines = []

    def emit(record):
        lines.append(record)
        print(json.dumps(record), flush=True)

    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    calibrate(cell, seeds, args.faults, torch.device("cuda", 0), emit)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
