"""Run one cell of the port's benchmark once, on the card, and print its line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``: each number the check of outputs compared, with its limit. The
same numbers close standard error. Without a card, or with fewer cards than
the cell asks for, it prints no result and exits 3.
"""

from __future__ import annotations

import time

START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
# caches of what the program builds and compiles: fixed directories inside
# the checkout, so that only a checkout's first run builds
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton_cache")
os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda_cache")
os.environ["USE_FLAX"] = "0"
os.environ["OMP_NUM_THREADS"] = "1"  # the native batcher on the main thread: no threads to contend
sys.path.insert(0, str(ROOT))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from portbench.harness import manifest

    cell = manifest.cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), found {found}", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    run = manifest.runner(cell.spec["runner"], ROOT).run
    return run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), START)


if __name__ == "__main__":
    sys.exit(main())
