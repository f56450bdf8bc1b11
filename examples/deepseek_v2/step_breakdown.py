"""Where the DeepSeek-V2 cell's train step spends the card's time: the
cell's own session (``portbench``'s entry, weights and traffic from the
seed), a few warm steps, then ``--steps`` steps under ``torch.profiler``;
prints device milliseconds a step by innermost program span, and the
largest (span, operator, kernel) entries:

    python3 examples/deepseek_v2/step_breakdown.py [--workload dsv2_lite.train_l200] [--steps 2] [--top 40]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.harness import manifest, spans  # noqa: E402
from portbench.harness import trace as trace_lib  # noqa: E402
from portbench.runners import train  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="dsv2_lite.train_l200")
    p.add_argument("--seed", type=int, default=2718281828)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--top", type=int, default=40)
    args = p.parse_args(argv)
    device = torch.device("cuda", 0)
    cell = manifest.cell(args.workload)
    session, _, _ = train.build_session(cell, args.seed, device)
    for _ in range(3):
        session.step(session.next())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        session.step(session.next())
    torch.cuda.synchronize()
    print(f"wall ms a step (5 steps): {(time.perf_counter() - t0) / 5 * 1e3:.2f}; "
          f"peak {torch.cuda.max_memory_allocated(device)} bytes")
    trace_lib.warm(session)
    t = trace_lib.profile(session, args.steps, stacks=False)
    print(f"busy ms a step: {t.busy_s() / t.steps * 1e3:.2f}")
    by_span, by_entry = {}, {}
    for op in t.ops:
        span = spans.innermost(op) or "-"
        aten = next((n for n in reversed(op.stack) if n.startswith("aten::")), "-")
        by_span[span] = by_span.get(span, 0.0) + op.dur
        key = (span, aten, op.name[:90])
        by_entry[key] = by_entry.get(key, 0.0) + op.dur
    for span, s in sorted(by_span.items(), key=lambda kv: -kv[1]):
        print(f"{1e3 * s / t.steps:9.3f} ms  {span}")
    for (span, aten, name), s in sorted(by_entry.items(), key=lambda kv: -kv[1])[: args.top]:
        print(f"{1e3 * s / t.steps:9.3f} ms  {span:18s} {aten:32s} {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
