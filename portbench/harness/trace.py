"""The device trace of a few steps after the timed window, and what is read
from it.

``torch.profiler`` records the host and the card over ``profile_steps``
more steps of the same session, inside the benchmark's own ranges:
``portbench.profiled`` around all of them, and ``portbench.feed``,
``portbench.dispatch`` and ``portbench.sync`` around the feed, the step call
and the closing synchronise. The Chrome trace is written under the
temporary directory, read back and reduced to :class:`Trace`: every device
operation (kernel, memcpy, memset) with its start, length, name and the
names of the host ranges that enclosed its launch on the launching thread
(the operators, the benchmark's ranges and, with ``stacks``, the Python
frames).

Recording Python frames slows the host several times over, so a run takes
two traces: one without frames, whose timeline gives the busy and idle time,
the operations per step and the breakdown, and one with frames, which only
attributes each operation's device time to the layer that launched it.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from dataclasses import dataclass, field

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
RANGE_CATEGORIES = ("python_function", "cpu_op", "user_annotation")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
WINDOW = "portbench.profiled"
HOST_SPANS = ("portbench.feed", "portbench.dispatch", "portbench.sync")


@dataclass
class DeviceOp:
    name: str
    start: float  # seconds, the trace's clock
    dur: float  # seconds
    stack: tuple = ()  # names of the host ranges around its launch, outermost first


@dataclass
class Trace:
    ops: list  # DeviceOp inside the window, by start
    window: tuple  # (start, end) seconds of portbench.profiled
    steps: int
    host_spans: list = field(default_factory=list)  # (name, start, end) of HOST_SPANS
    batch_stats: list = field(default_factory=list)  # traffic batch_stats of each profiled step

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> list:
        """Union of the device operations' intervals, clipped to the window."""
        lo, hi = self.window
        spans = sorted((max(o.start, lo), min(o.start + o.dur, hi)) for o in self.ops)
        merged = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())


def parse(events: list, steps: int) -> Trace:
    """A :class:`Trace` from Chrome trace events (``traceEvents``)."""
    window = None
    ranges_by_tid, launches, device, host_spans = {}, {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        start, dur = float(e["ts"]) * 1e-6, float(e.get("dur", 0.0)) * 1e-6
        if cat in DEVICE_CATEGORIES:
            device.append(e)
        elif cat in LAUNCH_CATEGORIES:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), start)
        if cat in RANGE_CATEGORIES:
            ranges_by_tid.setdefault(e.get("tid"), []).append((start, start + dur, e["name"]))
            if cat == "user_annotation":
                if e["name"] == WINDOW:
                    window = (start, start + dur)
                elif e["name"] in HOST_SPANS:
                    host_spans.append((e["name"], start, start + dur))
    if window is None:
        raise ValueError(f"no {WINDOW!r} range in the trace")
    inside = [e for e in device if window[0] <= float(e["ts"]) * 1e-6 < window[1]]
    wanted = {e.get("args", {}).get("correlation") for e in inside}
    stacks = enclosing(ranges_by_tid, {c: launches[c] for c in wanted if c in launches})
    ops = [
        DeviceOp(e["name"], float(e["ts"]) * 1e-6, float(e.get("dur", 0.0)) * 1e-6,
                 stacks.get(e.get("args", {}).get("correlation"), ()))
        for e in inside
    ]
    ops.sort(key=lambda o: o.start)
    return Trace(ops, window, steps, sorted(host_spans, key=lambda s: s[1]))


def enclosing(ranges_by_tid: dict, launches: dict) -> dict:
    """key -> names of the ranges open on thread ``tid`` at time ``t``,
    outermost first, for each ``launches[key] = (tid, t)``."""
    out = {}
    queries_by_tid = {}
    for key, (tid, t) in launches.items():
        queries_by_tid.setdefault(tid, []).append((t, key))
    for tid, queries in queries_by_tid.items():
        ranges = sorted(ranges_by_tid.get(tid, []), key=lambda r: (r[0], -r[1]))
        stack, i = [], 0
        for t, key in sorted(queries, key=lambda q: q[0]):
            while i < len(ranges) and ranges[i][0] <= t:
                while stack and stack[-1][1] <= ranges[i][0]:
                    stack.pop()
                stack.append(ranges[i])
                i += 1
            out[key] = tuple(name for _, end, name in stack if end > t)
    return out


def warm(session) -> None:
    """One step under the profiler, its trace dropped: the profiler's first
    start (CUPTI's set-up) then falls outside the traced windows."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if session.device.type == "cuda" else [])
    with torch_profile(activities=activities):
        session.step(session.next())
        if session.device.type == "cuda":
            torch.cuda.synchronize()


def profile(session, steps: int, stacks: bool) -> Trace:
    """Profile ``steps`` more steps of ``session`` and parse the trace;
    ``stacks``: record the Python frames too."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    cuda = session.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    first = len(session.stats)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch_profile(activities=activities, with_stack=stacks) as prof:
        with record_function(WINDOW):
            for _ in range(steps):
                with record_function("portbench.feed"):
                    batch = session.next()
                with record_function("portbench.dispatch"):
                    session.step(batch)
            with record_function("portbench.sync"):
                sync()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    trace = parse(events, steps)
    trace.batch_stats = session.stats[first : first + steps]
    frames = sum(1 for op in trace.ops if any("): " in n for n in op.stack))
    print(f"portbench: trace of {steps} steps ({'with' if stacks else 'without'} frames): {len(events)} events, "
          f"{len(trace.ops)} device operations, {frames} launched under a Python frame, "
          f"{trace.window_s:.4f} s", file=sys.stderr, flush=True)
    return trace


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the benchmark's host range they overlap most."""
    by_name = {}
    for o in trace.ops:
        by_name[o.name] = by_name.get(o.name, 0.0) + o.dur
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = trace.busy_intervals()
    edges = [trace.window[0]] + [x for iv in busy for x in iv] + [trace.window[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    named = []
    for a, b in gaps:
        overlap = {}
        for name, s, e in trace.host_spans:
            o = min(b, e) - max(a, s)
            if o > 0:
                overlap[name] = overlap.get(name, 0.0) + o
        label = max(overlap, key=overlap.get).split(".", 1)[1] if overlap else "other"
        named.append([label, b - a])
    named.sort(key=lambda x: -x[1])
    return {"device_ops": [[n[:160], s] for n, s in device_ops], "idle_gaps": named[:top]}
