"""The program's own spans and counters, as the metric readers see them.

The program (``bert4clickpath_torch/utils/profiling.py``) names its layers
with ranges whose names start ``b4cp.``: under the profiler they are user
ranges on the thread that runs the layer (its backward on the autograd
engine's thread), so each device operation's ``stack`` (``harness/trace.py``)
holds the names of the program's ranges open around its launch, outermost
first. An operation belongs to the innermost one: the attention kernels to
``b4cp.attention``, not to the ``b4cp.encoder`` around them. Off the
profiler the same spans add their calls and host seconds to the program's
counter registry (``profiling.counters()``), which the runner empties just
before the timed window, so it holds the window alone when metrics are
read.

A program without these spans (an older commit) gives every reader None.
"""

from __future__ import annotations

from typing import Optional

PREFIX = "b4cp."


def innermost(op) -> Optional[str]:
    """The innermost program span around an operation's launch, or None."""
    for name in reversed(op.stack):
        if name.startswith(PREFIX):
            return name
    return None


def has_spans(trace) -> bool:
    return trace is not None and any(innermost(op) is not None for op in trace.ops)


def device_ms_per_step(trace, span: str) -> Optional[float]:
    """Device milliseconds per profiled step of the operations whose
    innermost program span is ``span``; None on a trace without spans."""
    if not has_spans(trace):
        return None
    return 1e3 * sum(op.dur for op in trace.ops if innermost(op) == span) / trace.steps


def counters() -> Optional[dict]:
    """The program's counter registry ``{name: (calls, seconds)}``, or None
    where the program has none."""
    try:
        from bert4clickpath_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "counters", None)
    return None if read is None else read()


def host_ms_per_step(ctx, span: str) -> Optional[float]:
    """Host milliseconds per step of the timed window spent in ``span``,
    from the counter registry; None where the program never counted it."""
    now = counters()
    if not now or span not in now:
        return None
    return 1e3 * now[span][1] / ctx.window.steps
