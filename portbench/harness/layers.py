"""Which layer launched a device operation.

An operation belongs to a layer by the program's Python frame around its
launch (the trace's ``python_function`` ranges: ``<file>(<line>): <name>``),
and, where the profiler recorded no frames on the launching thread, by the
program's own kernel names. Each metric file names its frames and kernels.
"""

from __future__ import annotations

import re


def in_frame(op, file_suffix: str, functions) -> bool:
    """Launched inside one of ``functions`` of a file ending ``file_suffix``."""
    for name in op.stack:
        head, sep, func = name.rpartition("): ")
        if sep and func in functions and head.rsplit("(", 1)[0].endswith(file_suffix):
            return True
    return False


def has_frames(trace) -> bool:
    return any("): " in name for op in trace.ops for name in op.stack)


def select(trace, file_suffix: str, functions, kernels: str = None) -> list:
    """The operations of a layer: by frame where the trace has frames for
    them, else (``kernels``, a regular expression) by kernel name."""
    by_frame = [op for op in trace.ops if in_frame(op, file_suffix, functions)]
    if by_frame or kernels is None:
        return by_frame
    pattern = re.compile(kernels)
    return [op for op in trace.ops if pattern.search(op.name)]


def device_seconds(ops) -> float:
    return sum(op.dur for op in ops)


def share(bound_s: float, ops) -> float | None:
    """Percent of the roofline: the least time over the measured time; None
    where nothing was found to measure."""
    measured = device_seconds(ops)
    if not ops or measured <= 0.0:
        return None
    return 100.0 * bound_s / measured
