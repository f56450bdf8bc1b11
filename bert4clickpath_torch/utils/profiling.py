"""The port's observability: spans, one counter registry, the Chrome-trace
exporter, and the card's peaks.

**Spans.** :class:`span` names a region of the program. While a
``torch.profiler`` records, it enters ``record_function(name)``, so the
region is a user range in the same timeline as the card's operations;
otherwise it adds one call and the region's host seconds to the registry
under its name, and does nothing else. So a profiled step's host cost is
never counted as the program's, and an unprofiled one pays two
``perf_counter`` calls a span. :class:`block` is a span whose backward also
lies in a range of its name: an identity autograd function on the block's
input (``block.input``) or a hook on the node of a parameter's read
(``block.after``) closes a range that an identity function on its output
(``block.output``) opens. The engine runs a block's backward on the thread
that runs the backward (on the card the autograd engine's device thread,
not the caller's), so its launches lie inside that range there. Markers are
put in only while the profiler records, under grad mode, on tensors that
require a gradient; they launch nothing and leave every gradient bit-equal.
A block's range is closed by the backward of its inputs; where a backward
does not reach one of them (a gradient of some parameters only, a frozen
input), the range is closed when that backward ends.

The spans of the program, one name each (readers and ``PERF.md`` use
them):

============================ ============================================= ========= ========
span                         where                                         forward   backward
============================ ============================================= ========= ========
``b4cp.feed.batch``          ``data/pipeline.py``: one Cloze batch made    host      -
``b4cp.feed.copy``           ``data/pipeline.py:to_device``                host+copy -
``b4cp.step``                the single-device and the vocab-sharded step  yes       -
``b4cp.embed``               item lookup, positions, padding bias          block     block
                             (``models/model.py:encode``)
``b4cp.encoder``             the encoder's input dropout, each layer (a    block     block
                             remat recompute too), pre-LN's final LayerNorm
``b4cp.attention``           the attention kernels' autograd functions     launch    launch
                             (``uneven_mha`` too)
``b4cp.mla``                 the DeepSeek-V2 block's latent attention but  block     block
                             its core (``models/deepseek_v2.py``)
``b4cp.moe.route``           router, top-k, balance loss, the sort by      block     block
                             expert, the gathers to and from the rows
``b4cp.moe.experts``         the grouped expert products and SwiGLU        block     block
``b4cp.moe.shared``          the shared experts                            block     block
``b4cp.head``                routing gather, tied transform, float cast    block     block
``b4cp.ce_fwd``              ``ops/kernels/fused_ce.py:ce_stats``          launch    -
``b4cp.ce_bwd``              ``ops/kernels/fused_ce.py:ce_backward``       -         launch
``b4cp.optimizer``           ``training/train_state.py:apply_gradients``   yes       -
============================ ============================================= ========= ========

**Counters.** :func:`counters` is the one registry: ``{name: (calls,
seconds)}`` of every span run off the profiler, beside the kernel counters
of ``ops/kernels/_build.py`` (``kernels.<kernel>``: launches, e.g.
``kernels.grouped_gemm`` and ``kernels.moe_gather_sum``;
``copies.<counter>``: copies a wrapper made; seconds 0) and
``kernels.adam.tensors``, the tensors the Adam kernel updated
(``ops/kernels/adam.py``). :func:`reset`
empties it (``_build.reset_launch_counts`` keeps the copy counters, so a
run can show that it made no copy anywhere).

**Export.** :func:`trace` wraps a block in ``torch.profiler`` and writes a
Chrome trace.

``H100_PEAKS`` are one NVIDIA H100 SXM's dense rates at 700 W (NVIDIA's
data sheet), the ones ``chip_smoke.py`` rates its kernels against.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

# device memory bytes/s; bf16 and TF32 tensor-core FLOP/s (dense); f32 on
# the CUDA cores (also integer work)
H100_PEAKS = {"bytes": 3.35e12, "bf16": 989e12, "tf32": 495e12, "f32": 67e12}

_registry: dict[str, list] = {}  # name -> [calls, seconds]
_lock = threading.Lock()  # a backward's spans count on the autograd engine's thread


def add(name: str, seconds: float = 0.0, calls: int = 1) -> None:
    """Add ``calls`` and ``seconds`` to the counter ``name``."""
    with _lock:
        entry = _registry.get(name)
        if entry is None:
            _registry[name] = [calls, seconds]
        else:
            entry[0] += calls
            entry[1] += seconds


def counters() -> dict[str, tuple[int, float]]:
    """A snapshot of the registry: ``{name: (calls, seconds)}``."""
    with _lock:
        return {name: (calls, seconds) for name, (calls, seconds) in _registry.items()}


def reset(keep: tuple[str, ...] = ()) -> None:
    """Empty the registry, but for the counters named in ``keep``."""
    with _lock:
        for name in [name for name in _registry if name not in keep]:
            del _registry[name]


def recording() -> bool:
    """Whether a ``torch.profiler`` records (a process-wide flag)."""
    return _autograd_profiler._is_profiler_enabled


class span(contextlib.ContextDecorator):
    """A named region, as a context manager or a decorator: a user range
    under the profiler, else one call and its host seconds in the
    registry."""

    def __init__(self, name: str):
        self.name = name
        self._range = None
        self._start = 0.0

    def _recreate_cm(self):
        return type(self)(self.name)  # a decorated function may recurse or run on two threads

    def __enter__(self):
        if recording():
            self._range = _autograd_profiler.record_function(self.name)
            self._range.__enter__()
        else:
            self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        else:
            add(self.name, time.perf_counter() - self._start)
        return False


def _open_range(name: str):
    return torch.ops.profiler._record_function_enter_new(name, None)


def _close_range(handle) -> None:
    torch.ops.profiler._record_function_exit._RecordFunction(handle)


class _Marks:
    """The backward range of one block: opened once by its output's marker,
    closed when the last of its inputs' markers has run."""

    def __init__(self, name: str):
        self.name = name
        self.inputs = 0  # input markers and read hooks put in
        self.left = 0  # of them, not yet run in this backward
        self.handle = None

    def open(self) -> None:
        self.close()  # a backward run again over a kept graph
        self.left = self.inputs
        self.handle = _open_range(self.name)
        # closed here at the latest if this backward skips one of the inputs
        torch.autograd.Variable._execution_engine.queue_callback(self.close)

    def input_done(self) -> None:
        self.left -= 1
        if self.left == 0:
            self.close()

    def close(self) -> None:
        if self.handle is not None:
            _close_range(self.handle)
            self.handle = None


class _InputMark(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, marks):
        ctx.marks = marks
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.marks.input_done()
        return g, None


class _OutputMark(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, marks):
        ctx.marks = marks
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        ctx.marks.open()
        return g, None


class block(span):
    """A :class:`span` whose backward, too, lies in a range of its name:
    pass the block's inputs through :meth:`input` (activations) or
    :meth:`after` (a parameter's read: the range closes after the node that
    made ``t`` has run its backward), and its output through
    :meth:`output`. Without the profiler, or under ``no_grad``, these
    return their tensor as it is."""

    def __enter__(self):
        super().__enter__()
        self._marks = _Marks(self.name) if self._range is not None and torch.is_grad_enabled() else None
        return self

    def input(self, t: torch.Tensor) -> torch.Tensor:
        if self._marks is None or not t.requires_grad:
            return t
        self._marks.inputs += 1
        return _InputMark.apply(t, self._marks)

    def after(self, t: torch.Tensor) -> torch.Tensor:
        if self._marks is None or t.grad_fn is None:
            return t
        self._marks.inputs += 1
        marks = self._marks
        t.grad_fn.register_hook(lambda grad_inputs, grad_outputs: marks.input_done())
        return t

    def output(self, t: torch.Tensor) -> torch.Tensor:
        if self._marks is None or not self._marks.inputs or not t.requires_grad:
            return t
        return _OutputMark.apply(t, self._marks)


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` around a block (CPU and, where there is a card,
    CUDA activity); yields the profiler (``key_averages()``) and writes a
    Chrome trace, ``trace_<pid>_<time>.json``, under ``logdir`` (view in
    chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
