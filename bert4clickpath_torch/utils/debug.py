"""Debug guards: NaN/Inf checking around train steps (counterpart of
``bert4clickpath_tpu/utils/debug.py``).

Losses are guard-free by construction; these are opt-in checks for
debugging only (each adds host syncs). :func:`checked` is the counterpart
of ``checkify`` with ``float_checks``: while the wrapped function runs, a
forward hook on every module raises on the first non-finite value a
module's forward returns, and the function's outputs are checked too.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Iterator

import numpy as np
import torch


def _leaves(tree: Any, path: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) of the tensors and arrays in nested dicts, lists,
    tuples and dataclasses (paths as JAX's ``keystr``: ``['a'][0]``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, (torch.Tensor, np.ndarray, np.generic, float)):
        yield path, tree


def _finite(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return not leaf.is_floating_point() or bool(torch.isfinite(leaf.detach()).all())
    arr = np.asarray(leaf)
    return arr.dtype.kind != "f" or bool(np.isfinite(arr).all())


def checked(fn: Callable) -> Callable:
    """Wrap a function so that it RAISES (FloatingPointError) on the first
    non-finite value any module's forward returns while it runs, or that
    its outputs hold; same signature."""

    def hook(module, inputs, output):
        for path, leaf in _leaves(output):
            if not _finite(leaf):
                raise FloatingPointError(f"non-finite output of {type(module).__name__}{path}")

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        handle = torch.nn.modules.module.register_module_forward_hook(hook)
        try:
            out = fn(*args, **kwargs)
        finally:
            handle.remove()
        assert_all_finite(out, "output")
        return out

    return wrapped


def assert_all_finite(tree, name: str = "tree") -> None:
    """Host-side finite check over nested tensors or arrays (params,
    grads, a batch)."""
    for path, leaf in _leaves(tree):
        if not _finite(leaf):
            raise FloatingPointError(f"non-finite values in {name}{path}")


def finite_guard_step(train_step: Callable) -> Callable:
    """Wrap a train step ``(state, batch, *rest) -> (state, loss)``: after
    each step, verify the loss is finite and raise with the step index if
    not (one scalar fetch)."""

    def wrapped(state, batch, *rest):
        state, loss = train_step(state, batch, *rest)
        lv = torch.as_tensor(loss).detach().float().cpu()
        if not bool(torch.isfinite(lv).all()):
            raise FloatingPointError(f"non-finite loss {lv.tolist()} at step {int(state.step)}")
        return state, loss

    return wrapped
