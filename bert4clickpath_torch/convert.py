"""Move weights from the JAX package's flax params to the port's state_dict.

The port's modules carry the flax tree's names, so the mapping is by path:
``encoder/layer_0/mha/wqkv/kernel`` becomes ``encoder.layer_0.mha.wqkv.weight``.
Leaf names change as flax and torch name them:

* Dense ``kernel`` (in, out) -> ``weight`` (out, in), transposed;
* LayerNorm ``scale`` -> ``weight``;
* Embed ``embedding`` -> ``weight`` (the learned ``positions/embedding``
  keeps its name);
* ``bias`` and ``tied_out_bias`` keep theirs.

The input is the nested dict of numpy arrays that ``jax.device_get(params)``
returns; nothing here imports jax.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch

from bert4clickpath_torch.config import ModelConfig
from bert4clickpath_torch.models.model import ClickstreamModel


def _flatten(tree: Any, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def _torch_key(path: tuple) -> tuple[str, bool]:
    """flax path -> (state_dict key, transpose?)."""
    *mods, leaf = path
    if leaf == "kernel":
        return ".".join(mods + ["weight"]), True
    if leaf == "scale" or (leaf == "embedding" and mods != ["positions"]):
        return ".".join(mods + ["weight"]), False
    return ".".join(path), False


def state_dict_from_flax(config: ModelConfig, params: Any) -> dict[str, torch.Tensor]:
    """flax params (``{"params": {...}}`` or the inner dict) -> the port's
    state_dict for ``ClickstreamModel(config, device)``.

    Raises on a flax leaf with no counterpart in the port, on a shape that
    does not match, and on any port parameter left unfilled.
    """
    tree = params["params"] if "params" in params else params
    expected = {
        k: tuple(v.shape)
        for k, v in ClickstreamModel(config, device="meta").state_dict().items()
    }
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree):
        key, transpose = _torch_key(path)
        if key not in expected:
            raise KeyError(f"flax param {'/'.join(path)!r} has no counterpart in the port ({key!r})")
        arr = np.asarray(leaf)
        if transpose:
            arr = arr.T
        t = torch.from_numpy(np.array(arr, copy=True, order="C"))
        if tuple(t.shape) != expected[key]:
            raise ValueError(
                f"flax param {'/'.join(path)!r}: shape {tuple(t.shape)} != port {key!r} {expected[key]}"
            )
        out[key] = t
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"port parameters left unfilled by the flax params: {missing}")
    return out
