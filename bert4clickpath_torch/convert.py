"""Move weights between the JAX package's flax params and the port's
state_dict, both ways.

The port's modules carry the flax tree's names, so the mapping is by path:
``encoder/layer_0/mha/wqkv/kernel`` becomes ``encoder.layer_0.mha.wqkv.weight``.
Leaf names change as flax and torch name them:

* Dense ``kernel`` (in, out) -> ``weight`` (out, in), transposed;
* LayerNorm ``scale`` -> ``weight``;
* Embed ``embedding`` -> ``weight`` (the learned ``positions/embedding``
  keeps its name);
* ``bias`` and ``tied_out_bias`` keep theirs.

The flax side is the nested dict of numpy arrays that
``jax.device_get(params)`` returns; nothing here imports jax.
:func:`flax_from_state_dict` is the inverse, for any tree shaped like the
params (gradients, Adam moments), so tests can hold the port's training
state to the JAX package's. :func:`train_state_from_flax` carries a whole
JAX ``TrainState`` (params, optax Adam's moments and count, ``step``,
``lr_scale``, the EMA shadow) across, so that a trainer or a resumed run
starts from the same state in both packages.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch

from bert4clickpath_torch.config import ModelConfig
from bert4clickpath_torch.models.encoder import Dense, LayerNorm
from bert4clickpath_torch.models.model import ClickstreamModel
from bert4clickpath_torch.training.train_state import AdamState, TrainState


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
        if arr.dtype.name == "bfloat16":  # no numpy dtype of torch's: widen, then narrow exactly
            t = torch.from_numpy(np.array(arr, dtype=np.float32, order="C")).to(torch.bfloat16)
        else:
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


def _flax_leaf(module, leaf: str) -> tuple[str, bool]:
    """The flax leaf name of a port parameter, and whether to transpose."""
    if leaf == "weight":
        if isinstance(module, Dense):
            return "kernel", True
        if isinstance(module, LayerNorm):
            return "scale", False
        if isinstance(module, torch.nn.Embedding):
            return "embedding", False
        raise KeyError(f"no flax counterpart for a weight of {type(module).__name__}")
    return leaf, False


def flax_from_state_dict(config: ModelConfig, tensors: dict[str, torch.Tensor]) -> dict:
    """The port's state_dict (or any dict keyed like it: grads, Adam
    moments) -> ``{"params": nested dict of float32 numpy arrays}`` in the
    flax layout; bf16 leaves are widened to f32 exactly. Raises on a key
    the port's model does not have."""
    modules = dict(ClickstreamModel(config, device="meta").named_modules())
    out: dict = {}
    for key, t in tensors.items():
        *mods, leaf = key.split(".")
        module = modules.get(".".join(mods))
        if module is None:
            raise KeyError(f"{key!r} is not a parameter of the port's model")
        name, transpose = _flax_leaf(module, leaf)
        arr = t.detach().float().cpu().numpy()
        node = out
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(arr.T if transpose else arr)
    return {"params": out}


def train_state_from_flax(model: ClickstreamModel, state: Any) -> TrainState:
    """``jax.device_get`` of the JAX package's ``TrainState`` -> the port's,
    for ``model`` and on its device. The params are loaded into the model
    (``state.params`` of the result are the model's own parameters); optax
    Adam's ``mu`` and ``nu`` keep their dtypes (a bf16 first moment stays
    bf16); ``count``, ``step`` and ``lr_scale`` carry over; the EMA shadow
    too where the JAX state has one."""
    cfg = model.config
    device = next(model.parameters()).device
    on_device = lambda tree: {k: v.to(device) for k, v in state_dict_from_flax(cfg, tree).items()}  # noqa: E731
    adam = next(s for s in state.opt_state if hasattr(s, "mu") and hasattr(s, "nu"))
    model.load_state_dict(state_dict_from_flax(cfg, state.params))
    return TrainState(
        step=int(state.step),
        params=dict(model.named_parameters()),
        opt_state=AdamState(int(adam.count), on_device(adam.mu), on_device(adam.nu)),
        lr_scale=torch.tensor(float(state.lr_scale), dtype=torch.float32, device=device),
        ema_params=None if state.ema_params is None else on_device(state.ema_params),
    )
