"""Training checkpoints, warm starts and the self-contained serving export
(counterpart of ``bert4clickpath_tpu/training/checkpoint.py``).

1. :func:`save_checkpoint` writes a full ``TrainState`` (parameters, Adam
   moments in their dtypes, Adam's count, ``step``, ``lr_scale``, the EMA
   shadow) as ``directory/step_<N>/state.pt`` with ``torch.save``. The
   save is synchronous: it is written under a temporary name and renamed,
   so a ``step_<N>`` directory is always a committed checkpoint, and older
   checkpoints are pruned (``keep``) only after the new one is committed.
   (The JAX package prunes before its asynchronous save lands; a save that
   then fails can leave fewer checkpoints than ``keep``. Not copied.)
2. :func:`export_serving`: a bundle holds the same ``model_config.json``,
   ``vocab_<name>.json`` and ``MANIFEST.json`` that the JAX package writes,
   so one config and one set of vocab artifacts serve both packages, plus
   ``params.pt``: the port's state_dict in place of the orbax ``params/``
   directory.
3. :func:`restore_params` (full) and :func:`restore_encoder` (encoder,
   embeddings and positions only; the head stays freshly initialised) warm-
   start from a ``params.pt`` written by :func:`save_params` or
   :func:`export_serving`.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Mapping, Optional

import torch

from bert4clickpath_torch.config import ModelConfig

PARAMS_FILE = "params.pt"
STATE_FILE = "state.pt"
_STEP_DIR = re.compile(r"step_(\d+)")


def _host(tensors: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu").contiguous() for k, v in tensors.items()}


def _committed(directory: str) -> list[tuple[int, str]]:
    """(step, name) of the committed ``step_<N>`` checkpoints, oldest first."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        (int(m.group(1)), name) for name in os.listdir(directory) if (m := _STEP_DIR.fullmatch(name))
    )


def save_checkpoint(
    directory: str, state: Any, step: int, block: bool = True, keep: Optional[int] = None,
) -> str:
    """Save a full TrainState under ``directory/step_<N>``; returns the path.

    keep: retain at most this many checkpoints in ``directory`` including
    the one being saved (None / 0: keep everything). The oldest are deleted
    after the new one is committed. ``block`` is accepted for the JAX
    signature's sake: the save always completes before the call returns.
    """
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step:08d}")
    payload = {
        "format": 1,
        "step": int(state.step),
        "lr_scale": state.lr_scale.detach().to("cpu"),
        "params": _host(state.params),
        "opt_state": {
            "count": int(state.opt_state.count),
            "mu": _host(state.opt_state.mu),
            "nu": _host(state.opt_state.nu),
        },
        "ema_params": None if state.ema_params is None else _host(state.ema_params),
    }
    work = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp-", dir=directory)
    try:
        torch.save(payload, os.path.join(work, STATE_FILE))
        aside = None
        if os.path.isdir(path):  # the same step saved again: the old one steps aside
            aside = f"{path}.old-{os.getpid()}"
            os.rename(path, aside)
        try:
            os.rename(work, path)
        except BaseException:
            if aside is not None:
                os.rename(aside, path)
            raise
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise
    if aside is not None:
        shutil.rmtree(aside, ignore_errors=True)
    if keep:
        prune_checkpoints(directory, keep)
    return path


def prune_checkpoints(directory: str, keep: int) -> list[str]:
    """Delete the oldest committed ``step_*`` checkpoints, keeping the
    newest ``keep``. Returns the removed paths."""
    directory = os.path.abspath(directory)
    steps = _committed(directory)
    removed = []
    for _, name in steps[: max(len(steps) - keep, 0)]:
        p = os.path.join(directory, name)
        shutil.rmtree(p, ignore_errors=True)
        removed.append(p)
    return removed


def wait_until_finished() -> None:
    """Nothing to wait for: saves are synchronous. Kept so that a trainer
    reads the same in both packages."""


def latest_checkpoint(directory: str) -> Optional[str]:
    directory = os.path.abspath(directory)
    steps = _committed(directory)
    return os.path.join(directory, steps[-1][1]) if steps else None


def _fill(into: Mapping[str, torch.Tensor], saved: Mapping[str, torch.Tensor], what: str) -> None:
    if set(into) != set(saved):
        raise KeyError(f"checkpoint {what} do not match the state's: {sorted(set(into) ^ set(saved))}")
    with torch.no_grad():
        for k, t in into.items():
            if tuple(t.shape) != tuple(saved[k].shape) or t.dtype != saved[k].dtype:
                raise ValueError(
                    f"checkpoint {what} {k!r}: {tuple(saved[k].shape)} {saved[k].dtype} "
                    f"!= {tuple(t.shape)} {t.dtype}"
                )
            t.copy_(saved[k])


def restore_state(path: str, state: Any) -> Any:
    """Restore a TrainState saved by :func:`save_checkpoint` into ``state``
    (a freshly created one of the same model, optimizer and EMA setting):
    its tensors, which are the model's parameters, are filled in place, and
    a state carrying the saved ``step``, Adam count and ``lr_scale`` is
    returned."""
    saved = torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location="cpu", weights_only=True)
    if (saved["ema_params"] is None) != (state.ema_params is None):
        raise ValueError("the checkpoint and the run differ in their EMA setting")
    _fill(state.params, saved["params"], "params")
    _fill(state.opt_state.mu, saved["opt_state"]["mu"], "Adam first moments")
    _fill(state.opt_state.nu, saved["opt_state"]["nu"], "Adam second moments")
    if state.ema_params is not None:
        _fill(state.ema_params, saved["ema_params"], "EMA params")
    with torch.no_grad():
        state.lr_scale.copy_(saved["lr_scale"])
    opt_state = type(state.opt_state)(saved["opt_state"]["count"], state.opt_state.mu, state.opt_state.nu)
    return state.replace(step=saved["step"], opt_state=opt_state)


def save_params(path: str, params: Mapping[str, torch.Tensor]) -> None:
    """Parameters alone (a state_dict on the host), for a warm start."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(_host(params), path)


def _params_path(path: str) -> str:
    path = os.path.abspath(path)
    return os.path.join(path, PARAMS_FILE) if os.path.isdir(path) else path


def _load_params(path: str, like: Mapping[str, torch.Tensor], exact: bool) -> dict[str, torch.Tensor]:
    """The saved parameters named in ``like``, each on its namesake's device;
    raises on a missing name, a shape that differs and, if ``exact``, on a
    saved name that ``like`` lacks."""
    saved = torch.load(_params_path(path), map_location="cpu", weights_only=True)
    wrong = set(like) - set(saved) | (set(saved) - set(like) if exact else set())
    if wrong:
        raise KeyError(f"saved params do not match: {sorted(wrong)}")
    for k, t in like.items():
        if tuple(saved[k].shape) != tuple(t.shape):
            raise ValueError(f"saved param {k!r}: {tuple(saved[k].shape)} != {tuple(t.shape)}")
    return {k: saved[k].to(t.device) for k, t in like.items()}


def restore_params(path: str, like: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The parameters saved at ``path`` (a file of :func:`save_params`, or an
    export bundle's directory), each on the device of its namesake in
    ``like``; raises unless names and shapes match ``like``."""
    return _load_params(path, like, exact=True)


def is_transferred(key: str) -> bool:
    """Whether transfer learning restores this parameter: the encoder, the
    embedding tables and the learned positions."""
    return key.startswith(("encoder.", "embed_", "positions."))


def restore_encoder(path: str, init_params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Transfer learning: the encoder and embedding parameters from ``path``,
    everything else (the new head) as freshly initialised in
    ``init_params``. The pretrained encoder and embeddings can be reused
    under a different head."""
    subset = {k: t for k, t in init_params.items() if is_transferred(k)}
    restored = _load_params(path, subset, exact=False)
    return {k: restored.get(k, t) for k, t in init_params.items()}


def export_serving(
    directory: str,
    state_dict: Mapping[str, torch.Tensor],
    model_config: ModelConfig,
    vocabs: dict[str, Any],
) -> str:
    """Bundle everything needed to serve from strings: params + config +
    vocab artifacts."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "model_config.json"), "w") as f:
        f.write(model_config.to_json())
    for name, vocab in vocabs.items():
        vocab.save_artifact(directory, name)
    torch.save(_host(state_dict), os.path.join(directory, PARAMS_FILE))
    with open(os.path.join(directory, "MANIFEST.json"), "w") as f:
        json.dump({"vocabs": sorted(vocabs), "format": 1}, f)
    return directory


def load_serving_params(directory: str, device) -> dict[str, torch.Tensor]:
    """The state_dict of a bundle written by :func:`export_serving`, on ``device``."""
    path = os.path.join(os.path.abspath(directory), PARAMS_FILE)
    return torch.load(path, map_location=device, weights_only=True)
