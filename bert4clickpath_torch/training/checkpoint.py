"""Self-contained serving export (counterpart of the export half of
``bert4clickpath_tpu/training/checkpoint.py``).

A bundle holds the same ``model_config.json``, ``vocab_<name>.json`` and
``MANIFEST.json`` that the JAX package writes, so one config and one set of
vocab artifacts serve both packages, plus ``params.pt``: the port's
state_dict, written with ``torch.save``, in place of the orbax ``params/``
directory. Training checkpoints come with the trainer slice.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import torch

from bert4clickpath_torch.config import ModelConfig

PARAMS_FILE = "params.pt"


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
    params = {k: v.detach().to("cpu").contiguous() for k, v in state_dict.items()}
    torch.save(params, os.path.join(directory, PARAMS_FILE))
    with open(os.path.join(directory, "MANIFEST.json"), "w") as f:
        json.dump({"vocabs": sorted(vocabs), "format": 1}, f)
    return directory


def load_serving_params(directory: str, device) -> dict[str, torch.Tensor]:
    """The state_dict of a bundle written by :func:`export_serving`, on ``device``."""
    path = os.path.join(os.path.abspath(directory), PARAMS_FILE)
    return torch.load(path, map_location=device, weights_only=True)
