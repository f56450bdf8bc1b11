"""The program's train step as the harness drives it.

An entry (``portbench/entries/<entry>.py``) builds a :class:`Session` with
the program's own factories: its model, its train state, its step function
and its feed. The harness only calls :meth:`next` (the feed) and
:meth:`step` (the program's step), reads the state after the checked steps,
and never looks inside otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

import numpy as np
import torch


def put(array: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def views(tensors: dict, layout: dict) -> dict:
    """Tensors keyed by the program's names, seen by the reference's."""
    return {ref: tensors[prog] if rows is None else tensors[prog][rows] for ref, (prog, rows) in layout.items()}


@dataclass
class Session:
    model: object
    state: object  # the program's TrainState: params, opt_state (mu, nu), step
    step_fn: Callable
    generator: Optional[torch.Generator]
    device: torch.device
    batch_size: int
    feed: Iterator  # yields (device batch, host-side batch_stats)
    layout: dict  # reference name -> (program name, rows or None)
    _teardown: Optional[Callable] = None
    stats: list = field(default_factory=list)  # batch_stats of every batch taken, in order

    def next(self):
        batch, stats = next(self.feed)
        self.stats.append(stats)
        return batch

    def step(self, batch) -> torch.Tensor:
        self.state, loss = self.step_fn(self.state, batch, self.generator)
        return loss

    @property
    def params(self) -> dict:
        """The program's parameters, by the reference's names."""
        return views(self.state.params, self.layout)

    def first_moments(self) -> dict:
        """Adam's first moments, by the reference's names."""
        return views(self.state.opt_state.mu, self.layout)

    def second_moments(self) -> dict:
        """Adam's second moments, by the reference's names."""
        return views(self.state.opt_state.nu, self.layout)

    def close(self) -> None:
        self.model = self.state = self.step_fn = self.feed = None
        if self._teardown is not None:
            self._teardown()
