"""Learning-rate schedules (counterpart of
``bert4clickpath_tpu/training/schedules.py``).

Each is a ``step -> float`` function, evaluated on the host in float32 as
the JAX versions evaluate in f32 on the device; the train step multiplies
the result by the state's ``lr_scale``. The Vaswani rsqrt schedule applies
its scale once (the reference's double-scale bug stays fixed).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], float]
_f32 = np.float32


def constant(lr: float) -> Schedule:
    def schedule(step: int) -> float:
        return float(_f32(lr))

    return schedule


def rsqrt_warmup(d_model: int, warmup_steps: int = 4000, scale: float = 1.0) -> Schedule:
    """lr = scale * rsqrt(d_model) * min(rsqrt(step), step * warmup^-1.5)."""

    def schedule(step: int) -> float:
        s = np.maximum(_f32(step), _f32(1.0))
        arg1 = _f32(1.0) / np.sqrt(s)
        arg2 = s * _f32(warmup_steps**-1.5)
        return float(_f32(scale) * (_f32(1.0) / np.sqrt(_f32(d_model))) * np.minimum(arg1, arg2))

    return schedule


def warmup_constant(lr: float, warmup_steps: int = 1000) -> Schedule:
    """Linear warmup to ``lr``, then constant."""

    def schedule(step: int) -> float:
        warm = np.minimum(_f32(step) / _f32(max(float(warmup_steps), 1.0)), _f32(1.0))
        return float(_f32(lr) * warm)

    return schedule


def exponential_decay_to_floor(
    initial_lr: float, floor_lr: float, decay_steps: int, decay_rate: float
) -> Schedule:
    """Decay toward a floor LR (reference CustomExponentialDecayLR)."""

    def schedule(step: int) -> float:
        p = np.power(_f32(decay_rate), _f32(step) / _f32(decay_steps))
        return float(_f32(initial_lr - floor_lr) * p + _f32(floor_lr))

    return schedule


def from_config(cfg, d_model: int) -> Schedule:
    """Build a schedule from a TrainConfig."""
    if cfg.lr_schedule == "constant":
        return constant(cfg.learning_rate)
    if cfg.lr_schedule == "rsqrt_warmup":
        return rsqrt_warmup(d_model, cfg.warmup_steps, scale=1.0)
    if cfg.lr_schedule == "warmup_constant":
        return warmup_constant(cfg.learning_rate, cfg.warmup_steps)
    if cfg.lr_schedule == "exp_decay":
        return exponential_decay_to_floor(
            cfg.learning_rate, cfg.learning_rate * 0.01, cfg.steps_per_epoch, 0.9
        )
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
