"""Adam over every parameter in one in-place pass (``csrc/adam.cu``).

It replaces no Pallas kernel: the JAX package leaves optax's chain to
XLA's fusion. Its plain version is ``training/train_state.py:Adam.update``
followed by ``p.add_(u * lr)``, which ``Adam.apply`` takes for tensors on
the CPU; the kernel gives the same bits on the card, each operation rounded
as PyTorch rounds it there (the constants below are the f32 scalars the
plain path's kernels use: a tensor divided by a host float is a product
with the float's f32 reciprocal).

:func:`adam_step` updates p, mu and nu in place for a list of tensors: one
launch for up to ``capacity()`` tensors, on the current stream, with no
host sync (``lr_scale`` is read on the device). Each launch adds one to the
launch counter ``kernels.adam`` and the tensors it updated to
``kernels.adam.tensors`` (``utils/profiling.py:counters``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from bert4clickpath_torch.ops.kernels import _build
from bert4clickpath_torch.utils import profiling

TENSORS_COUNTER = "kernels.adam.tensors"
_MU_DTYPES = (torch.float32, torch.bfloat16)


def capacity() -> int:
    """The tensors one launch takes (the kernel's parameter struct)."""
    return _build.library().b4cp_adam_capacity()


def _check(params, grads, mus, nus, decays, lr_scale) -> torch.device:
    """The device of a list the kernel takes; raises on anything else."""
    n = len(params)
    if not (len(grads) == len(mus) == len(nus) == len(decays) == n):
        raise ValueError("params, grads, mus, nus and decays must have one entry per tensor")
    if lr_scale.dtype != torch.float32 or lr_scale.numel() != 1:
        raise ValueError(f"lr_scale must be one float32, got {tuple(lr_scale.shape)} {lr_scale.dtype}")
    mu_dtype = mus[0].dtype if n else torch.float32
    if mu_dtype not in _MU_DTYPES:
        raise ValueError(f"mu must be float32 or bfloat16, got {mu_dtype}")
    device = lr_scale.device
    for i, (p, g, mu, nu) in enumerate(zip(params, grads, mus, nus)):
        for what, t, dtype in (("param", p, torch.float32), ("grad", g, torch.float32),
                               ("mu", mu, mu_dtype), ("nu", nu, torch.float32)):
            if t.dtype != dtype:
                raise ValueError(f"tensor {i}: {what} must be {dtype}, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"tensor {i}: {what} must be contiguous")
            if t.shape != p.shape:
                raise ValueError(f"tensor {i}: {what} has shape {tuple(t.shape)}, param {tuple(p.shape)}")
            if t.device != device:
                raise ValueError(f"tensor {i}: {what} is on {t.device}, lr_scale on {device}")
    if device.type != "cuda":
        raise ValueError(f"the Adam kernel runs on a CUDA device, not {device}")
    return device


def adam_step(
    params: list, grads: list, mus: list, nus: list, decays: list, *,
    b1: float, b1_mu: float, b2: float, eps: float, bc1: float, bc2: float, weight_decay: float,
    lr: float, lr_scale: torch.Tensor,
) -> None:
    """One Adam step in place over lists of tensors on one CUDA device.

    params, grads, nus: f32; mus: all f32 or all bf16; all contiguous.
    ``b1_mu``: b1 as mu's dtype holds it; ``bc1``, ``bc2``: the bias
    corrections 1 - b^count in f32; ``decays[i]``: whether tensor i takes
    ``weight_decay * p``; the learning rate is ``f32(lr) * lr_scale``.
    Raises on a tensor the kernel does not take."""
    device = _check(params, grads, mus, nus, decays, lr_scale)
    if not params:
        return
    f32 = np.float32
    consts = [
        float(f32(1 - b1)), float(f32(b1_mu)), float(f32(1 - b2)), float(f32(b2)),
        float(f32(1) / f32(bc1)), float(f32(1) / f32(bc2)), float(f32(eps)),
        float(f32(weight_decay)), float(f32(lr)),
    ]
    mu_is_bf16 = int(mus[0].dtype == torch.bfloat16)
    rows = np.array(
        [(p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), p.numel(), int(bool(d)))
         for p, g, mu, nu, d in zip(params, grads, mus, nus, decays)],
        dtype=np.int64,
    )
    lib = _build.library()
    per_launch = capacity()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for start in range(0, len(params), per_launch):
            part = np.ascontiguousarray(rows[start : start + per_launch])
            code = lib.b4cp_adam(
                part.ctypes.data_as(ctypes.c_void_p), len(part), mu_is_bf16, *consts,
                lr_scale.data_ptr(), device.index, stream,
            )
            _build.check(code, "adam_step")
            _build.count("adam")
            profiling.add(TENSORS_COUNTER, calls=len(part))
    for p in params:
        torch.autograd.graph.increment_version(p)
