"""Fused inverted dropout with an in-kernel generator: no mask in memory.

Counterpart of ``bert4clickpath_tpu/ops/pallas/dropout.py:fused_dropout``:
an element is kept iff its 32 random bits exceed
``threshold = min(int(rate * 2**32), 2**32 - 1)``; a kept element is
``(x.float() * (1 / (1 - rate))).to(x.dtype)``, a dropped one 0; the same
seed gives the same mask, and the backward is the forward on the output
gradient with the same seed, so the mask is regenerated, never stored.

The TPU core's generator cannot be reproduced, so the bits differ from the
JAX package's (as its own CPU fallback's do). Here they come from
Philox-4x32-10 with key (seed, 0) and counter (e // 4, 0, 0, 0) for the
flat element index e, whose word e % 4 is the element's: the mask depends
on (seed, element) only, not on how a launch is cut. The CUDA kernel is
``bert4clickpath_torch/csrc/dropout.cu``; :func:`fused_dropout_reference`
is its plain PyTorch version, the same Philox in int64 tensor ops, so the
two agree bit for bit. The plain version is slow (tens of tensor ops per
call) and is what CPU tensors take.

The seed is a one-element int32 tensor on x's device (the kernel reads it
there, so the host never waits for it); an int is accepted and copied.
"""

from __future__ import annotations

import torch

from bert4clickpath_torch.ops.kernels import _build

_DTYPES = (torch.bfloat16, torch.float32)
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of m * x for a 32-bit constant m and int64
    x in [0, 2**32). The 64-bit product would overflow a signed int64, so x
    is split into 16-bit halves: m * x = a + (b << 16) with a, b < 2**48."""
    a = m * (x & 0xFFFF)
    b = m * (x >> 16)
    low = (a + ((b & 0xFFFF) << 16)) & _MASK32
    high = ((a >> 16) + b) >> 16
    return high, low


def philox4x32_10(
    counter: tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
    key: tuple[torch.Tensor, torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Philox-4x32 with 10 rounds (Salmon et al., Random123) on int64
    tensors that hold 32-bit words; returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def dropout_bits(seed: torch.Tensor, n: int) -> torch.Tensor:
    """The n elements' random words as int64 in [0, 2**32): element e gets
    word e % 4 of Philox(counter=(e // 4, 0, 0, 0), key=(seed, 0))."""
    ctr = torch.arange((n + 3) // 4, dtype=torch.int64, device=seed.device)
    zero = torch.zeros_like(ctr)
    key = seed.reshape(()).to(torch.int64) & _MASK32  # the int32's bit pattern
    words = philox4x32_10((ctr & _MASK32, ctr >> 32, zero, zero), (key, torch.zeros_like(key)))
    return torch.stack(words, dim=1).reshape(-1)[:n]


def _threshold(rate: float) -> int:
    return min(int(rate * 4294967296.0), 4294967295)


def fused_dropout_reference(x: torch.Tensor, seed: torch.Tensor, rate: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same bits, the same
    roundings (an f32 product by the f32 1 / (1 - rate), rounded once)."""
    keep = (dropout_bits(seed, x.numel()) > _threshold(rate)).reshape(x.shape)
    inv_keep = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32, device=x.device)
    return torch.where(keep, (x.float() * inv_keep).to(x.dtype), torch.zeros((), dtype=x.dtype, device=x.device))


def _launch(x, seed, rate):
    x = x.contiguous()
    out = torch.empty_like(x)
    aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    lib = _build.library()
    with torch.cuda.device(x.device):
        code = lib.b4cp_dropout(
            x.data_ptr(), seed.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16),
            x.numel(), _threshold(rate), 1.0 / (1.0 - rate), int(aligned),
            x.device.index, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "fused_dropout")
    _build.count("dropout")
    return out


def _apply(x, seed, rate):
    if x.device.type == "cpu":
        return fused_dropout_reference(x, seed, rate)
    return _launch(x, seed, rate)


class _FusedDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, rate):
        ctx.save_for_backward(seed)
        ctx.rate = rate
        return _apply(x, seed, rate)

    @staticmethod
    def backward(ctx, g):
        # the same seed gives the same mask; dropout is linear in x. Out of
        # place: autograd may still hold g
        (seed,) = ctx.saved_tensors
        return _apply(g, seed, ctx.rate), None, None


def fused_dropout(x: torch.Tensor, seed, rate: float) -> torch.Tensor:
    """Inverted dropout of x (any shape, bf16 or f32) at ``rate`` in [0, 1),
    differentiable in x; ``rate <= 0`` returns x itself. ``seed``: a
    one-element int32 tensor on x's device, or an int. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if rate <= 0.0:
        return x
    if not rate < 1.0:
        raise ValueError(f"rate must be below 1, got {rate}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if not isinstance(seed, torch.Tensor):
        seed = torch.tensor([seed], dtype=torch.int32, device=x.device)
    if seed.dtype != torch.int32 or seed.numel() != 1 or seed.device != x.device:
        raise ValueError(
            f"seed must be one int32 on {x.device}, got {tuple(seed.shape)} {seed.dtype} on {seed.device}"
        )
    return _FusedDropout.apply(x, seed, rate)
