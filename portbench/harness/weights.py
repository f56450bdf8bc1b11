"""Seeds and weights drawn on the device from a run's ``--seed``.

Every stream of a run (weights, traffic, dropout, batch order) comes from
:func:`mix` of the seed and a stream number, so the same seed gives the same
run and any seed up to 64 bits is taken whole.

The weights follow the reference's list of parameters
(``reference/model.py:param_specs``): tables N(0, ``table_std``^2), dense
weights N(0, 1 / fan_in), biases 0, LayerNorm scales 1. All dense weights
come from one draw of a ``torch.Generator`` on the device, and each table in
blocks of ``TABLE_BLOCK_ROWS`` rows with a generator of its own, so a block
can be drawn again alone (the change of the table after the checked steps
is measured block by block, without a second copy of the table).
"""

from __future__ import annotations

import math

import torch

TABLE_BLOCK_ROWS = 1 << 21
_M63 = (1 << 63) - 1

# stream numbers of :func:`mix`
WEIGHTS, DROPOUT, TRAFFIC, BATCHES, SAMPLE = 1, 2, 3, 4, 5


def mix(seed: int, stream: int) -> int:
    """A 63-bit seed for ``stream`` of a run seeded with ``seed``."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(stream) * 0xBF58476D1CE4E5B9 + 0x94D049BB133111EB) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & _M63


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


def dense_weights(specs, seed: int, device) -> dict:
    """Every ``dense`` leaf, from one draw."""
    dense = [(n, s) for n, s, kind in specs if kind == "dense"]
    total = sum(math.prod(s) for _, s in dense)
    flat = torch.randn(total, generator=_generator(device, mix(seed, WEIGHTS)), device=device)
    out, at = {}, 0
    for name, shape in dense:
        size = math.prod(shape)
        out[name] = flat[at : at + size].view(shape).mul_(1.0 / math.sqrt(shape[1]))
        at += size
    return out


def table_block(name: str, shape, index: int, seed: int, std: float, device) -> torch.Tensor:
    """Rows ``[index * TABLE_BLOCK_ROWS, ...)`` of table ``name``."""
    start = index * TABLE_BLOCK_ROWS
    rows = min(TABLE_BLOCK_ROWS, shape[0] - start)
    stream = mix(mix(seed, WEIGHTS), hash_name(name) + index)
    block = torch.randn((rows, shape[1]), generator=_generator(device, stream), device=device)
    return block.mul_(std)


def table_blocks(shape) -> int:
    return -(-shape[0] // TABLE_BLOCK_ROWS)


def hash_name(name: str) -> int:
    """A stable (run to run) number for a leaf name."""
    h = 1469598103934665603
    for ch in name.encode():
        h = ((h ^ ch) * 1099511628211) & _M63
    return h


@torch.no_grad()
def fill(params: dict, specs, seed: int, table_std: float) -> None:
    """Write the run's weights into ``params`` (name -> tensor, in place)."""
    names = {n for n, _, _ in specs}
    if set(params) != names:
        raise KeyError(f"parameters differ from the reference's: {sorted(set(params) ^ names)}")
    device = next(iter(params.values())).device
    for name, w in dense_weights(specs, seed, device).items():
        params[name].copy_(w)
    for name, shape, kind in specs:
        p = params[name]
        if tuple(p.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(p.shape)}, the reference has {tuple(shape)}")
        if kind == "zeros":
            p.zero_()
        elif kind == "ones":
            p.fill_(1.0)
        elif kind == "table":
            for i in range(table_blocks(shape)):
                start = i * TABLE_BLOCK_ROWS
                block = table_block(name, shape, i, seed, table_std, device)
                p[start : start + block.shape[0]].copy_(block)
                del block


def draw(specs, seed: int, table_std: float, device) -> dict:
    """The run's weights as new float32 tensors."""
    params = {n: torch.empty(s, device=device) for n, s, _ in specs}
    fill(params, specs, seed, table_std)
    return params


@torch.no_grad()
def change_norms(params: dict, specs, seed: int, table_std: float) -> dict:
    """name -> ||p - p0||, p0 the run's initial weights drawn again."""
    device = next(iter(params.values())).device
    dense = dense_weights(specs, seed, device)
    out = {}
    for name, shape, kind in specs:
        p = params[name].float()
        if kind == "dense":
            out[name] = float(torch.linalg.vector_norm(p - dense[name]))
        elif kind == "zeros":
            out[name] = float(torch.linalg.vector_norm(p))
        elif kind == "ones":
            out[name] = float(torch.linalg.vector_norm(p - 1.0))
        else:
            total = 0.0
            for i in range(table_blocks(shape)):
                start = i * TABLE_BLOCK_ROWS
                block = table_block(name, shape, i, seed, table_std, device)
                total += float(torch.linalg.vector_norm(p[start : start + block.shape[0]] - block)) ** 2
                del block
            out[name] = math.sqrt(total)
    return out
