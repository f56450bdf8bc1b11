"""A reference per configuration, and weights of any rank, move nothing
of the two BERT4Rec configurations: for a fixed seed at tiny sizes they
draw the weights the former rule drew (every dense leaf scaled by its second
axis) bit for bit, and their FLOPs are the former count's."""

from __future__ import annotations

import math

import pytest
import torch

from conftest import tiny_cell
from portbench.harness import manifest
from portbench.harness import weights as weights_lib

SEED = 2**50 + 123
CONFIGS = ("large_catalog.full_ce", "flagship.train_b8192")


def former_dense(specs, seed: int) -> dict:
    """The draw of every dense leaf as it was: one flat draw, each leaf
    multiplied by 1 / sqrt(shape[1])."""
    dense = [(n, s) for n, s, kind in specs if kind == "dense"]
    total = sum(math.prod(s) for _, s in dense)
    flat = torch.randn(total, generator=torch.Generator().manual_seed(weights_lib.mix(seed, weights_lib.WEIGHTS)))
    out, at = {}, 0
    for name, shape in dense:
        size = math.prod(shape)
        out[name] = flat[at : at + size].view(shape).mul_(1.0 / math.sqrt(shape[1]))
        at += size
    return out


def former_flops(cfg: dict, stats: dict) -> float:
    """The former ``harness/work.py:model_flops``."""
    d, f = cfg["d_model"], cfg["ffn_dim"]
    dense = 2.0 * stats["tokens"] * (4 * d * d + 2 * d * f)
    attention = 4.0 * stats["tokens_sq"] * d
    head = 2.0 * stats["labelled"] * cfg["n_items"] * cfg["d_model"]
    return 3.0 * (cfg["num_layers"] * (dense + attention) + head)


@pytest.mark.parametrize("cell", CONFIGS)
def test_the_weights_are_the_former_draws_bit_for_bit(cell):
    cfg = tiny_cell(cell).config
    specs = manifest.reference(cfg).param_specs(cfg)
    drawn = weights_lib.draw(specs, SEED, cfg["init"]["table_std"], torch.device("cpu"))
    former = former_dense(specs, SEED)
    assert former and all(torch.equal(drawn[n], w) for n, w in former.items())
    table = weights_lib.table_block("embed_items.weight", (cfg["table_rows"], cfg["d_model"]), 0, SEED,
                                    cfg["init"]["table_std"], torch.device("cpu"))
    assert torch.equal(drawn["embed_items.weight"][: table.shape[0]], table)


@pytest.mark.parametrize("stats", [
    {"labelled": 2100, "tokens": 7_040, "tokens_sq": 226_304, "batch": 256, "length": 53},
    {"labelled": 22_211, "tokens": 88_474, "tokens_sq": 1_331_102, "batch": 8192, "length": 53},
    {"labelled": 1, "tokens": 3, "tokens_sq": 9, "batch": 1, "length": 53},
])
@pytest.mark.parametrize("cell", CONFIGS)
def test_the_flops_are_the_former_count(cell, stats):
    cfg = manifest.cell(cell).config
    assert manifest.reference(cfg).model_flops(cfg, stats) == former_flops(cfg, stats)
