"""Shared pieces of the benchmark's tests: the cells cut to a size the CPU
runs in a second (widths, catalog and traffic; the code path is the cell's),
and the fixture that decides whether there is a card."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = ("large_catalog.full_ce", "flagship.train_b8192", "large_catalog.sampled")


def tiny_cell(name: str, dtype: str = "bfloat16"):
    from portbench.harness import manifest

    cell = manifest.cell(name, ROOT)
    cfg = dict(cell.config, d_model=16, num_heads=2, ffn_dim=32, dtype=dtype)
    if cfg["n_items"] > 100_000:
        cfg.update(n_items=5000, table_rows=5120)
        cell.traffic = dict(cell.traffic, batch=8, pool=4)
        if "negatives" in cell.traffic:
            cell.traffic["negatives"] = 64
    else:
        cfg.update(n_items=300, table_rows=384, num_layers=2)
        cell.traffic = dict(cell.traffic, sessions=200, batch=16)
    cell.config = cfg
    return cell


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
