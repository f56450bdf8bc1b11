"""The plain reference against the program's CPU path (its kernels' plain
versions) at tiny sizes, and what the reference may import."""

from __future__ import annotations

import ast

import numpy as np
import pytest
import torch

from conftest import CELLS, ROOT, tiny_cell
from portbench.harness import check
from portbench.runners import train


@pytest.mark.parametrize("cell", CELLS)
def test_reference_follows_the_program_in_float32(cell):
    torch.manual_seed(0)
    c = tiny_cell(cell, dtype="float32")
    seed = 2**45 + 17
    session, traffic, seeds = train.build_session(c, seed, torch.device("cpu"))
    batches = check.reference_batches(traffic, c.config, seeds)
    rows = check.kept_rows(c.config, seed, lambda: batches)
    ours = check.program_steps(session, c.config, seed, rows)
    session.close()
    theirs, rms = check.reference_steps(c.config, batches, seed, seeds, torch.device("cpu"), rows)
    numbers, where = check.compare(ours, theirs, rms)
    # the same float32 arithmetic but for the order of sums; where the first
    # moment is bfloat16, the gradient read from it carries its rounding (at
    # most 2^-8 of each element) and the change carries it once a step (the
    # program also scales it by bf16(0.9), as the JAX package does)
    mu_rounding = 2.0**-8 if c.config["optimizer"]["mu_dtype"] == "bfloat16" else 1e-4
    assert max(where["steps"]) < 1e-6, where
    assert numbers["grad_gap"] < 1e-4 and numbers["grad_diff"] < mu_rounding, where
    assert numbers["change_gap"] < 5e-3, where
    assert where["left_out"] == [f"encoder.layer_{i}.mha.wk.bias" for i in range(c.config["num_layers"])]


@pytest.mark.parametrize("cell", CELLS)
def test_kept_rows_hold_every_label_row_of_a_large_table(cell, monkeypatch):
    c = tiny_cell(cell)
    traffic, seeds = train.traffic_lib.make(c.traffic, c.config["n_items"], 5), train.seeds_of(5)
    batches = check.reference_batches(traffic, c.config, seeds)
    assert check.kept_rows(c.config, 5, lambda: batches) is None  # a small table is kept whole
    monkeypatch.setattr(check, "FULL_TABLE_ROWS", 0)
    monkeypatch.setattr(check, "SAMPLE_ROWS", 16)
    rows = check.kept_rows(c.config, 5, lambda: batches).numpy()
    labels = {int(x) + 10 for b in batches for x in b["labels"].ravel() if x != -1}
    assert labels <= set(rows.tolist()) and len(rows) <= len(labels) + 16
    assert (np.diff(rows) > 0).all() and rows.max() < c.config["table_rows"]


def test_blocked_softmax_equals_the_dense_one():
    from portbench.reference import model as ref

    g = torch.Generator().manual_seed(3)
    x = torch.randn(7, 5, generator=g, requires_grad=True)
    table = torch.randn(10 + 23, 5, generator=g, requires_grad=True)
    labels = torch.tensor([0, 4, 22, 9, 9, 13, 1])
    num = ref.Numerics()
    blocked = ref.BlockedTiedCE.apply(x, table, labels, 23, 4, num)
    gx, gt = torch.autograd.grad(blocked, [x, table])
    logits = x @ table[10:].t()
    dense = torch.nn.functional.cross_entropy(logits, labels)
    dx, dt = torch.autograd.grad(dense, [x, table])
    assert blocked.item() == pytest.approx(dense.item(), rel=1e-6)
    assert torch.allclose(gx, dx, atol=1e-6) and torch.allclose(gt, dt, atol=1e-6)


def test_fp8_numerics_round_every_operand():
    from portbench.reference import model as ref

    a = torch.linspace(-1, 1, 97).reshape(1, 97)
    q = ref.Numerics("fp8").fwd(a)
    assert 0 < (q - a).abs().max() < 0.07 and len(torch.unique(q)) < 97


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "math", "typing", "numpy", "torch", "portbench"}
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] in allowed, (path.name, name)
                if name.startswith("portbench"):
                    assert name.startswith("portbench.reference"), (path.name, name)
