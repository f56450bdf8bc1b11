"""A run whose timed path is broken underneath reads ``correct`` false.

Each fault the training cells can have is planted under the session the
runner builds (the chip look is skipped: the run is on the CPU, in float32
at tiny sizes, where a sound run reads near nought)."""

from __future__ import annotations

import json
import time

import pytest
import torch

from conftest import CELLS, tiny_cell
from portbench.harness import check
from portbench.runners import train


class Broken:
    """The session with one fault planted in its step or its feed."""

    def __init__(self, session, fault: str, n_items: int):
        self.inner, self.fault, self.n_items = session, fault, n_items

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def next(self):
        batch = self.inner.next()
        if self.fault == "label_shift":  # every label altered where the batch is made
            labels = batch["labels"]
            batch = dict(batch, labels=torch.where(labels == -1, labels, (labels + 1) % self.n_items))
        if self.fault == "half_batch":
            half = batch["labels"].shape[0] // 2
            cut = lambda t: t[:half]  # noqa: E731
            batch = {"features": {k: cut(v) for k, v in batch["features"].items()},
                     "head_positions": cut(batch["head_positions"]), "labels": cut(batch["labels"])}
        return batch

    def step(self, batch):
        if self.fault != "frozen":
            return self.inner.step(batch)
        saved = {k: p.detach().clone() for k, p in self.inner.state.params.items()}
        loss = self.inner.step(batch)
        with torch.no_grad():
            for k, p in self.inner.state.params.items():
                p.copy_(saved[k])
        return loss


def run_line(cell, capsys, monkeypatch, fault=None) -> dict:
    if fault:
        build = train.build_session
        n_items = cell.config["n_items"]
        monkeypatch.setattr(train, "build_session",
                            lambda *a: (lambda s, *rest: (Broken(s, fault, n_items), *rest))(*build(*a)))
    rc = train.run(cell, 2**40 + 99, 0.2, False, torch.device("cpu"), time.perf_counter())
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, capsys, monkeypatch):
    c = tiny_cell(cell, dtype="float32")
    line = run_line(c, capsys, monkeypatch)
    assert line["correct"] is True
    assert list(line)[-1] == "checks" and set(line["checks"]) == {"first_loss_gap", "grad_gap", "grad_diff", "change_gap"}
    assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
    assert "setup_s" in line["metrics"] and len(line["metrics"]) == 2
    assert line["device"]["platform"] == "cpu"


@pytest.mark.parametrize("fault", ["frozen", "half_batch", "label_shift"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_makes_the_run_incorrect(cell, fault, capsys, monkeypatch):
    line = run_line(tiny_cell(cell, dtype="float32"), capsys, monkeypatch, fault)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_labels_shifted_fail_the_gradient_where_the_table_is_sampled(cell, capsys, monkeypatch):
    # a table too large to keep whole keeps a few sampled rows and every
    # label's row: the label term of the table's gradient, which a shifted
    # label moves to another row, is compared there
    monkeypatch.setattr(check, "FULL_TABLE_ROWS", 0)
    monkeypatch.setattr(check, "SAMPLE_ROWS", 16)
    c = tiny_cell(cell, dtype="float32")
    assert run_line(c, capsys, monkeypatch)["correct"] is True
    line = run_line(c, capsys, monkeypatch, "label_shift")
    assert line["checks"]["grad_diff"]["value"] > 3 * c.spec["limits"]["grad_diff"], line["checks"]
