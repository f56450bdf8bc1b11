"""A configuration whose model the BERT4Rec reference does not cover is
added with new files only: a toy second architecture (pre-LN, a gated
feed-forward with a rank-3 weight; ``tests/toy/``) is dropped into a copy of
the benchmark as a config, a reference, an entry, a mix and a cell, and runs
through ``manifest.reference``, ``weights.fill``, ``check`` and the
runner, and ``step_mfu`` counts its FLOPs, with no file of the harness
naming it."""

from __future__ import annotations

import json
import math
import shutil
import time
from pathlib import Path

import pytest
import torch

from conftest import ROOT
from portbench.harness import check, manifest, work
from portbench.harness import weights as weights_lib
from portbench.runners import train

TOY = Path(__file__).resolve().parent / "toy"
CELL = "toy_glu.train"
SEED = 2**41 + 7
HARNESS = ("harness", "runners", "metrics", "run.py", "calibrate.py")


@pytest.fixture
def root(tmp_path) -> Path:
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    here = tmp_path / "portbench"
    for source, target in (("config.json", "configs/toy_glu.json"), ("reference.py", "reference/toy_glu.py"),
                           ("entry.py", "entries/toy_glu.py"), ("traffic.json", "traffic/toy_sessions.json"),
                           ("workload.json", f"workloads/{CELL}.json")):
        shutil.copy(TOY / source, here / target)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((TOY / "config.json").read_text())
    bench["configs"].append({"name": "toy_glu", "source": config["source"], "file": "portbench/configs/toy_glu.json",
                             "reduced": [], "why": "a second architecture"})
    bench["workloads"].append({"name": CELL, "config": "toy_glu", "traffic": "toy_sessions", "chips": 1,
                               "why": "the toy on the CPU"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_no_file_of_the_harness_names_the_toy(root):
    for part in HARNESS:
        base = root / "portbench" / part
        for path in [base] if base.is_file() else base.rglob("*.py"):
            source = path.read_text()
            assert "toy" not in source, path
            assert source == (ROOT / path.relative_to(root)).read_text(), path


def test_the_configuration_finds_its_own_reference(root):
    cell = manifest.cell(CELL, root)
    ref = manifest.reference(cell.config, root)
    assert Path(ref.__file__) == root / "portbench" / "reference" / "toy_glu.py"
    assert ("block.w_in", (2, 24, 16), "dense") in ref.param_specs(cell.config)
    # without the key a configuration keeps the BERT4Rec reference
    default = manifest.reference(manifest.cell("large_catalog.full_ce", root).config, root)
    assert Path(default.__file__).name == "model.py"


def test_a_rank3_dense_leaf_draws_by_its_last_axis(root):
    cfg = manifest.cell(CELL, root).config
    specs = manifest.reference(cfg, root).param_specs(cfg)
    params = weights_lib.draw(specs, SEED, cfg["init"]["table_std"], torch.device("cpu"))
    w_in, w_out = params["block.w_in"], params["block.w_out"]
    assert w_in.shape == (2, 24, 16)
    # fan-in 16 for both: unit-variance draws over sqrt(16); 24 would be the second axis
    assert float(w_in.std() * 4) == pytest.approx(1.0, abs=0.1)
    assert float(w_out.std() * math.sqrt(24)) == pytest.approx(1.0, abs=0.1)


def test_the_toy_runs_through_the_runner_and_the_check(root, capsys):
    cell = manifest.cell(CELL, root)
    rc = train.run(cell, SEED, 0.2, False, torch.device("cpu"), time.perf_counter())
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert {"train_examples_per_s", "setup_s"} <= set(line["metrics"])
    # the check's numbers are those of the same float32 arithmetic, summed in another order
    assert max(c["value"] for c in line["checks"].values()) < 1e-4, line["checks"]


def test_a_frozen_step_fails_the_toys_check(root):
    cell = manifest.cell(CELL, root)
    cfg = cell.config
    session, traffic, seeds = train.build_session(cell, SEED, torch.device("cpu"))
    batches = check.reference_batches(traffic, cfg, seeds)
    ours = check.program_steps(session, cfg, SEED, None, root)
    theirs, rms = check.reference_steps(cfg, batches, SEED, seeds, torch.device("cpu"), None, root=root)
    frozen, _ = check.reference_steps(cfg, batches, SEED, seeds, torch.device("cpu"), None, frozen=True, root=root)
    assert check.judge(check.compare(ours, theirs, rms)[0], cell.spec["limits"])
    assert not check.judge(check.compare(frozen, theirs, rms)[0], cell.spec["limits"])


def test_step_mfu_counts_the_toys_flops(root):
    cell = manifest.cell(CELL, root)
    cfg = cell.config
    traffic = train.traffic_lib.make(cell.traffic, cfg["n_items"], SEED)
    stats = [train.traffic_lib.batch_stats(b) for b in traffic.pool]
    window = train.Window(0.0, 2.0, len(stats), 16, 0.0, 0.0, stats, 1.0)
    value = manifest.metric_reader("step_mfu", root)(train.Context(cell, 1.0, window))
    d, f = cfg["d_model"], cfg["ffn_dim"]
    flops = sum(3 * (2 * s["tokens"] * 3 * d * f + 2 * s["labelled"] * cfg["n_items"] * d) for s in stats)
    assert value == pytest.approx(100 * flops / (2.0 * work.PEAK_FLOPS))
