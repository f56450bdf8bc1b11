"""BENCHMARK.json against the benchmark's contract, and the files it names."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from conftest import ROOT
from portbench.harness import manifest

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
METRIC_KEYS = {"end_to_end": {"name", "unit", "better", "bound", "source"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_allowed_and_unique(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metric_entries(section):
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH[section]:
        assert set(m) - {"workloads"} == METRIC_KEYS[section], m["name"]
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        if section == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
            assert TEXT.match(m["layer"]) and m["moves"] in e2e
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["better"] == "higher"


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert manifest.reports(moved, cell), (m["name"], cell)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_resolve(cell):
    c = manifest.cell(cell, ROOT)
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    assert (ROOT / "portbench" / "entries" / f"{c.spec['entry']}.py").is_file()
    assert (ROOT / "portbench" / "runners" / f"{c.spec['runner']}.py").is_file()
    assert set(c.spec["limits"]) == {"first_loss_gap", "grad_gap", "grad_diff", "change_gap"}
    assert c.spec["warm_steps"] >= 3 and c.spec["profile_steps"] >= 1
    assert any(m["name"] != "setup_s" for m in c.end_to_end) and c.per_layer


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_files(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("portbench/") and (ROOT / entry["file"]).is_file()
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["reduced"] == entry["reduced"] and data["source"] == entry["source"]
    assert any(w["config"] == config for w in BENCH["workloads"])


def test_files_under_paths_are_named_from_name_characters():
    for path in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./\-]+$", rel), rel


def test_a_cell_and_a_metric_dropped_in_as_files_are_found(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = bench["workloads"][0]
    bench["workloads"].append(dict(base, name="new.cell", why="a cell added as files"))
    bench["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower", "source": "host_clock",
                               "layer": "step dispatch", "moves": "train_examples_per_s",
                               "workloads": ["new.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = json.loads((ROOT / "portbench" / "workloads" / f"{base['name']}.json").read_text())
    (tmp_path / "portbench" / "workloads" / "new.cell.json").write_text(json.dumps(spec))
    (tmp_path / "portbench" / "metrics" / "new_metric.py").write_text("def read(ctx):\n    return 42.0\n")
    cell = manifest.cell("new.cell", tmp_path)
    assert [m["name"] for m in cell.per_layer][-1] == "new_metric"
    assert manifest.metric_reader("new_metric", tmp_path)(None) == 42.0
    with pytest.raises(KeyError):
        manifest.cell("no.such.cell", tmp_path)
