"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<cell>`` of ``workloads`` reads ``portbench/workloads/<cell>.json``
(its runner, entry, steps and the limits of its check), its configuration
``portbench/configs/<config>.json`` and its traffic mix
``portbench/traffic/<traffic>.json``. A metric ``<name>`` is read by
``portbench/metrics/<name>.py``; an entry by ``portbench/entries/<entry>.py``
and a runner by ``portbench/runners/<runner>.py``. Adding a cell, a
configuration, a mix or a metric adds files and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file
    traffic: dict  # the traffic mix file
    spec: dict  # the cell file
    end_to_end: list  # metric entries of BENCHMARK.json that this cell reports
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import a file by path (its name may hold dots)."""
    name = "portbench_file" + re.sub(r"\W", "_", str(path.resolve()))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # dataclasses look their module up there
    spec.loader.exec_module(module)
    return module


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(entries)})")
    w = entries[name]
    here = root / "portbench"
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=load_json(here / "configs" / f"{w['config']}.json"),
        traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
        spec=load_json(here / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)],
    )


def metric_reader(name: str, root: Path = ROOT):
    return load_module(root / "portbench" / "metrics" / f"{name}.py").read


def entry(name: str, root: Path = ROOT):
    return load_module(root / "portbench" / "entries" / f"{name}.py")


def runner(name: str, root: Path = ROOT):
    return load_module(root / "portbench" / "runners" / f"{name}.py")
