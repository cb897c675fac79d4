"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (its ``file``) and a traffic mix
(``traffic/<traffic>.json``); its limits are ``limits/<cell>.json``;
every metric, end to end or per layer, is read by
``metrics/<metric>.py``'s ``read(record)``; a traffic mix's program is
driven by ``programs/<program>.py``.  A new cell, mix or metric is new
files and new entries here: no file that exists changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


def _in_cell(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def cell(manifest: dict, name: str) -> Cell:
    """The cell ``name`` with its configuration, traffic, limits and the
    metrics it reports."""
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        limits=limits,
        end_to_end=[m for m in manifest["end_to_end"] if _in_cell(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _in_cell(m, name)])


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read`` (a name may hold dots, so the
    file is loaded by path)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"graphbench.metrics.{metric.replace('.', '__')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def program(name: str):
    """``programs/<name>.py``: the driver of a traffic mix's program."""
    return importlib.import_module(f"graphbench.programs.{name}")
