"""BENCHMARK.json against the contract, every name found as a file,
and a cell, a mix and a metric added as new files alone."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from graphbench import manifest

B = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in B["workloads"]]


def test_top_level_keys_and_limits():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["graphbench"]
    assert B["command"] == ["python3", "graphbench/run.py"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) <= 64 * 1024
    full = 2 + 14 * 24
    budget = full * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert budget <= 43200


def test_names_units_and_entries():
    seen = set()
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in B[kind]:
            assert NAME.match(entry["name"]), entry["name"]
            assert (kind, entry["name"]) not in seen
            seen.add((kind, entry["name"]))
    metrics = B["end_to_end"] + B["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {w["chips"] for w in B["workloads"]} == {1}


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_is_found_by_name(cell):
    c = manifest.cell(B, cell)
    assert c.config["name"] == next(
        w["config"] for w in B["workloads"] if w["name"] == cell)
    assert c.traffic["name"] == next(
        w["traffic"] for w in B["workloads"] if w["name"] == cell)
    assert c.limits
    for m in c.end_to_end + c.per_layer:
        assert callable(manifest.reader(m["name"]))
    manifest.program(c.traffic["program"])


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_its_metrics_move(cell):
    c = manifest.cell(B, cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (m["name"], cell)


def test_config_files_name_their_cuts():
    for cfg in B["configs"]:
        data = json.loads((manifest.ROOT / cfg["file"]).read_text())
        assert set(cfg["reduced"]) == set(data["reduced"])
        for key in cfg["reduced"]:
            assert data["published"][key] != data[key]


NEW_FAMILY = '''"""A ring with random chords (a test's graph family)."""

import torch


def make(cfg, n, e, gen, device):
    src = torch.arange(e, device=device) % n
    hop = torch.randint(1, 4, (e,), generator=gen, device=device)
    return torch.stack([src, (src + hop) % n], dim=1)
'''

NEW_METRIC = '''"""Median time of a call in a traced run (a test's metric)."""

import statistics


def read(record):
    return statistics.median(record.durations_s) * 1e3
'''

RUN_NEW = '''
import sys
sys.path[:0] = [".", "src"]
import torch
torch.set_num_threads(1)
from graphbench import harness, manifest
cell = manifest.cell(manifest.load(), "tiny-shallow")
r = harness.run_cell(cell, 5, 0.2, True, device="cpu",
                     trace_path=__import__("pathlib").Path("t.json"))
print(r["correct"], sorted(r["metrics"]))
'''


def test_a_cell_mix_and_metric_added_as_new_files(tmp_path):
    """A copy of the benchmark gains a graph family, a configuration, a
    traffic mix, a per-layer metric and a cell by new files and new
    entries only."""
    here = manifest.HERE
    shutil.copytree(here, tmp_path / "graphbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    (tmp_path / "src").symlink_to(manifest.ROOT / "src")
    before = {p: p.read_bytes() for p in (tmp_path / "graphbench")
              .rglob("*") if p.is_file()}
    g = tmp_path / "graphbench"
    cfg = json.loads((g / "configs" / "gap-urand22.json").read_text())
    cfg.update(name="tiny-urand", generator="ring", scale=9, edge_factor=4)
    (g / "generators" / "ring.py").write_text(NEW_FAMILY)
    (g / "configs" / "tiny-urand.json").write_text(json.dumps(cfg))
    mix = json.loads((g / "traffic" / "bfs.json").read_text())
    mix.update(name="bfs-shallow", params={"max_levels": 2})
    (g / "traffic" / "bfs-shallow.json").write_text(json.dumps(mix))
    (g / "metrics" / "bfs_p50_ms.py").write_text(NEW_METRIC)
    (g / "limits" / "tiny-shallow.json").write_text(
        json.dumps({"bfs_errors": {"limit": 0}}))
    b = json.loads(json.dumps(B))
    b["configs"].append({"name": "tiny-urand", "source": "a test",
                         "file": "graphbench/configs/tiny-urand.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "tiny-shallow", "config": "tiny-urand",
                           "traffic": "bfs-shallow", "chips": 1,
                           "why": "a test"})
    b["per_layer"].append({"name": "bfs_p50_ms", "unit": "ms",
                           "better": "lower", "source": "host_clock",
                           "layer": "driver", "moves": "setup_s",
                           "workloads": ["tiny-shallow"]})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m and m["name"] in ("bfs_gteps", "partition_s",
                                              "wire_mb.bfs"):
            m["workloads"].append("tiny-shallow")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    out = subprocess.run([sys.executable, "-c", RUN_NEW], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[0] == "True"
    assert "bfs_p50_ms" in out.stdout and "wire_mb.bfs" in out.stdout
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} changed"
