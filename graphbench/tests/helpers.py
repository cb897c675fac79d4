"""Shared set-up of the benchmark's CPU tests: tiny cells of the
manifest's own cells, run on the CPU with one torch thread."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from graphbench import manifest

TINY = {"scale": 10, "edge_factor": 8}
SEED = 2 ** 31 + 29


# a case's name: the manifest's cell and the configuration file it runs
# on here (None: the cell's own); kron22-pagerank runs the urand cell's
# mix and limits on configs/gap-kron22.json
CASES = {"urand22-bfs": ("urand22-bfs", None),
         "urand22-pagerank": ("urand22-pagerank", None),
         "kron22-bfs": ("kron22-bfs", None),
         "kron22-pagerank": ("urand22-pagerank", "gap-kron22")}


def tiny_cell(name: str, **config) -> manifest.Cell:
    """The case ``name`` (``CASES``) at ``TINY`` (or ``config``) sizes."""
    cell_name, config_file = CASES[name]
    cell = manifest.cell(manifest.load(), cell_name)
    base = cell.config if config_file is None else json.loads(
        (manifest.HERE / "configs" / f"{config_file}.json").read_text())
    return dataclasses.replace(cell, name=name,
                               config={**base, **TINY, **config})


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
