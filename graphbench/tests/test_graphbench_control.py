"""Each cell's control comes out not correct, at a size a test holds,
and the program's own readings stay under the same limits."""

import pytest

from graphbench import control, harness
from graphbench.tests.helpers import (  # noqa: F401
    CASES, SEED, one_thread, tiny_cell)

CELLS = list(CASES)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_limit(cell):
    c = tiny_cell(cell, scale=11, edge_factor=16)
    r = control.readings(c, SEED, "cpu")
    assert not r["control"]["correct"], r
    assert r.get("program", {"correct": True})["correct"], r
    values = r["control"]["values"]
    assert any(values[k] > lim["limit"] for k, lim in c.limits.items())


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_keeps_the_limits(cell):
    c = tiny_cell(cell, scale=11, edge_factor=16)
    result = harness.run_cell(c, SEED + 1, 0.2, False, device="cpu")
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell", ["urand22-pagerank", "kron22-pagerank"])
def test_the_early_stop_runs_fewer_rounds(cell):
    c = tiny_cell(cell, scale=11, edge_factor=16)
    r = control.readings(c, SEED + 2, "cpu")
    early, program = r["early"]["values"], r["program"]["values"]
    assert early["rounds"] < early["ref_rounds"] <= program["rounds"]
    assert early["stop_l1"] > program["stop_l1"]
