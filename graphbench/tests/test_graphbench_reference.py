"""The plain references against hand-checked tiny graphs."""

import pytest
import torch

from graphbench.reference import bfs as ref_bfs
from graphbench.reference.pagerank import PowerIteration
from graphbench.tests.helpers import one_thread  # noqa: F401

U = ref_bfs.UNREACHED
# 0 -> 1, 0 -> 2, 1 -> 3, 2 -> 3, 3 -> 4, 5 -> 0 (5 unreachable from 0),
# a duplicate edge 1 -> 3 and a self loop at 4
EDGES = torch.tensor([[0, 1], [0, 2], [1, 3], [2, 3], [3, 4], [5, 0],
                      [1, 3], [4, 4]])


def test_levels_and_rounds_by_hand():
    level, rounds = ref_bfs.levels(EDGES, 6, 0, 64)
    assert level.tolist() == [0, 1, 1, 2, 3, -1]
    # three expansions find levels 1-3, the fourth finds nothing
    assert rounds == 4


@pytest.mark.parametrize("pick, parent_of_3", [("amin", 1), ("amax", 2)])
def test_parents_by_hand(pick, parent_of_3):
    parents, _ = ref_bfs.bfs(EDGES, 6, 0, 64, pick=pick)
    assert parents.tolist() == [0, 0, 0, parent_of_3, 3, U]


def test_max_levels_stops_the_search():
    parents, rounds = ref_bfs.bfs(EDGES, 6, 0, 2)
    assert rounds == 2
    assert parents.tolist() == [0, 0, 0, 1, U, U]


def test_pagerank_on_a_cycle_is_uniform():
    cycle = torch.tensor([[0, 1], [1, 2], [2, 0]])
    rank, rounds = PowerIteration(cycle, 3, 0.85).until_stop(50, 1e-6, 5)
    assert rounds == 5
    assert torch.allclose(rank, torch.full((3,), 1 / 3, dtype=torch.float64))


def test_pagerank_step_by_hand():
    # 0 -> 1, 0 -> 2, 1 -> 2; vertex 2 has no out-edge (its mass leaks)
    edges = torch.tensor([[0, 1], [0, 2], [1, 2]])
    power = PowerIteration(edges, 3, 0.5)
    r = power.step(power.start())
    base = 0.5 / 3
    want = [base, base + 0.5 * (1 / 3) / 2,
            base + 0.5 * ((1 / 3) / 2 + 1 / 3)]
    assert torch.allclose(r, torch.tensor(want, dtype=torch.float64))


def test_pagerank_stops_by_the_rule():
    edges = torch.tensor([[0, 1], [0, 2], [1, 2], [2, 0], [1, 0]])
    power = PowerIteration(edges, 3, 0.85)
    rank, rounds = power.until_stop(50, 1e-6, 5)
    assert rounds % 5 == 0 and rounds < 50
    # the rule held at the stop and not at the check before it
    prev = power.start()
    errs = []
    for _ in range(rounds):
        nxt = power.step(prev)
        errs.append(float((nxt - prev).abs().sum()))
        prev = nxt
    assert errs[-1] <= 1e-6 < errs[rounds - 6]
    assert torch.equal(prev, rank)
