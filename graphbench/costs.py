"""The least bytes a call needs, counted from the graph, and the
device peaks they are priced at.

The bytes are the graph's, never the program's layout: an edge is read
once as a 4-byte id, a vertex's state once.  So a roofline share built
on them reads the same work whatever implements it, and stays under
100% whatever a change does to the slots or the re-reads of a kernel.

* BFS: 4 B a traversed edge (Graph500's count: an input edge whose
  source the search reached; of an undirected graph, an undirected edge
  of the reached component, read once) plus 8 B a vertex (its parent
  written, its visited state read), once a search.
* PageRank: in each round the program ran, 4 B a directed edge (each
  undirected edge counts both ways) plus 12 B a vertex (the rank and
  the out-degree read, the new rank written).
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def bfs_least_bytes(traversed_edges: int, n: int) -> int:
    return 4 * int(traversed_edges) + 8 * int(n)


def pagerank_least_bytes(rounds: int, n: int, e: int) -> int:
    return int(rounds) * (4 * int(e) + 12 * int(n))


def peak(device_name: str, key: str) -> float | None:
    """A published peak of the named card, or None for a card the table
    does not hold (a share is then not reported)."""
    table = json.loads(PEAKS.read_text())
    for name, row in table["cards"].items():
        if device_name.startswith(name):
            return float(row[key])
    return None
