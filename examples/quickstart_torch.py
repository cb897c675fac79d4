"""Quickstart of the PyTorch/CUDA port: the paper's workload in a page.

Generates a small Erdos-Renyi graph, runs distributed BFS and PageRank
through ``GraphEngine.program`` (the HPX-adapted ``fast`` variants),
checks both against a numpy oracle, runs a batched multi-source BFS
(many roots, one graph residency) and the async BFS (the double-buffered
superstep loop, same parents).  Runs on the CUDA card by default;
``--device cpu`` runs the plain-PyTorch versions of the kernels.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core import GraphEngine, partition_graph, registry
from repro_torch.graphs import urand_edges

INT_INF = 2 ** 30

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device; default cuda (raises without one)")
ap.add_argument("--parts", type=int, default=1)
args = ap.parse_args()

n, e = 4096, 32768
edges = urand_edges(n, e, seed=1)
eng = GraphEngine(partition_graph(edges, n, parts=args.parts),
                  device=args.device)
garr = eng.device_graph()
print("registered programs:", registry.registered_keys())

# --- BFS (direction-optimizing variant; cached program) ---
bfs = eng.program("bfs", "fast")
parents, levels = bfs(garr, 0)
par = eng.gather_vertex_field(parents)
assert bfs is eng.program("bfs", "fast")  # second lookup: cache hit

# numpy oracle: BFS levels; every parent is an in-neighbor one level up
src, dst = edges[:, 0], edges[:, 1]
level = np.full(n, -1)
level[0], frontier, d = 0, np.zeros(n, bool), 0
frontier[0] = True
while frontier.any():
    d += 1
    nxt = np.zeros(n, bool)
    nxt[dst[frontier[src]]] = True
    frontier = nxt & (level < 0)
    level[frontier] = d
reached = par < INT_INF
assert (reached == (level >= 0)).all(), "BFS reachability differs"
v = np.flatnonzero(reached & (np.arange(n) != 0))
assert (level[par[v]] == level[v] - 1).all(), "a parent is not a level up"
edge_set = set(zip(src.tolist(), dst.tolist()))
assert all((int(par[u]), int(u)) in edge_set for u in v)
print(f"BFS: reached {int(reached.sum())}/{n} vertices in {levels} levels")

# --- PageRank (paper eq. 1) ---
rank, err, iters = eng.program("pagerank", "fast", iters=60, tol=1e-9)(garr)
r = eng.gather_vertex_field(rank)
outdeg = np.bincount(src, minlength=n).astype(np.float64)
ref = np.full(n, 1.0 / n)
for _ in range(iters):
    contrib = np.where(outdeg > 0, ref / np.maximum(outdeg, 1), 0.0)
    z = np.zeros(n)
    np.add.at(z, dst, contrib[src])
    ref = 0.15 / n + 0.85 * z
rel = np.abs(r - ref).max() / ref.max()
print(f"PageRank: {iters} iters, err={err:.2e}, max rel diff vs oracle = "
      f"{rel:.2e}")
assert rel < 5e-3

# --- batched multi-source BFS: 8 roots over one graph residency ---
B = 8
parents_b, levels_b = eng.program("bfs", "fast", batch=B)(garr, range(B))
per_root = eng.gather_batched_vertex_field(parents_b)   # (B, n)
np.testing.assert_array_equal(per_root[0], par)         # root 0 == above
assert levels_b[0] == levels
print(f"multi-source BFS: {B} roots, levels per root = {levels_b}")

# --- async BFS: levels by min-combine on the double-buffered exchange ---
abfs = eng.program("bfs", exec_mode="async")     # is program("bfs", "async")
parents_a, rounds_a = abfs(garr, 0)
np.testing.assert_array_equal(eng.gather_vertex_field(parents_a), par)
print(f"async BFS: {rounds_a} rounds, parents == bfs/fast's")
print(f"device: {eng.device}")
print("OK")
