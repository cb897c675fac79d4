"""Paper-side workload configs: urand (Erdos-Renyi) graphs as in §5.

The paper evaluates BFS and PageRank on 'urand' graphs of varying scale
(urand25 has 2^25 vertices) on up to 32 nodes.
"""

from repro_torch.configs.base import GraphConfig

# Benchmark-scale graphs.
URAND12 = GraphConfig("urand12", scale=12)
URAND16 = GraphConfig("urand16", scale=16)
URAND18 = GraphConfig("urand18", scale=18)
URAND20 = GraphConfig("urand20", scale=20)

# Small-world (Watts-Strogatz): the high-clustering family.
SW12 = GraphConfig("sw12", scale=12, generator="smallworld")
SW16 = GraphConfig("sw16", scale=16, generator="smallworld")

# Paper-scale graphs.  urand22 (4M vertices, 67M edges) is the size one
# H100 runs end to end in chip_smoke.py.
URAND22 = GraphConfig("urand22", scale=22)
URAND25 = GraphConfig("urand25", scale=25)
URAND28 = GraphConfig("urand28", scale=28)

# RMAT (GAP 'kron'-style) for skewed-degree stress.
RMAT12 = GraphConfig("rmat12", scale=12, generator="rmat")
RMAT16 = GraphConfig("rmat16", scale=16, generator="rmat")
RMAT18 = GraphConfig("rmat18", scale=18, generator="rmat")
RMAT20 = GraphConfig("rmat20", scale=20, generator="rmat")

ALL = {
    g.name: g
    for g in (URAND12, URAND16, URAND18, URAND20, URAND22, URAND25,
              URAND28, RMAT12, RMAT16, RMAT18, RMAT20, SW12, SW16)
}
