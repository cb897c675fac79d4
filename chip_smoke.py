#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--parent DIR]

It drives the port's two main paths and holds every CUDA kernel of each
against its plain-PyTorch version:

- the paper's graph path: bfs/bsp, bfs/fast, pagerank/bsp and
  pagerank/fast through ``GraphEngine.program`` on a urand graph cut
  into P vertex blocks stacked on the card (kernels ``spmv_ell``,
  ``bfs_pull``);
- the rest of the BSP suite: sssp, cc, kcore and betweenness on the same
  partitions, triangles on an 8192-vertex urand graph, and bfs/fast, sssp
  and betweenness batched over four roots (kernel ``spmv_ell`` on
  betweenness's two combines, ``bfs_pull`` on batched bfs/fast);
- async supersteps and the incremental programs: bfs/async, sssp/async,
  cc/async and pagerank/async (staleness 1 and 2), cc/incremental,
  kcore/incremental and pagerank/warm on the same partitions (kernel
  ``spmv_ell`` on pagerank/async's and pagerank/warm's push combines);
- LM token serving: ``launch/serve.py::serve`` on TinyLlama-1.1B at full
  width, weights drawn from a seeded ``torch.Generator`` on the card
  (kernel ``flash_attention_fwd``, one launch per prefill layer).

Phases, each of which raises on failure (the run then exits non-zero and
prints no result):

  card     the card's name and power limit, as nvidia-smi gives them.
  build    every kernel compiled from src/repro_torch/kernels/*/csrc, all
           at once (one nvcc per source), and, with --parent DIR, the
           graph kernels of the checkout at DIR (the first design, one
           launch a bucket, or this one's bucket-table interface; any
           other fails at load); registers and spill stores of
           each kernel instantiation, any ptxas warning, and any note
           that ptxas serialized a kernel's wgmma products.
  parity   each kernel against its plain version on the card: the shape
           sweeps of the JAX package's kernel tests, then every ELL bucket
           of the main-path graph one by one (ell_in, ell_dst, ell_out and
           ell_src for spmv_ell, ell_in for bfs_pull), then each ELL
           structure in one multi-bucket call.  Both graph kernels must
           match exactly (spmv_ell adds a row's slots left to right, as
           ref.py does: equal bits).
  main     the four programs once in local-ops mode ``auto`` (the
           kernels) at each parts count, launch counters zeroed just
           before and read just after: spmv_ell must launch once per
           spmv_pull or scatter_combine(add) call (a round of
           pagerank/bsp or pagerank/fast) and bfs_pull once per
           frontier_pull call (a round of bfs/fast).  BFS parents must
           equal the min-id in-neighbor one BFS level up (levels from a
           scipy sparse BFS) for both variants and every parts count;
           ranks must be within 1e-4 relative of a float64 scipy power
           iteration of the same round count; rounds must be equal across
           parts counts.
  plain    the same programs in mode ``ell`` (no kernels) on the card:
           parents and ranks bit-identical, rounds equal.
  times    per-program ms in both modes (median of 3 after a warm-up run),
           and each kernel at the main path's inputs beside its plain
           version, its bound and, for spmv_ell, a torch.sparse CSR
           matvec of the same function (timed here only; the port never
           calls it): spmv_ell over one call's buckets per structure
           (ell_in, ell_dst, and ell_out as a betweenness backward round
           calls it), with each bucket alone (rows, K, ms, gathers per
           second);
           bfs_pull over one bfs/fast run, round by round (push ``u`` or
           pull ``l``, live rows, ms).  With --parent, the same
           per-bucket and per-round lines of the parent's kernels on the
           same inputs, each result first held against the plain version
           (spmv_ell within SPMV_TOL, bfs_pull exactly).
  bsp      host references first (numpy / scipy, one CSR of the graph):
           Dijkstra under the synthesized weights, min-id weakly connected
           components, threshold peeling of the undirected multigraph, a
           float64 Brandes.  Then sssp, cc, kcore and betweenness in mode
           auto at each parts count, launch counters zeroed just before and
           read just after: spmv_ell launches once a round per launch
           table, forward rounds over ell_dst plus backward rounds over
           ell_out (the phases' rounds from a phase-wise run), the other
           programs launch nothing.  Outputs bit-identical to mode ell;
           sssp within 1e-5 relative (1e-4 absolute) of Dijkstra, labels,
           cores, kmax and peeling rounds exact, betweenness dist exact,
           sigma within 1e-6 relative (path counts below 2^24, exact in
           float32), bc within 1e-4 relative and absolute.  Triangles at 8192 vertices,
           parts 1 and 4: counts and total equal scipy's A o (A @ A).  Per
           program ms in both modes.  Then bfs/fast, sssp and betweenness
           batched over roots 0-3 (counters zeroed around the batched
           calls): each row and its rounds equal the single-source run
           with that root, and the batched call launches what those runs
           launched.
  async    a float64 PageRank run to convergence on the host, then at each
           parts count, launch counters zeroed just before and read just
           after each group: bfs/async, sssp/async and cc/async in mode
           auto (parents, dist and labels bit-identical to the bfs/fast,
           sssp and cc runs above, rounds within the registry's slack
           1.5 x BSP rounds + 4, one host sync a round, no kernel) and
           pagerank/async at staleness 1 and 2 (ASYNC_PR_PARAMS: rounds
           under the cap, rank within 1e-4 relative of the converged
           float64, max_age <= 2 x staleness + 1, spmv_ell launched rounds
           + 1 times, one sync a refresh); then cc/incremental and
           kcore/incremental from their cold seeds and from cc's labels and
           kcore's cores (outputs equal cc's and kcore's), and pagerank/warm
           from pagerank/fast's ranks (within 1e-4 of the converged float64,
           spmv_ell once a round).  Every run again in mode ell:
           bit-identical, equal rounds, no launch.  ``[async]`` lines: per
           run rounds, ms in modes auto and ell (median of 3 after the
           checked run), syncs, wire bytes per round by op, and the BSP
           sibling's ms and rounds from this run; ``[async done]`` the
           phase's seconds.
  llm-parity  flash_attention_fwd against its plain version (ref.py) on
           the shapes of tests/test_kernels_flash.py (sweep x {causal,
           causal + window 64, non-causal}, cross lengths, softcap 20,
           D = 120 through ops) and at the edges of the bf16 design's
           tiles (FLASH_EDGES), each in f32 and bf16, then at TinyLlama's
           prefill shape; within 2e-5 (f32) and 2e-2 (bf16), the
           tolerances of those tests.
  llm-main serve() on TinyLlama-1.1B, batch 8, prompt 1024, gen 64, the
           launch counters zeroed just before and read just after: 22
           flash launches (one per layer of the prefill), all 22 of the
           bf16 tensor-core design; generated tokens in range.  The kernel
           at layer 0's real q, k, v within 2e-2 of ref.py.  Prefill
           logits through the kernel against forward_prefill(impl="naive")
           on the card, and decode step by step over a 256-token prompt
           against the last logits of prefill through the kernel and of
           prefill with naive attention: finite, the same argmax but for
           ties within one bf16 ulp of the reference (counted and printed
           with each row's top-two gap), and within LOGIT_MAX_TOL
           (largest) and LOGIT_MEAN_TOL (mean) of each other.
  llm-times prefill ms and decode tok/s (median of 3 serve runs after the
           main-path run), and the flash kernel at the prefill shape beside
           its bound, ref.py's time and scaled_dot_product_attention's
           (timed here only; the port never calls it), the same at the
           head dims 128 and 120 (FLASH_WIDTHS); then one serve call
           with 8 decode steps under torch.profiler: device busy share and
           the kernels that take most.

The last three lines are the kernels' JSON record, the card line, and the
result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

PROGRAMS = (("bfs", "bsp"), ("bfs", "fast"), ("pagerank", "bsp"),
            ("pagerank", "fast"))
INT_INF = 2 ** 30
ALPHA = 0.85
ROOT = 0
SEED = 42
GRAPH = "urand22"        # 4M vertices, 67M edges: the paper's urand family
PARTS = (1, 4)           # vertex blocks, all stacked on the one card

SPMV_TOL = 1e-5          # rtol = atol, cuSPARSE CSR matvec vs the kernel
PR_F64_TOL = 1e-4        # max rel err of ranks vs float64 power iteration

# the rest of the BSP suite (triangles on its own graph) and multi-source
BSP_PROGRAMS = ("sssp", "cc", "kcore", "betweenness")
TRI_N = 8192             # the largest graph triangles' n_budget admits
MULTI = (("bfs", "fast"), ("sssp", "default"), ("betweenness", "default"))
MULTI_ROOTS = (0, 1, 2, 3)
SSSP_RTOL, SSSP_ATOL = 1e-5, 1e-4     # tests/oracle.py's sssp check
# async supersteps and the incremental programs
ASYNC_MONOTONE = ("bfs", "sssp", "cc")
ASYNC_STALENESS = (1, 2)
# pagerank/async and pagerank/warm run to convergence: at parts > 1 the
# stale remote term slows pagerank/async to about 0.91 a round (188 and
# 202 rounds to 1e-7 at urand16 parts 4, staleness 1 and 2, on the CPU;
# the float32 residual fell below 1e-9 there), and 1e-7 keeps the ranks
# far inside 1e-4 of the converged float64
ASYNC_PR_PARAMS = {"iters": 300, "tol": 1e-7}
INCREMENTAL = (("cc", "incremental"), ("kcore", "incremental"),
               ("pagerank", "warm"))
ASYNC_SIBLING = {"bfs/async": "bfs/fast", "sssp/async": "sssp",
                 "cc/async": "cc", "pagerank/async": "pagerank/fast",
                 "cc/incremental": "cc", "kcore/incremental": "kcore",
                 "pagerank/warm": "pagerank/fast"}
SIGMA_RTOL = 1e-6        # path counts (tests/oracle.py)
BC_TOL = 1e-4            # rtol = atol of dependencies (tests/oracle.py)
HBM_SECTOR = 32          # bytes an HBM gather moves at the least
L2_BYTES = 50 * 2 ** 20  # H100 L2 cache

# NVIDIA H100 SXM published peaks (data sheet; at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12    # float32 outside the tensor cores

# shape sweeps of tests/test_kernels_spmv.py and test_kernels_frontier.py
# (rows, K, n_cols), plus a hub-width row block as rmat graphs have
SPMV_SWEEP = ((256, 8, 512), (512, 16, 1024), (1024, 4, 256),
              (256, 32, 2048), (128, 1, 128), (128, 1024, 4096))
FRONTIER_SWEEP = ((256, 8, 512), (512, 16, 1024), (128, 4, 4096),
                  (1024, 2, 128), (128, 1024, 4096))

SPMV_REPLACES = "src/repro/kernels/spmv/kernel.py:36"
BFS_REPLACES = "src/repro/kernels/frontier/kernel.py:41"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:80"

# LM serving at TinyLlama-1.1B's full width (all 22 layers)
LLM_ARCH = "tinyllama-1.1b"
LLM_BATCH, LLM_PROMPT, LLM_GEN = 8, 1024, 64
LLM_DECODE_PROMPT = 256   # prefill-vs-decode check
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels_flash
# Full-width logit checks.  The kernel path, the naive path and decode
# compute the same bf16 logits (|logit| up to about 4) with other rounding
# points (p rounded before or after normalising, other summation orders):
# an attention output may differ by a bf16 ulp per layer, and the
# difference grows with depth.  So each check bounds the largest difference
# at 16 bf16 ulps of logits in [2, 4), the mean difference, which a wrong
# mask or scale would raise everywhere, and the argmax of every row; the
# kernel itself is held to 2e-2 on this run's real layer-0 q, k, v.  A row
# whose two top logits are one bf16 ulp apart is a tie that two rounding
# schemes may break either way, so a row may take another token only where
# the reference scores it within one bf16 ulp of its largest (logit_diff).
LOGIT_MAX_TOL = 0.25
LOGIT_MEAN_TOL = 0.03
BF16_TC_OPS_PER_S = 989e12     # H100 SXM bf16 dense tensor-core peak
# (bh, s, d) sweep of tests/test_kernels_flash.py
FLASH_SWEEP = ((2, 256, 128), (4, 512, 128), (1, 128, 256))
# (bh, sq, sk, d, causal, window, softcap) at the edges of the bf16
# design's tiles (128-row q tiles; k tiles of 128, 64 or 32 keys; head
# dims padded to 64, 128 or 256): several q tiles, Sq != Sk both ways, a window
# ending inside a tile, rows with no key in their window, head dims on
# each side of the padded widths, softcap under causal masking
FLASH_EDGES = ((2, 1000, 1000, 64, True, 0, 0.0),
               (2, 1024, 1024, 128, True, 0, 0.0),
               (2, 700, 300, 64, True, 0, 0.0),
               (2, 300, 700, 128, True, 0, 0.0),
               (2, 500, 500, 64, True, 100, 0.0),
               (2, 600, 200, 64, True, 50, 0.0),
               (2, 400, 400, 128, True, 0, 30.0)) + tuple(
    (2, 200, 200, d, True, 0, 0.0) for d in (8, 72, 120, 136, 200, 256))
# timed beside the prefill shape: (BH, S, D) bf16 causal at the head dims
# of qwen2.5 / gemma3 (128) and danube3 (120), 64 heads of S = 1024
FLASH_WIDTHS = ((64, 1024, 128), (64, 1024, 120))


def check(ok, msg: str) -> None:
    """Raise when a result check fails (kept under ``python -O``)."""
    if not ok:
        raise AssertionError(msg)


def log(*args):
    print(*args, flush=True)


class Port:
    """The port's modules, imported from this checkout's ``src``."""

    def __init__(self):
        if not (SRC / "repro_torch").is_dir():
            raise SystemExit(f"chip_smoke: {SRC / 'repro_torch'} not found; "
                             "run from a checkout of the repository")
        sys.path.insert(0, str(SRC))
        import torch
        from repro_torch.configs import graph_workloads
        from repro_torch.core import GraphEngine, incremental, localops, \
            partition_graph, registry, run_program, superstep
        from repro_torch.core.partitioned import pack_bits
        from repro_torch.graphs import generate_edges, urand_edges
        from repro_torch.kernels import _build, _ell
        from repro_torch.kernels.frontier import kernel as frontier_kernel
        from repro_torch.kernels.frontier.ref import bfs_pull_buckets_ref, \
            bfs_pull_ref
        from repro_torch.kernels.spmv import kernel as spmv_kernel
        from repro_torch.kernels.spmv.ref import spmv_ell_buckets_ref, \
            spmv_ell_ref
        from repro_torch.configs import registry as arch_registry
        from repro_torch.data import batch_at
        from repro_torch.kernels.flash_attention import kernel as flash_kernel
        from repro_torch.kernels.flash_attention import ops as flash_ops
        from repro_torch.kernels.flash_attention.ref import \
            flash_attention_ref
        from repro_torch import models
        from repro_torch.launch.serve import serve
        self.arch_registry = arch_registry
        self.batch_at = batch_at
        self.flash_kernel = flash_kernel
        self.flash_ops = flash_ops
        self.flash_attention_ref = flash_attention_ref
        self.models = models
        self.serve = serve
        self.torch = torch
        self.graph_workloads = graph_workloads
        self.GraphEngine = GraphEngine
        self.localops = localops
        self.registry = registry
        self.partition_graph = partition_graph
        self.pack_bits = pack_bits
        self.generate_edges = generate_edges
        self.urand_edges = urand_edges
        self.run_program = run_program
        self.incremental = incremental
        self.superstep = superstep
        self.build = _build
        self.ell = _ell
        self.frontier_kernel = frontier_kernel
        self.spmv_kernel = spmv_kernel
        self.bfs_pull_ref = bfs_pull_ref
        self.bfs_pull_buckets_ref = bfs_pull_buckets_ref
        self.spmv_ell_ref = spmv_ell_ref
        self.spmv_ell_buckets_ref = spmv_ell_buckets_ref

    # the wrappers are read through their modules at each call
    def spmv_ell(self, *args, **kw):
        return self.spmv_kernel.spmv_ell(*args, **kw)

    def spmv_ell_buckets(self, *args, **kw):
        return self.spmv_kernel.spmv_ell_buckets(*args, **kw)

    def bfs_pull(self, *args):
        return self.frontier_kernel.bfs_pull(*args)

    def bfs_pull_buckets(self, *args, **kw):
        return self.frontier_kernel.bfs_pull_buckets(*args, **kw)

    def flash(self, *args, **kw):
        return self.flash_kernel.flash_attention_fwd(*args, **kw)

    def launches(self) -> dict:
        flash = self.flash_kernel.flash_attention_fwd
        return {"spmv_ell": self.spmv_kernel.spmv_ell.launches,
                "bfs_pull": self.frontier_kernel.bfs_pull.launches,
                "flash_attention_fwd": flash.launches,
                "flash_attention_fwd_tc": flash.launches_tc}

    def reset_launches(self) -> None:
        self.spmv_kernel.spmv_ell.launches = 0
        self.frontier_kernel.bfs_pull.launches = 0
        self.flash_kernel.flash_attention_fwd.launches = 0
        self.flash_kernel.flash_attention_fwd.launches_tc = 0


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def kernel_ms(torch, device, fn, reps: int = 20) -> float:
    """Mean ms of ``fn`` over ``reps`` back-to-back runs after one warm-up,
    from CUDA events on the card (host clock elsewhere)."""
    fn()
    _sync(torch, device)
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def median_ms(torch, device, fn, reps: int = 3) -> float:
    """Median host-clock ms of ``reps`` synchronized runs (the caller has
    warmed ``fn`` up)."""
    times = []
    for _ in range(reps):
        _sync(torch, device)
        t0 = time.perf_counter()
        fn()
        _sync(torch, device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(bytes_moved: int, ops: int,
          ops_per_s: float = CUDA_CORE_OPS_PER_S) -> tuple[float, str]:
    """Least ms the H100 could take: bytes over HBM rate vs operations
    over the peak rate for their type (the f32 CUDA-core rate unless
    given), whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# host references (numpy / scipy, independent of the port)
# ---------------------------------------------------------------------------

def out_matrix(edges: np.ndarray, n: int):
    """The graph as one scipy CSR matrix, src -> dst, parallel edges
    summed as multiplicities (float64): built once for every host
    check."""
    import scipy.sparse as sp
    return sp.csr_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])),
                         shape=(n, n))


def bfs_levels(m, root: int) -> np.ndarray:
    """BFS level of every vertex from ``root`` (-1 if unreached), one
    sparse in-neighbor matvec (``m.T``) per level."""
    n = m.shape[0]
    level = np.full(n, -1, np.int64)
    level[root] = 0
    frontier = np.zeros(n)
    frontier[root] = 1.0
    d = 0
    while frontier.any():
        d += 1
        new = ((m.T @ frontier) > 0) & (level < 0)
        level[new] = d
        frontier = new.astype(np.float64)
    return level


def min_level_parents(edges: np.ndarray, n: int, root: int,
                      level: np.ndarray) -> np.ndarray:
    """Per vertex, the smallest in-neighbor one BFS level up (INT_INF if
    unreached; the root is its own parent)."""
    src, dst = edges[:, 0], edges[:, 1]
    lu = level[src]
    up = (lu >= 0) & (level[dst] == lu + 1)
    key = np.sort(dst[up] * n + src[up])
    v = key // n
    first = np.ones(v.size, bool)
    first[1:] = v[1:] != v[:-1]
    parents = np.full(n, INT_INF, np.int64)
    parents[v[first]] = key[first] % n
    parents[root] = root
    return parents


def pagerank_f64(m, rounds: set) -> dict:
    """Float64 power iteration of the port's update (rank0 = 1/n,
    rank = (1-alpha)/n + alpha * sum of in-neighbors' rank/out_degree,
    no dangling redistribution); the ranks after each count in
    ``rounds``."""
    n = m.shape[0]
    out_deg = np.asarray(m.sum(axis=1)).ravel()
    inv = np.where(out_deg > 0, 1.0 / np.maximum(out_deg, 1.0), 0.0)
    base = (1.0 - ALPHA) / n
    r = np.full(n, 1.0 / n)
    out = {}
    for t in range(1, max(rounds) + 1):
        r = base + ALPHA * (m.T @ (r * inv))
        if t in rounds:
            out[t] = r.copy()
    return out


def max_rel(a: np.ndarray, b: np.ndarray) -> float:
    """Elementwise max |a - b| / |b| (b has no zeros: ranks >= base)."""
    return float(np.max(np.abs(a.astype(np.float64) - b) / np.abs(b)))


def sssp_dijkstra(m, root: int) -> np.ndarray:
    """Distances from ``root`` by scipy's Dijkstra under the port's
    synthesized weights ``1 + (src * 2654435761 ^ dst * 40503) % 2**16 /
    2**16`` (uint32 hash; its low 16 bits, exact in int64).  Parallel
    edges have equal weights, so the deduplicated pairs of ``m``'s
    pattern carry exactly the minimum weight of each pair (a CSR built
    from the edge list would add them); inf where unreached."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra
    n = m.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(m.indptr))
    h = (rows * 2654435761) ^ (m.indices.astype(np.int64) * 40503)
    w = sp.csr_matrix((1.0 + (h & 0xFFFF) / 65536.0, m.indices, m.indptr),
                      shape=(n, n))
    return dijkstra(w, directed=True, indices=root)


def undirected_matrix(m):
    """The undirected multigraph (m + m.T, self-loops dropped) as CSR."""
    u = (m + m.T).tocsr()
    u.setdiag(0)
    u.eliminate_zeros()
    return u


def min_id_components(u) -> np.ndarray:
    """Per vertex, the smallest vertex id of its weakly connected
    component (strong components of the symmetric ``u``)."""
    from scipy.sparse.csgraph import connected_components
    _, labels = connected_components(u, directed=True, connection="strong")
    _, first = np.unique(labels, return_index=True)
    return first[labels]


def core_numbers(u) -> tuple[np.ndarray, int]:
    """Core numbers of the undirected multigraph ``u`` by threshold
    peeling, and the peeling's round count: each round removes every
    alive vertex of degree <= k (core k) and, through its CSR row,
    decrements its neighbors once; a round that removes nothing advances
    k."""
    n = u.shape[0]
    deg = np.asarray(u.sum(axis=1)).ravel().astype(np.int64)
    alive = np.ones(n, bool)
    core = np.zeros(n, np.int64)
    k = rounds = 0
    while alive.any():
        rounds += 1
        kill = np.flatnonzero(alive & (deg <= k))
        if kill.size:
            core[kill] = k
            alive[kill] = False
            sub = u[kill]
            deg -= np.bincount(sub.indices, weights=sub.data,
                               minlength=n).astype(np.int64)
        else:
            k += 1
    return core, rounds


def brandes_f64(m, root: int):
    """Float64 Brandes from ``root`` on the directed multigraph ``m``
    (multiplicities are parallel shortest paths): (delta with delta(root)
    = 0, sigma, dist with INT_INF where unreached), one sparse matvec per
    level each way."""
    n = m.shape[0]
    dist = np.full(n, INT_INF, np.int64)
    dist[root] = 0
    sigma = np.zeros(n)
    sigma[root] = 1.0
    level = 0
    while True:
        fr = dist == level
        if not fr.any():
            break
        pushed = m.T @ (sigma * fr)
        newly = (pushed > 0) & (dist == INT_INF)
        dist[newly] = level + 1
        sigma[newly] = pushed[newly]
        level += 1
    delta = np.zeros(n)
    for lvl in range(level - 1, -1, -1):
        coef = np.where(dist == lvl + 1, (1.0 + delta)
                        / np.maximum(sigma, 1.0), 0.0)
        at = dist == lvl
        delta[at] = (sigma * (m @ coef))[at]
    delta[root] = 0.0
    return delta, sigma, dist


def triangle_counts(edges: np.ndarray, n: int) -> tuple[np.ndarray, int]:
    """Per-vertex triangles of the simple undirected graph (A o (A @ A),
    row sums halved) and the total, from scipy."""
    import scipy.sparse as sp
    a = sp.csr_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])),
                      shape=(n, n))
    a = ((a + a.T) > 0).astype(np.float64).tocsr()
    a.setdiag(0)
    a.eliminate_zeros()
    per = np.asarray(a.multiply(a @ a).sum(axis=1)).ravel() / 2
    per = per.astype(np.int64)
    return per, int(per.sum()) // 3


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def ptxas_entries(log_text: str, cxxfilt: str) -> list:
    """(kernel instantiation, registers, spill-store bytes) for each entry
    function in an ``nvcc -Xptxas -v`` log, the name as ``cu++filt``
    (beside nvcc) demangles it."""
    chunks = log_text.split("Compiling entry function '")[1:]
    mangled = [c.split("'", 1)[0] for c in chunks]
    names = subprocess.run(
        [cxxfilt], input="".join(m + "\n" for m in mangled),
        capture_output=True, text=True, check=True).stdout.splitlines()
    out = []
    for name, chunk in zip(names, chunks):
        regs = re.search(r"Used (\d+) registers", chunk)
        spills = re.search(r"(\d+) bytes spill stores", chunk)
        out.append((name,
                    int(regs.group(1)) if regs else None,
                    int(spills.group(1)) if spills else None))
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip()


def nonempty_buckets(port: Port, buckets, flat):
    """(row0, rows, (P, rows, K) view) of each non-empty ELL bucket."""
    for r0, rows, k, blk in port.ell.bucket_views(flat, buckets):
        if k:
            yield r0, rows, blk


SPMV_DESIGN = ("persistent grid, one launch per call; a thread per row "
               "(a warp per row past K = 64), 32 gathers in flight, "
               "16-byte index loads, slot-order __fadd_rn sums, L2 "
               "evict_last x / evict_first indices")
BFS_DESIGN = ("persistent grid, one launch per call; a thread per row "
              "(a warp per row past K = 64), ballot skip of tiles with no "
              "live row, 16 word loads in flight, L2 evict_last bitmap / "
              "evict_first ids")


class Parent:
    """The graph kernels of another checkout, on the same inputs as this
    checkout's.  Two C interfaces are known: the first design's, which
    exports no ``*_interface`` version and takes one bucket a launch
    (declared here), and this checkout's bucket table, run through this
    checkout's launchers.  ``bind`` raises on any other version, so a
    parent whose interface this script does not know fails at load."""

    def __init__(self, port: Port, root: str):
        csrc = Path(root).resolve() / "src" / "repro_torch" / "kernels"
        self.port = port
        self.src = {"parent_spmv_ell": csrc / "spmv" / "csrc" / "spmv_ell.cu",
                    "parent_bfs_pull": csrc / "frontier" / "csrc"
                    / "bfs_pull.cu"}
        for path in self.src.values():
            if not path.exists():
                raise SystemExit(f"chip_smoke: {path} not found")
        self.spmv_lib = self.bfs_lib = None
        self.table = False

    def extra_builds(self):
        return tuple(self.src.items())

    def load(self):
        import ctypes as c
        build = self.port.build
        self.spmv_lib = build.load("parent_spmv_ell", self.src["parent_spmv_ell"])
        self.bfs_lib = build.load("parent_bfs_pull", self.src["parent_bfs_pull"])
        versioned = [hasattr(self.spmv_lib, "spmv_ell_interface"),
                     hasattr(self.bfs_lib, "bfs_pull_interface")]
        if any(versioned):
            self.port.spmv_kernel.bind(self.spmv_lib)
            self.port.frontier_kernel.bind(self.bfs_lib)
            self.table = True
            return
        self.spmv_lib.spmv_ell_launch.argtypes = [
            c.c_void_p, c.c_longlong, c.c_void_p, c.c_longlong, c.c_void_p,
            c.c_longlong, c.c_void_p, c.c_int, c.c_int, c.c_int, c.c_int,
            c.c_void_p]
        self.bfs_lib.bfs_pull_launch.argtypes = [
            c.c_void_p, c.c_longlong, c.c_void_p, c.c_longlong, c.c_void_p,
            c.c_longlong, c.c_void_p, c.c_int, c.c_int, c.c_int, c.c_void_p]

    def _stream(self):
        return self.port.torch.cuda.current_stream().cuda_stream

    def spmv(self, flat, x, buckets, skip):
        """The parent's spmv_ell over a bucket table (skip form; x may
        have part stride 0) as (row0, (P, rows) output) blocks: one for
        a table launch, one a non-empty bucket for the first interface."""
        torch = self.port.torch
        p = flat.shape[0]
        if self.table:
            y = torch.empty((p, sum(r for r, _ in buckets)),
                            device=flat.device)
            self.port.spmv_kernel.launch(self.spmv_lib, flat, None, x, y,
                                         tuple(buckets), skip)
            return [(0, y)]
        out = []
        for r0, rows, blk in nonempty_buckets(self.port, buckets, flat):
            y = torch.empty((p, rows), device=flat.device)
            code = self.spmv_lib.spmv_ell_launch(
                blk.data_ptr(), blk.stride(0), None, 0, x.data_ptr(),
                x.stride(0), y.data_ptr(), p, rows, blk.shape[2], skip,
                self._stream())
            self.port.build.check(self.spmv_lib, "spmv_ell", code)
            out.append((r0, y))
        return out

    def flags(self, unv):
        """The flags as the parent takes them: int32 for the first
        interface."""
        return unv if self.table else unv.to(self.port.torch.int32)

    def bfs(self, flat, bits_g, unv, buckets, skip):
        """The parent's bfs_pull over a bucket table (bits_g with a zero
        guard word, which the first interface reads for the sentinel;
        unv from ``flags``) as (row0, (P, rows) parents) blocks."""
        torch = self.port.torch
        p = flat.shape[0]
        if self.table:
            out = torch.empty((p, sum(r for r, _ in buckets)),
                              dtype=torch.int32, device=flat.device)
            self.port.frontier_kernel.launch(self.bfs_lib, flat, bits_g, unv,
                                             out, tuple(buckets), skip)
            return [(0, out)]
        res = []
        for r0, rows, blk in nonempty_buckets(self.port, buckets, flat):
            out = torch.empty((p, rows), dtype=torch.int32,
                              device=flat.device)
            code = self.bfs_lib.bfs_pull_launch(
                blk.data_ptr(), blk.stride(0), bits_g.data_ptr(),
                bits_g.stride(0), unv[:, r0:].data_ptr(), unv.stride(0),
                out.data_ptr(), p, rows, blk.shape[2], self._stream())
            self.port.build.check(self.bfs_lib, "bfs_pull", code)
            res.append((r0, out))
        return res


def same_bits(torch, a, b) -> bool:
    """Equal shapes and bit patterns (float32 compared as int32)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = (t.contiguous().view(torch.int32) for t in (a, b))
    return torch.equal(a, b)


class Parity:
    """Kernel-vs-plain comparisons, bit for bit; keeps each kernel's max
    abs error (0 when they pass)."""

    def __init__(self, port: Port, device):
        self.port, self.device = port, device
        self.torch = port.torch
        self.err = {"spmv_ell": 0.0, "bfs_pull": 0.0}
        self.cases = {"spmv_ell": 0, "bfs_pull": 0}

    def _same(self, name, got, want, what):
        torch = self.torch
        _sync(torch, self.device)
        if not same_bits(torch, got, want):
            bad = int((got != want).sum()) if got.shape == want.shape else -1
            err = ((got.double() - want.double()).abs().max().item()
                   if got.shape == want.shape else float("nan"))
            raise AssertionError(f"{name} differs from its plain version in "
                                 f"{bad} rows (max abs {err:.3e}) at {what}")
        self.err[name] = max(self.err[name], float(
            (got.double() - want.double()).abs().max().item()))
        self.cases[name] += 1

    def spmv(self, idx, val, x, skip=None):
        got = self.port.spmv_ell(idx, val, x, skip=skip)
        self._same("spmv_ell", got,
                   self.port.spmv_ell_ref(idx, val, x, skip=skip),
                   tuple(idx.shape))
        return got

    def spmv_table(self, flat, x, buckets, skip):
        self._same("spmv_ell", self.port.spmv_ell_buckets(
            flat, None, x, buckets, skip=skip),
            self.port.spmv_ell_buckets_ref(flat, None, x, buckets,
                                           skip=skip), f"table {buckets}")

    def frontier(self, nbr, bits, unv):
        got = self.port.bfs_pull(nbr, bits, unv)
        self._same("bfs_pull", got, self.port.bfs_pull_ref(nbr, bits, unv),
                   tuple(nbr.shape))
        return got

    def frontier_table(self, flat, bits, unv, buckets, skip):
        self._same("bfs_pull", self.port.bfs_pull_buckets(
            flat, bits, unv, buckets, skip=skip),
            self.port.bfs_pull_buckets_ref(flat, bits, unv, buckets,
                                           skip=skip), f"table {buckets}")

    def sweep(self, rng):
        """The JAX package's kernel-test cases, unbatched and as strided
        batches (how local ops hand the kernels ELL buckets)."""
        torch, dev = self.torch, self.device

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        for batch in (1, 3):
            for rows, k, n_cols in SPMV_SWEEP:
                flat = t(rng.integers(0, n_cols, (batch, rows * k + 5))
                         .astype(np.int32))
                idx = flat[:, 2:2 + rows * k].reshape(batch, rows, k)
                val = t(rng.normal(size=(batch, rows, k)).astype(np.float32))
                x = t(rng.normal(size=(batch, n_cols)).astype(np.float32))
                self.spmv(idx, val, x)
                self.spmv(idx, None, x, skip=7)
            for rows, k, n_cols in FRONTIER_SWEEP:
                flat = t(rng.integers(0, n_cols, (batch, rows * k + 5))
                         .astype(np.int32))
                nbr = flat[:, 2:2 + rows * k].reshape(batch, rows, k)
                bits = t(rng.integers(-2 ** 31, 2 ** 31,
                                      (batch, n_cols // 32 + 1))
                         .astype(np.int32))
                unv = t(rng.integers(0, 2, (batch, rows)).astype(np.int32))
                self.frontier(nbr, bits, unv)
        # bf16-valued inputs, computed in f32 by both
        idx = t(rng.integers(0, 512, (1, 256, 8)).astype(np.int32))
        val = t(rng.normal(size=(1, 256, 8)).astype(np.float32)) \
            .to(torch.bfloat16).float()
        x = t(rng.normal(size=(1, 512)).astype(np.float32)) \
            .to(torch.bfloat16).float()
        self.spmv(idx, val, x)
        # zero-padded slots contribute nothing
        zero = self.spmv(torch.zeros((1, 128, 4), dtype=torch.int32,
                                     device=dev),
                         torch.zeros((1, 128, 4), device=dev),
                         t(rng.normal(size=(1, 128)).astype(np.float32)))
        check(bool((zero == 0).all()), "zero-padded spmv is not 0")
        # visited rows are INT_INF
        nbr = t(rng.integers(0, 256, (1, 128, 4)).astype(np.int32))
        bits = t(rng.integers(-2 ** 31, 2 ** 31, (1, 9)).astype(np.int32))
        out = self.frontier(nbr, bits, torch.zeros((1, 128),
                                                   dtype=torch.int32,
                                                   device=dev))
        check(bool((out == INT_INF).all()), "visited rows must be INT_INF")
        # the smallest in-frontier neighbor wins
        words = np.zeros((1, 3), np.int64)
        for v in (5, 9, 40):
            words[0, v // 32] |= 1 << (v % 32)
        words = np.where(words >= 2 ** 31, words - 2 ** 32, words)
        out = self.frontier(
            t(np.tile(np.array([40, 9, 5, 63], np.int32), (1, 128, 1))),
            t(words.astype(np.int32)),
            torch.ones((1, 128), dtype=torch.int32, device=dev))
        check(bool((out == 5).all()), "min-id parent selection")
        # a multi-bucket table: widths 40 to 0, rows no multiple of 32, a
        # strided batch of parts sharing x (part stride 0), sentinels
        table = ((64, 40), (96, 24), (45, 16), (50, 8), (20, 0))
        n_cols, slots = 5000, sum(r * k for r, k in table)
        store = t(rng.integers(0, n_cols, (3, slots + 8)).astype(np.int32))
        store[:, 1::9] = n_cols
        flat = store[:, 4:4 + slots]
        x = t(rng.normal(size=(1, n_cols)).astype(np.float32)).expand(3, -1)
        self.spmv_table(flat, x, table, n_cols)
        bits = t(rng.integers(-2 ** 31, 2 ** 31, (1, n_cols // 32 + 1))
                 .astype(np.int32)).expand(3, -1)
        unv = t(rng.integers(0, 2, (3, sum(r for r, _ in table)))
                .astype(np.uint8))
        unv[:, 64:96] = 0                       # an all-dead warp tile
        self.frontier_table(flat, bits, unv, table, n_cols)
        self.frontier_table(flat, bits, unv.to(torch.int32), table, n_cols)

    def graph_buckets(self, g, garr, rng):
        """Every ELL bucket a path hands a kernel, alone: ell_in (spmv and
        bfs_pull), ell_dst, ell_out (betweenness's two combines) and
        ell_src (spmv); then each structure in one multi-bucket call as
        the paths make it (x with no pad slot, the bitmap with no guard
        word, uint8 flags).  Random x, bits and flags."""
        torch, dev = self.torch, self.device
        p = g.parts
        shapes = []
        bits_g = torch.randint(-2 ** 31, 2 ** 31 - 1, (1, g.n // 32 + 1),
                               dtype=torch.int32, device=dev)
        for name in ("ell_in", "ell_dst", "ell_out", "ell_src"):
            meta = g.ell_meta[name]
            flat = garr[f"{name}_idx"]
            # ell_in gathers all-gathered contributions (one vector for
            # every part, as broadcast_global gives it); the edge-position
            # structures per-edge values of each part
            x = torch.rand((1 if name == "ell_in" else p, meta.sentinel),
                           device=dev).expand(p, -1)
            unv = torch.randint(0, 2, (p, meta.n_rows), dtype=torch.uint8,
                                device=dev)
            for r0, rows, blk in nonempty_buckets(self.port, meta.buckets,
                                                  flat):
                self.spmv(blk, None, x, skip=meta.sentinel)
                if name == "ell_in":
                    self.frontier(blk, bits_g.expand(p, -1),
                                  unv[:, r0:r0 + rows].to(torch.int32))
                shapes.append((name, tuple(blk.shape)))
            self.spmv_table(flat, x, meta.buckets, meta.sentinel)
            if name == "ell_in":
                self.frontier_table(flat, bits_g[:, :-1].expand(p, -1), unv,
                                    meta.buckets, meta.sentinel)
        return shapes


def run_programs(port: Port, eng, garr, mode: str) -> dict:
    """The four programs once each under local-ops ``mode``; per program
    the host field, rounds and kernel launches."""
    torch = port.torch
    res = {}
    with port.localops.using(mode):
        progs = {a + "/" + v: (eng.program(a, v), a) for a, v in PROGRAMS}
    for key, (prog, algo) in progs.items():
        before = port.launches()
        *outs, rounds = prog(garr, *((ROOT,) if algo == "bfs" else ()))
        _sync(torch, eng.device)
        after = port.launches()
        res[key] = {"field": eng.gather_vertex_field(outs[0]),
                    "rounds": int(rounds), "prog": prog,
                    "launches": {k: after[k] - before[k] for k in after}}
    return res


def rate(gathers: int, ms: float) -> str:
    """Gathers per second, in G/s."""
    return f"{gathers / ms / 1e6:.1f} G/s"


def kernel_times(port: Port, g, garr, level: np.ndarray, device,
                 parent: Parent | None) -> dict:
    """Each kernel at this graph's main-path inputs, beside its plain
    version, its bound and its library call: spmv_ell over one local-ops
    call per structure (a PageRank round over ell_in or ell_dst, a
    betweenness backward round over ell_out), whole and bucket by bucket;
    bfs_pull over every call of one bfs/fast run, round by round.  With
    ``parent``, the parent's kernels on the same inputs, each result
    checked before it is timed."""
    torch = port.torch
    p, n = g.parts, g.n
    out = {}
    gen = torch.Generator(device=device).manual_seed(SEED)

    for name in ("ell_in", "ell_dst", "ell_out"):
        meta = g.ell_meta[name]
        flat, skip, rows = garr[f"{name}_idx"], meta.sentinel, meta.n_rows
        # as the paths: ell_in gathers one all-gathered vector (part
        # stride 0), ell_dst (pagerank/fast, betweenness forward) and
        # ell_out (betweenness backward) each part's per-edge values; no
        # pad slot
        x = torch.rand((1 if name == "ell_in" else p, skip), device=device,
                       generator=gen).expand(p, -1)
        gathers = int((flat != skip).sum())

        def kern(flat=flat, x=x, meta=meta):
            return port.spmv_ell_buckets(flat, None, x, meta.buckets,
                                         skip=meta.sentinel)

        def plain(flat=flat, x=x, meta=meta):
            return port.spmv_ell_buckets_ref(flat, None, x, meta.buckets,
                                             skip=meta.sentinel)

        # the same y as one CSR matvec: rows of part q at q * rows, its
        # columns at q * n_cols unless x is one vector for all parts
        shared = x.stride(0) == 0
        r_idx, c_idx = [], []
        part = torch.arange(p, device=device)[:, None, None]
        for r0, br, blk in nonempty_buckets(port, meta.buckets, flat):
            keep = blk != skip
            row = part * rows + r0 + torch.arange(
                br, device=device)[None, :, None]
            r_idx.append(row.expand(blk.shape)[keep])
            c_idx.append((blk.long() + (0 if shared else part * skip))[keep])
        with warnings.catch_warnings():     # torch.sparse's beta notices
            warnings.simplefilter("ignore", UserWarning)
            coo = torch.sparse_coo_tensor(
                torch.stack([torch.cat(r_idx), torch.cat(c_idx)]),
                torch.ones(gathers, device=device),
                (p * rows, skip if shared else p * skip))
            csr = coo.coalesce().to_sparse_csr()
        del coo, r_idx, c_idx
        xf = x[0] if shared else x.reshape(-1)

        def library(csr=csr, xf=xf):
            return csr @ xf

        y = kern()
        torch.testing.assert_close(library().reshape(p, rows), y,
                                   rtol=SPMV_TOL, atol=SPMV_TOL)
        idx_bytes = 4 * flat.numel()
        b_ms, b_by = bound(idx_bytes + x.untyped_storage().nbytes()
                           + 4 * p * rows, gathers)
        cell = {"ms": kernel_ms(torch, device, kern),
                "plain_ms": kernel_ms(torch, device, plain, reps=5),
                "library_ms": kernel_ms(torch, device, library),
                "bound_ms": b_ms, "bound_by": b_by,
                "timed_launches": len(port.ell.launch_tables(meta.buckets)),
                "rows": p * rows, "slots": flat.numel(), "gathers": gathers}
        del csr
        if x.untyped_storage().nbytes() > L2_BYTES:
            # x past L2: each gather moves a 32-byte HBM sector at least
            cell["sector_bound_ms"] = (idx_bytes + HBM_SECTOR * gathers
                                       + 4 * p * rows) / HBM_BYTES_PER_S * 1e3
        log(f"[times] parts={p} spmv_ell/{name}: one call {cell['ms']:.4f} ms"
            f" ({rate(gathers, cell['ms'])}, {gathers:,} gathers)")
        buckets_out = []
        # the parent's results are held against the plain version (within
        # SPMV_TOL: the first design adds a row's slots in another order)
        want = plain() if parent is not None else None
        for r0, br, blk in nonempty_buckets(port, meta.buckets, flat):
            gb = int((blk != skip).sum())
            line = {"rows": p * br, "K": blk.shape[2], "gathers": gb,
                    "ms": kernel_ms(torch, device,
                                    lambda blk=blk, x=x, skip=skip:
                                    port.spmv_ell(blk, None, x, skip=skip))}
            msg = (f"[bucket] parts={p} spmv_ell/{name} rows={p * br} "
                   f"K={blk.shape[2]}: new {line['ms']:.4f} ms "
                   f"({rate(gb, line['ms'])})")
            if parent is not None:
                one = (blk.flatten(1), x, ((br, blk.shape[2]),), skip)
                (_, got), = parent.spmv(*one)
                torch.testing.assert_close(
                    got, want[:, r0:r0 + br], rtol=SPMV_TOL, atol=SPMV_TOL,
                    msg=lambda m: f"the parent's spmv_ell at {blk.shape}: {m}")
                line["old_ms"] = kernel_ms(
                    torch, device, lambda one=one: parent.spmv(*one))
                msg += f"; old {line['old_ms']:.4f} ms " \
                       f"({rate(gb, line['old_ms'])})"
            buckets_out.append(line)
            log(msg)
        cell["buckets"] = buckets_out
        if parent is not None:
            call = (flat, x, meta.buckets, skip)
            for r0, got in parent.spmv(*call):
                torch.testing.assert_close(
                    got, want[:, r0:r0 + got.shape[1]], rtol=SPMV_TOL,
                    atol=SPMV_TOL,
                    msg=lambda m: f"the parent's spmv_ell/{name}: {m}")
            cell["old_ms"] = kernel_ms(torch, device,
                                       lambda call=call: parent.spmv(*call))
            log(f"[times] parts={p} spmv_ell/{name}: the parent's "
                f"{cell['old_ms']:.4f} ms")
        out[f"spmv_ell/{name}"] = cell

    # bfs_pull over one bfs/fast run: each round's call rebuilt from the
    # BFS levels.  Round r reads the bitmap of level r - 1; a push round
    # (previous count under the pull threshold) passes the activated rows
    # (level r), a pull round every row not yet visited (level >= r).
    meta = g.ell_meta["ell_in"]
    flat = garr["ell_in_idx"]
    thresh = max(1, int(n * port.registry.get_spec("bfs", "fast")
                        .defaults["pull_threshold"]))
    lvl = np.full(n, INT_INF, np.int64)
    lvl[:level.size] = np.where(level >= 0, level, INT_INF)
    lvl = torch.from_numpy(lvl).to(device)
    perm = garr["ell_in_perm"].long()
    views = list(port.ell.bucket_views(flat, meta.buckets))
    # per ELL row: its width and its filled (non-sentinel) slots
    width = torch.cat([torch.full((p, rows), k, device=device)
                       for _, rows, k, _ in views], dim=1)
    fill = torch.cat([(blk != n).sum(dim=2) if k else
                      torch.zeros((p, rows), dtype=torch.int64,
                                  device=device)
                      for _, rows, k, blk in views], dim=1)
    rounds = []
    for r in range(1, int(level.max()) + 2):
        push = int((lvl == r - 1).sum()) < thresh
        rows_in = (lvl == r) if push else (lvl >= r)
        bits = port.pack_bits(lvl == r - 1)
        unv = torch.gather(rows_in.reshape(p, g.n_local).to(torch.uint8), 1,
                           perm)
        rounds.append({"mode": "u" if push else "l",
                       "bits": bits[None].expand(p, -1), "unv": unv,
                       "bits_g": torch.cat([bits, bits.new_zeros(1)])[None]
                       .expand(p, -1),
                       "live_rows": int(unv.sum()),
                       "gathers": int((fill * unv).sum()),
                       "live_slots": int((width * unv).sum())})

    def call(rd):
        return port.bfs_pull_buckets(flat, rd["bits"], rd["unv"],
                                     meta.buckets, skip=n)

    def kern():
        return [call(rd) for rd in rounds]

    def plain():
        return [port.bfs_pull_buckets_ref(flat, rd["bits"], rd["unv"],
                                          meta.buckets, skip=n)
                for rd in rounds]

    check(all(torch.equal(a, b) for a, b in zip(kern(), plain())),
          "bfs_pull differs from its plain version on the BFS rounds")
    per_round = []
    for i, rd in enumerate(rounds, 1):
        line = {k: rd[k] for k in ("mode", "live_rows", "gathers",
                                   "live_slots")}
        line["ms"] = kernel_ms(torch, device, lambda rd=rd: call(rd))
        msg = (f"[round] parts={p} bfs_pull round {i} {rd['mode']} "
               f"live_rows={rd['live_rows']:,} gathers={rd['gathers']:,}: "
               f"new {line['ms']:.4f} ms ({rate(rd['gathers'], line['ms'])})")
        if parent is not None:
            old = (flat, rd["bits_g"], parent.flags(rd["unv"]), meta.buckets,
                   n)
            want = call(rd)
            check(all(torch.equal(got, want[:, r0:r0 + got.shape[1]])
                      for r0, got in parent.bfs(*old)),
                  f"the parent's bfs_pull differs in round {i}")
            line["old_ms"] = kernel_ms(torch, device,
                                       lambda old=old: parent.bfs(*old))
            msg += (f"; old {line['old_ms']:.4f} ms "
                    f"({rate(rd['gathers'], line['old_ms'])})")
        per_round.append(line)
        log(msg)
    live_slots = sum(rd["live_slots"] for rd in rounds)
    gathers = sum(rd["gathers"] for rd in rounds)
    n_rows = meta.n_rows
    b_ms, b_by = bound(len(rounds) * (4 * (n // 32) + 5 * p * n_rows)
                       + 4 * live_slots, live_slots)
    cell = {"ms": kernel_ms(torch, device, kern),
            "plain_ms": kernel_ms(torch, device, plain, reps=5),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "timed_launches": len(rounds) * len(
                port.ell.launch_tables(meta.buckets)),
            "rows": p * n_rows, "live_slots": live_slots,
            "gathers": gathers,
            "rounds": "".join(rd["mode"] for rd in rounds),
            "per_round": per_round}
    if parent is not None:
        cell["old_ms"] = sum(line["old_ms"] for line in per_round)
    log(f"[times] parts={p} bfs_pull: one run {cell['ms']:.4f} ms "
        f"({rate(gathers, cell['ms'])}, {gathers:,} gathers)")
    out["bfs_pull/ell_in"] = cell
    return out


def run(graph: str, parts_list, device, parent_root: str | None = None) \
        -> dict:
    port = Port()
    torch = port.torch
    rng = np.random.default_rng(SEED)
    port.localops.set_mode("auto")
    on_card = torch.device(device).type == "cuda"
    parent = Parent(port, parent_root) if parent_root else None

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    extra = parent.extra_builds() if parent is not None else ()
    logs = port.build.build_all(extra) if on_card else {}
    log(f"[build] {len(logs)} builds in {time.perf_counter() - t0:.1f} s")
    cxxfilt = os.path.join(os.path.dirname(port.build._nvcc()), "cu++filt") \
        if logs else ""
    for name, text in logs.items():
        for entry, regs, spills in ptxas_entries(text, cxxfilt):
            log(f"[build] {name}: {entry}: {regs} registers, {spills} bytes "
                f"spill stores")
        for line in text.splitlines():
            if "warning" in line.lower() or "serialized" in line:
                log(f"[build] {name}: {line.strip()}")

    if parent is not None:
        parent.load()

    # -- parity: test sweeps -------------------------------------------------
    parity = Parity(port, device)
    parity.sweep(rng)
    log(f"[parity] test sweeps ok: {parity.cases} "
        f"max_abs_err={parity.err}")

    # -- graph ---------------------------------------------------------------
    gcfg = port.graph_workloads.ALL[graph]
    n = gcfg.num_vertices
    t0 = time.perf_counter()
    edges = port.generate_edges(gcfg, SEED)
    log(f"[graph] {graph}: {n:,} vertices, {len(edges):,} edges in "
        f"{time.perf_counter() - t0:.1f} s")
    engines = {}
    for parts in parts_list:
        t0 = time.perf_counter()
        g = port.partition_graph(edges, n, parts)
        t1 = time.perf_counter()
        eng = port.GraphEngine(g, device=device)
        garr = eng.device_graph()
        _sync(torch, device)
        nbytes = sum(t.numel() * t.element_size() for t in garr.values())
        log(f"[graph] parts={parts}: partitioned in {t1 - t0:.1f} s, "
            f"{nbytes / 2 ** 30:.2f} GiB on the device in "
            f"{time.perf_counter() - t1:.1f} s; buckets "
            + " ".join(f"{k}={list(m.buckets)}"
                       for k, m in g.ell_meta.items()
                       if k in ("ell_in", "ell_dst")))
        engines[parts] = (g, eng, garr)
        shapes = parity.graph_buckets(g, garr, rng)
        log(f"[parity] parts={parts}: {len(shapes)} ELL bucket shapes ok")
    log(f"[parity] max_abs_err={parity.err} cases={parity.cases}")
    parity_err = dict(parity.err)

    # -- main path -----------------------------------------------------------
    port.reset_launches()
    main = {parts: run_programs(port, eng, garr, "auto")
            for parts, (_, eng, garr) in engines.items()}
    main_launches = port.launches()
    log(f"[main] launches {main_launches}")
    # one launch per local-ops call (more only past MAX_BUCKETS buckets):
    # spmv_pull is a pagerank/bsp round, scatter_combine(add) a
    # pagerank/fast round, frontier_pull a bfs/fast round
    want = {"spmv_ell": 0, "bfs_pull": 0}
    for parts, res in main.items():
        g = engines[parts][0]
        tables = {k: len(port.ell.launch_tables(g.ell_meta[k].buckets))
                  for k in ("ell_in", "ell_dst")}
        per_prog = {"bfs/bsp": {},
                    "bfs/fast": {"bfs_pull": tables["ell_in"]},
                    "pagerank/bsp": {"spmv_ell": tables["ell_in"]},
                    "pagerank/fast": {"spmv_ell": tables["ell_dst"]}}
        for key, r in res.items():
            log(f"[main] parts={parts} {key:14s} rounds={r['rounds']:3d} "
                f"launches={r['launches']}")
            for name in want:
                calls = r["rounds"] * per_prog[key].get(name, 0)
                want[name] += calls
                check(r["launches"][name] == calls,
                      f"parts={parts} {key}: {name} launched "
                      f"{r['launches'][name]} times, want {calls} (one per "
                      f"local-ops call)")
    for name, calls in want.items():
        check(main_launches[name] == calls > 0,
              f"{name}: {main_launches[name]} main-path launches, want "
              f"{calls}")
    log(f"[main] one launch per local-ops call: {want}")

    t0 = time.perf_counter()
    m = out_matrix(edges, n)
    level = bfs_levels(m, ROOT)
    want_parents = min_level_parents(edges, n, ROOT, level)
    reached = int((level >= 0).sum())
    log(f"[check] scipy BFS: {reached:,} reached, {int(level.max())} levels, "
        f"{time.perf_counter() - t0:.1f} s")
    first = main[parts_list[0]]
    for parts, res in main.items():
        for key in ("bfs/bsp", "bfs/fast"):
            got = res[key]["field"]
            check(np.array_equal(got, first["bfs/bsp"]["field"]),
                f"parts={parts} {key} parents differ from bfs/bsp "
                f"parts={parts_list[0]}")
            check(np.array_equal((got < INT_INF), level >= 0),
                f"parts={parts} {key}: reachability differs from scipy")
            check(np.array_equal(got, want_parents),
                f"parts={parts} {key}: a parent is not the min-id "
                f"in-neighbor one level up")
        for key, r in res.items():
            check(r["rounds"] == first[key]["rounds"],
                f"{key}: rounds {r['rounds']} at parts={parts} vs "
                f"{first[key]['rounds']} at parts={parts_list[0]}")
    log(f"[check] BFS parents: bsp == fast == scipy min-id level parents "
        f"at parts {list(parts_list)}")

    t0 = time.perf_counter()
    pr_rounds = {first[k]["rounds"] for k in ("pagerank/bsp",
                                              "pagerank/fast")}
    want_ranks = pagerank_f64(m, pr_rounds)
    pr_err = {}
    for parts, res in main.items():
        for key in ("pagerank/bsp", "pagerank/fast"):
            err = max_rel(res[key]["field"], want_ranks[res[key]["rounds"]])
            pr_err[f"{key}/{parts}"] = err
            check(err < PR_F64_TOL,
                f"parts={parts} {key}: max rel err {err:.3e} vs float64")
        a, b = res["pagerank/bsp"]["field"], res["pagerank/fast"]["field"]
        log(f"[check] parts={parts} PageRank bsp-vs-fast max rel diff: "
            f"{np.abs(a - b).max() / a.max():.2e}")
    log(f"[check] PageRank vs float64 scipy power iteration, max rel err "
        f"{ {k: f'{v:.2e}' for k, v in pr_err.items()} } "
        f"({time.perf_counter() - t0:.1f} s)")

    # -- plain path on the card ---------------------------------------------
    plain = {}
    for parts, (_, eng, garr) in engines.items():
        plain[parts] = res_p = run_programs(port, eng, garr, "ell")
        for key, r in res_p.items():
            k = main[parts][key]
            check(r["rounds"] == k["rounds"],
                f"plain parts={parts} {key}: rounds {r['rounds']} vs "
                f"kernel {k['rounds']}")
            check(sum(r["launches"].values()) == 0, "plain mode launched")
            a, b = np.asarray(r["field"]), np.asarray(k["field"])
            check(a.dtype == b.dtype and a.shape == b.shape
                  and a.tobytes() == b.tobytes(),
                  f"plain parts={parts} {key}: "
                  + ("parents" if key.startswith("bfs") else "ranks")
                  + " differ from the kernels' (max abs "
                  f"{np.abs(a.astype(np.float64) - b).max():.3e})")
    log("[plain] mode ell on the card: parents and ranks bit-identical to "
        "the kernels', rounds equal")

    # -- times ---------------------------------------------------------------
    program_ms = {}
    for parts, (_, eng, garr) in engines.items():
        for algo, variant in PROGRAMS:
            key = f"{algo}/{variant}"
            args = (garr,) + ((ROOT,) if algo == "bfs" else ())
            kp, pp = main[parts][key]["prog"], plain[parts][key]["prog"]
            cell = {"rounds": main[parts][key]["rounds"],
                    "ms": median_ms(torch, device, lambda: kp(*args)),
                    "plain_ms": median_ms(torch, device, lambda: pp(*args)),
                    "launches": main[parts][key]["launches"]}
            program_ms[f"{key}/parts={parts}"] = cell
            log(f"[times] parts={parts} {key:14s} rounds={cell['rounds']:3d}"
                f" kernels {cell['ms']:9.2f} ms   plain {cell['plain_ms']:9.2f}"
                f" ms")
    kernel_cells = {}
    for parts, (g, _, garr) in engines.items():
        for key, cell in kernel_times(port, g, garr, level, device,
                                      parent).items():
            kernel_cells[f"{key}/parts={parts}"] = cell
            log(f"[times] parts={parts} {key:16s} kernel {cell['ms']:.4f} ms"
                f"  plain {cell['plain_ms']:.4f} ms  bound "
                f"{cell['bound_ms']:.4f} ms ({cell['bound_by']})"
                + (f"  sector bound {cell['sector_bound_ms']:.4f} ms"
                   if "sector_bound_ms" in cell else "")
                + f"  library {cell['library_ms']} ms  timed launches "
                f"{cell['timed_launches']}"
                + (f"  old design {cell['old_ms']:.4f} ms"
                   if "old_ms" in cell else ""))
    log("[times] " + json.dumps({"graph": graph, "programs": program_ms,
                                 "kernels": kernel_cells}, default=str))

    # -- the rest of the BSP suite and multi-source -----------------------
    bsp = run_bsp(port, m, engines, device)
    # -- async supersteps and the incremental programs -------------------
    asy = run_async(port, m, engines, main, bsp, program_ms)
    return {"launches": main_launches, "parity_err": parity_err,
            "kernel_cells": kernel_cells, "parts": max(parts_list),
            "bsp_launches": bsp["launches"],
            "multi_launches": bsp["multi_launches"],
            "async_launches": asy["launches"],
            "inc_launches": asy["inc_launches"]}

def suite_fields(eng, prog, outs) -> dict:
    """Output name -> host value (vertex fields gathered to numpy)."""
    p = prog.program
    return {nm: (eng.gather_vertex_field(o) if isv else o)
            for nm, o, isv in zip(p.output_names, outs, p.output_is_vertex)}


def run_suite(port: Port, eng, garr, mode: str, algos) -> dict:
    """Each program once under local-ops ``mode`` (rooted ones from ROOT);
    per program its fields, rounds, kernel launches and program."""
    torch = port.torch
    res = {}
    with port.localops.using(mode):
        progs = {a: eng.program(a) for a in algos}
    for algo, prog in progs.items():
        args = (ROOT,) * len(prog.spec.inputs)
        before = port.launches()
        *outs, rounds = prog(garr, *args)
        _sync(torch, eng.device)
        after = port.launches()
        res[algo] = {"fields": suite_fields(eng, prog, outs),
                     "rounds": rounds, "prog": prog, "args": args,
                     "launches": {k: after[k] - before[k] for k in after}}
    return res


def same_fields(a: dict, b: dict) -> bool:
    """Equal names, and each value bit for bit (numpy) or equal (host
    scalar)."""
    return a.keys() == b.keys() and all(
        (isinstance(a[k], np.ndarray) and a[k].dtype == b[k].dtype
         and a[k].tobytes() == b[k].tobytes())
        or (not isinstance(a[k], np.ndarray) and a[k] == b[k]) for k in a)


def close(what: str, got, want, rtol: float, atol: float) -> float:
    """Raise unless |got - want| <= atol + rtol |want| everywhere; the
    largest |got - want| / |want| over nonzero ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    with np.errstate(invalid="ignore"):
        diff = np.where(got == want, 0.0, diff)       # equal infinities
    bad = int((diff > atol + rtol * np.abs(want)).sum())
    nz = np.abs(want) > 0
    rel = float((diff[nz] / np.abs(want[nz])).max()) if nz.any() else 0.0
    check(bad == 0, f"{what}: {bad} entries beyond rtol {rtol:.2e} atol "
                    f"{atol:.2e} (max rel {rel:.3e}, max abs "
                    f"{float(diff.max()):.3e})")
    return rel


def program_times(port: Port, eng, garr, runs: dict) -> dict:
    """Median ms of 3 synchronized calls of each run's program (the
    checked call was the warm-up)."""
    torch = port.torch
    return {algo: median_ms(torch, eng.device,
                            lambda r=r: r["prog"](garr, *r["args"]))
            for algo, r in runs.items()}


def run_bsp(port: Port, m, engines: dict, device) -> dict:
    """The rest of the BSP suite on the card: sssp, cc, kcore and
    betweenness on the main path's partitions, triangles on a TRI_N-vertex
    urand graph, each in local-ops modes auto and ell; then bfs/fast,
    sssp and betweenness batched over MULTI_ROOTS.  Checks against
    independent host references (numpy / scipy), bit-identity between the
    modes, spmv_ell's launch count on betweenness, and batched rows
    against single-source runs."""
    torch = port.torch
    t_phase = time.perf_counter()

    # -- host references -------------------------------------------------
    t0 = time.perf_counter()
    u = undirected_matrix(m)
    want_dist = sssp_dijkstra(m, ROOT)
    want_labels = min_id_components(u)
    want_core, want_kcore_rounds = core_numbers(u)
    want_bc, want_sigma, want_bdist = brandes_f64(m, ROOT)
    del u
    levels = int(want_bdist[want_bdist < INT_INF].max())
    log(f"[bsp] host references in {time.perf_counter() - t0:.1f} s: "
        f"dijkstra {int(np.isfinite(want_dist).sum()):,} reached; "
        f"{len(np.unique(want_labels)):,} components; kmax "
        f"{int(want_core.max())} in {want_kcore_rounds} peeling rounds; "
        f"Brandes {levels} levels, max sigma {want_sigma.max():.4g}")

    # -- the programs in mode auto: the path, counts zeroed around it ----
    algos = BSP_PROGRAMS
    port.reset_launches()
    auto = {parts: run_suite(port, eng, garr, "auto", algos)
            for parts, (_, eng, garr) in engines.items()}
    launches = port.launches()
    log(f"[bsp] launches {launches}")

    # -- mode ell: bit-identical; the betweenness phases split -----------
    plain, errs, want_spmv = {}, {}, 0
    for parts, (g, eng, garr) in engines.items():
        plain[parts] = run_suite(port, eng, garr, "ell", algos)
        tables = {k: len(port.ell.launch_tables(g.ell_meta[k].buckets))
                  for k in ("ell_dst", "ell_out")}
        fwd, back = auto[parts]["betweenness"]["prog"].program.phases
        with port.localops.using("ell"):
            (dist1, sigma1), r_f = port.run_program(fwd, garr, ROOT)
            _, r_b = port.run_program(back, garr, dist1, sigma1)
        for algo in algos:
            a, p = auto[parts][algo], plain[parts][algo]
            check(a["rounds"] == p["rounds"],
                  f"parts={parts} {algo}: rounds {a['rounds']} (auto) vs "
                  f"{p['rounds']} (ell)")
            check(same_fields(a["fields"], p["fields"]),
                  f"parts={parts} {algo}: outputs differ between modes auto "
                  f"and ell")
            check(sum(p["launches"].values()) == 0, "mode ell launched")
            calls = r_f * tables["ell_dst"] + r_b * tables["ell_out"] \
                if algo == "betweenness" else 0
            want_spmv += calls
            check(a["launches"]["spmv_ell"] == calls
                  and a["launches"]["bfs_pull"] == 0,
                  f"parts={parts} {algo}: launches {a['launches']}, want "
                  f"spmv_ell {calls} and bfs_pull 0")
        check(r_f + r_b == auto[parts]["betweenness"]["rounds"],
              f"parts={parts} betweenness: phases {r_f} + {r_b} rounds")
        log(f"[bsp] parts={parts} betweenness: {r_f} forward x "
            f"{tables['ell_dst']} + {r_b} backward x {tables['ell_out']} "
            f"spmv_ell launches, as counted; all programs bit-identical "
            f"between modes auto and ell")

        # -- against the host references -----------------------------------
        f = auto[parts]
        dist = f["sssp"]["fields"]["dist"]
        errs[f"sssp/{parts}"] = close(
            f"parts={parts} sssp dist vs dijkstra",
            np.where(dist >= 1e29, np.inf, dist), want_dist, SSSP_RTOL,
            SSSP_ATOL)
        check(np.array_equal(f["cc"]["fields"]["labels"], want_labels),
              f"parts={parts} cc: labels differ from the min vertex id of "
              f"each weakly connected component")
        kc = f["kcore"]
        cap = kc["prog"].program.max_rounds
        check(want_kcore_rounds <= cap,
              f"parts={parts} kcore stopped at max_rounds={cap} with "
              f"vertices alive (host peeling takes {want_kcore_rounds})")
        check(np.array_equal(kc["fields"]["core"], want_core)
              and kc["fields"]["kmax"] == int(want_core.max())
              and kc["rounds"] == want_kcore_rounds,
              f"parts={parts} kcore: cores, kmax {kc['fields']['kmax']} or "
              f"rounds {kc['rounds']} differ from host peeling "
              f"({int(want_core.max())}, {want_kcore_rounds} rounds)")
        bc = f["betweenness"]["fields"]
        check(np.array_equal(bc["dist"], want_bdist),
              f"parts={parts} betweenness: dist differs from host BFS")
        # sigma: path counts are integers, exact in float32 below 2**24
        check(want_sigma.max() < 2 ** 24,
              f"max sigma {want_sigma.max():.4g} past float32's exact "
              f"integers: SIGMA_RTOL needs the float32 error bound")
        errs[f"sigma/{parts}"] = close(
            f"parts={parts} betweenness sigma vs float64 Brandes",
            bc["sigma"], want_sigma, SIGMA_RTOL, 0.0)
        errs[f"bc/{parts}"] = close(
            f"parts={parts} betweenness bc vs float64 Brandes", bc["bc"],
            want_bc, BC_TOL, BC_TOL)
        check(bc["bc"][ROOT] == 0.0, "betweenness: delta_s(s) != 0")
        log(f"[bsp] parts={parts}: sssp == dijkstra (max rel "
            f"{errs[f'sssp/{parts}']:.3e}), cc == min-id components, kcore "
            f"== host peeling, betweenness sigma max rel "
            f"{errs[f'sigma/{parts}']:.3e} (tol {SIGMA_RTOL}), bc max rel "
            f"{errs[f'bc/{parts}']:.3e} (tol {BC_TOL})")
    check(launches["spmv_ell"] == want_spmv > 0
          and launches["bfs_pull"] == 0,
          f"bsp path: spmv_ell {launches['spmv_ell']} launches, want "
          f"{want_spmv}; bfs_pull {launches['bfs_pull']}, want 0")

    # -- triangles on a graph inside its n_budget --------------------------
    tri_edges = port.urand_edges(TRI_N, 16 * TRI_N, SEED)
    want_tri, want_total = triangle_counts(tri_edges, TRI_N)
    tri = {}
    for parts in engines:
        g_t = port.partition_graph(tri_edges, TRI_N, parts)
        check(g_t.n <= port.registry.get_spec("triangles").n_budget,
              f"triangles: n={g_t.n} past its n_budget")
        eng_t = port.GraphEngine(g_t, device=device)
        garr_t = eng_t.device_graph()
        a = run_suite(port, eng_t, garr_t, "auto", ("triangles",))
        p = run_suite(port, eng_t, garr_t, "ell", ("triangles",))
        ta, tp = a["triangles"], p["triangles"]
        check(ta["rounds"] == tp["rounds"] == parts
              and same_fields(ta["fields"], tp["fields"])
              and sum(ta["launches"].values()) == 0,
              f"triangles parts={parts}: modes differ, or a kernel ran")
        check(np.array_equal(ta["fields"]["triangles"], want_tri)
              and ta["fields"]["total"] == want_total,
              f"triangles parts={parts}: counts differ from scipy A o (A @ "
              f"A) (total {ta['fields']['total']} vs {want_total})")
        tri[parts] = {"rounds": ta["rounds"],
                      "ms": program_times(port, eng_t, garr_t, a)
                      ["triangles"],
                      "plain_ms": program_times(port, eng_t, garr_t, p)
                      ["triangles"]}
        log(f"[bsp] parts={parts} triangles n={TRI_N}: total {want_total:,}"
            f" == scipy, per vertex equal; auto {tri[parts]['ms']:.2f} ms, "
            f"ell {tri[parts]['plain_ms']:.2f} ms, rounds "
            f"{tri[parts]['rounds']}")
        del eng_t, garr_t

    # -- times -------------------------------------------------------------
    times = {}
    for parts, (_, eng, garr) in engines.items():
        ka = program_times(port, eng, garr, auto[parts])
        kp = program_times(port, eng, garr, plain[parts])
        for algo in algos:
            times[f"{algo}/parts={parts}"] = cell = {
                "rounds": auto[parts][algo]["rounds"], "ms": ka[algo],
                "plain_ms": kp[algo],
                "launches": auto[parts][algo]["launches"]["spmv_ell"]}
            log(f"[times] parts={parts} {algo:14s} rounds={cell['rounds']:3d}"
                f" kernels {cell['ms']:9.2f} ms   plain "
                f"{cell['plain_ms']:9.2f} ms")
    for parts, cell in tri.items():
        times[f"triangles/n={TRI_N}/parts={parts}"] = cell

    # -- multi-source: batched rows against single-source runs -------------
    single = {}
    for parts, (_, eng, garr) in engines.items():
        for algo, variant in MULTI:
            prog = eng.program(algo, variant)
            for r in MULTI_ROOTS:
                before = port.launches()
                *outs, rounds = prog(garr, r)
                _sync(torch, eng.device)
                after = port.launches()
                single[parts, algo, r] = (
                    suite_fields(eng, prog, outs), rounds,
                    {k: after[k] - before[k] for k in after})
    port.reset_launches()
    batched = {}
    for parts, (_, eng, garr) in engines.items():
        for algo, variant in MULTI:
            prog = eng.program(algo, variant, batch=len(MULTI_ROOTS))
            before = port.launches()
            *outs, rounds = prog(garr, MULTI_ROOTS)
            _sync(torch, eng.device)
            after = port.launches()
            batched[parts, algo] = (prog, outs, rounds,
                                    {k: after[k] - before[k] for k in after})
    multi_launches = port.launches()
    log(f"[multi] launches {multi_launches}")
    for (parts, algo), (prog, outs, rounds, launched) in batched.items():
        eng, garr = engines[parts][1], engines[parts][2]
        rows = {nm: eng.gather_batched_vertex_field(o)
                for nm, o in zip(prog.program.output_names, outs)}
        want_launched = {}
        for i, r in enumerate(MULTI_ROOTS):
            fields, r_rounds, r_launched = single[parts, algo, r]
            check(rounds[i] == r_rounds and same_fields(
                {nm: v[i] for nm, v in rows.items()}, fields),
                f"parts={parts} {algo} batched row {i} (root {r}) differs "
                f"from its single-source run")
            for k, v in r_launched.items():
                want_launched[k] = want_launched.get(k, 0) + v
        check(launched == want_launched,
              f"parts={parts} {algo} batched launches {launched}, want the "
              f"single-source runs' {want_launched}")
        ms = median_ms(torch, eng.device,
                       lambda: prog(garr, MULTI_ROOTS))
        name = f"{prog.spec.label}_x{len(MULTI_ROOTS)}"
        times[f"{name}/parts={parts}"] = {
            "rounds": rounds, "ms": ms, "launches": launched}
        log(f"[multi] parts={parts} {name}: rows and "
            f"rounds {rounds} == single-source runs, launches {launched}; "
            f"{ms:.2f} ms ({ms / len(MULTI_ROOTS):.2f} ms/query)")
    for name in ("spmv_ell", "bfs_pull"):
        check(multi_launches[name] > 0,
              f"multi-source path: {name} never launched")
    secs = time.perf_counter() - t_phase
    log("[times] " + json.dumps({"bsp": times, "errors": errs,
                                 "seconds": secs}, default=str))
    log(f"[bsp done] {secs:.1f} s")
    return {"launches": launches, "multi_launches": multi_launches,
            "auto": auto, "times": times}


# ---------------------------------------------------------------------------
# async supersteps and the incremental programs
# ---------------------------------------------------------------------------

class SyncCounter:
    """Counts ``Tensor.item`` calls (the async loops' device-to-host
    syncs) while active."""

    def __init__(self, torch):
        self.torch = torch
        self.count = 0

    def __enter__(self):
        item = self._item = self.torch.Tensor.item

        def counted(t):
            self.count += 1
            return item(t)

        self.torch.Tensor.item = counted
        return self

    def __exit__(self, *exc):
        self.torch.Tensor.item = self._item


def pagerank_f64_converged(m, tol: float = 1e-13,
                           max_rounds: int = 400) -> np.ndarray:
    """The float64 power iteration of ``pagerank_f64`` run until the L1
    change of a round is below ``tol`` (raises if it is not within
    ``max_rounds``)."""
    n = m.shape[0]
    out_deg = np.asarray(m.sum(axis=1)).ravel()
    inv = np.where(out_deg > 0, 1.0 / np.maximum(out_deg, 1.0), 0.0)
    base = (1.0 - ALPHA) / n
    mt = m.T.tocsr()
    r = np.full(n, 1.0 / n)
    for _ in range(max_rounds):
        new = base + ALPHA * (mt @ (r * inv))
        delta, r = np.abs(new - r).sum(), new
        if delta < tol:
            return r
    raise AssertionError(f"float64 PageRank not converged in {max_rounds} "
                         f"rounds (L1 change {delta:.3e})")


def async_run(port: Port, eng, garr, algo: str, variant: str, args,
              mode: str = "auto", **params) -> dict:
    """One run under local-ops ``mode``: host fields, rounds, syncs,
    launches and wire bytes per round by op."""
    torch = port.torch
    with port.localops.using(mode):
        prog = eng.program(algo, variant, **params)
    eng.comm.reset_wire()
    before = port.launches()
    with SyncCounter(torch) as syncs:
        *outs, rounds = prog(garr, *args)
        _sync(torch, eng.device)
    after = port.launches()
    return {"fields": suite_fields(eng, prog, outs), "rounds": rounds,
            "syncs": syncs.count, "prog": prog, "args": args,
            "params": params,
            "launches": {k: after[k] - before[k] for k in after},
            "wire": {op: b // max(rounds, 1)
                     for op, b in eng.comm.wire_by_op().items()}}


def run_async(port: Port, m, engines: dict, main: dict, bsp: dict,
              program_ms: dict) -> dict:
    """The async programs and the incremental variants on the main
    path's partitions: in local-ops mode auto (launch counters zeroed
    just before and read just after each of the two groups), checked
    against the BSP programs of the main and bsp phases and a converged
    float64 PageRank; then in mode ell (bit-identical, no launches);
    then timed beside their BSP siblings."""
    torch = port.torch
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    want_rank = pagerank_f64_converged(m)
    log(f"[async] float64 PageRank converged in "
        f"{time.perf_counter() - t0:.1f} s")
    slack = (port.superstep.ASYNC_ROUNDS_SLACK_FACTOR,
             port.superstep.ASYNC_ROUNDS_SLACK_CONST)

    # -- the async programs, mode auto: counts zeroed around them -------
    port.reset_launches()
    runs = {}
    for parts, (_, eng, garr) in engines.items():
        for algo in ASYNC_MONOTONE:
            runs[parts, f"{algo}/async"] = async_run(
                port, eng, garr, algo, "async",
                (ROOT,) if algo != "cc" else ())
        for s in ASYNC_STALENESS:
            runs[parts, f"pagerank/async s={s}"] = async_run(
                port, eng, garr, "pagerank", "async", (), staleness=s,
                **ASYNC_PR_PARAMS)
    async_launches = port.launches()
    log(f"[async] launches {async_launches}")

    # -- the incremental programs, mode auto: counts zeroed around them --
    port.reset_launches()
    for parts, (g, eng, garr) in engines.items():
        auto = bsp["auto"][parts]
        warm = {"cc": auto["cc"]["fields"]["labels"],
                "kcore": auto["kcore"]["fields"]["core"],
                "pagerank": main[parts]["pagerank/fast"]["field"]}
        for algo, variant in INCREMENTAL:
            spec = port.registry.get_spec(algo, variant)
            seeds = {"warm": warm[algo]}
            if algo != "pagerank":
                (seeds["cold"],) = port.incremental.cold_seed(spec, g)
            for kind, seed in seeds.items():
                runs[parts, f"{algo}/{variant} {kind}"] = async_run(
                    port, eng, garr, algo, variant,
                    (eng.scatter_vertex_field(seed),),
                    **(ASYNC_PR_PARAMS if algo == "pagerank" else {}))
    inc_launches = port.launches()
    log(f"[incremental] launches {inc_launches}")

    # -- checks against the BSP programs and float64 ---------------------
    want_async = want_inc = 0
    # spmv_ell launches once per launch table of a push combine's call
    tables = {parts: len(port.ell.launch_tables(g.ell_meta["ell_dst"]
                                                .buckets))
              for parts, (g, _, _) in engines.items()}
    for (parts, label), r in runs.items():
        what = f"parts={parts} {label}"
        f = r["fields"]
        algo = label.split("/")[0]
        auto = bsp["auto"][parts]
        if label.startswith(("pagerank/async", "pagerank/warm")):
            r["rank_err"] = err = max_rel(f["rank"], want_rank)
            check(r["rounds"] < ASYNC_PR_PARAMS["iters"],
                  f"{what}: not converged in {r['rounds']} rounds "
                  f"(err {f['err']:.3e})")
            check(err < PR_F64_TOL, f"{what}: max rel err {err:.3e} vs "
                                    f"converged float64")
            if label.startswith("pagerank/async"):
                s = r["params"]["staleness"]
                check(f["max_age"] <= 2 * s + 1,
                      f"{what}: max_age {f['max_age']} > {2 * s + 1}")
                want = (r["rounds"] + 1) * tables[parts]
                syncs = -(-r["rounds"] // s)
                want_async += want
            else:
                want = r["rounds"] * tables[parts]
                want_inc += want
            check(r["launches"]["spmv_ell"] == want
                  and r["launches"]["bfs_pull"] == 0,
                  f"{what}: launches {r['launches']}, want spmv_ell {want}")
            if label.startswith("pagerank/async"):
                check(r["syncs"] == syncs,
                      f"{what}: {r['syncs']} syncs in {r['rounds']} rounds")
            continue
        check(sum(r["launches"].values()) == 0,
              f"{what}: launched {r['launches']}")
        if label.endswith("/async"):
            if algo == "bfs":
                want = {"parents": main[parts]["bfs/fast"]["field"]}
                bsp_rounds = main[parts]["bfs/fast"]["rounds"]
            else:
                want = auto[algo]["fields"]
                bsp_rounds = auto[algo]["rounds"]
            cap = slack[0] * bsp_rounds + slack[1]
            check(r["rounds"] <= cap,
                  f"{what}: {r['rounds']} rounds, past {slack[0]} x "
                  f"{bsp_rounds} + {slack[1]}")
            check(r["syncs"] == r["rounds"],
                  f"{what}: {r['syncs']} syncs in {r['rounds']} rounds")
        else:
            want = auto[algo]["fields"]
        check(same_fields(f, want),
              f"{what}: outputs differ from the BSP program's")
    check(async_launches["spmv_ell"] == want_async > 0
          and async_launches["bfs_pull"] == 0,
          f"async path: spmv_ell {async_launches['spmv_ell']} launches, "
          f"want {want_async}")
    check(inc_launches["spmv_ell"] == want_inc > 0
          and inc_launches["bfs_pull"] == 0,
          f"incremental path: spmv_ell {inc_launches['spmv_ell']} "
          f"launches, want {want_inc}")
    log("[async] bfs/sssp/cc async == bfs/fast, sssp and cc bit for bit "
        "within the rounds slack, no kernel, one sync a round; "
        "pagerank/async and pagerank/warm converged within "
        f"{PR_F64_TOL} of float64, spmv_ell once a round (+1 at init for "
        "async); cc/incremental == cc, kcore/incremental == kcore from "
        "cold and warm seeds")

    # -- mode ell: bit-identical, equal rounds, no launches ---------------
    plain = {}
    for (parts, label), r in runs.items():
        _, eng, garr = engines[parts]
        spec = r["prog"].spec
        p = async_run(port, eng, garr, spec.algo, spec.variant, r["args"],
                      mode="ell", **r["params"])
        check(p["rounds"] == r["rounds"]
              and same_fields(p["fields"], r["fields"])
              and sum(p["launches"].values()) == 0,
              f"parts={parts} {label}: mode ell gives other outputs or "
              f"rounds ({p['rounds']} vs {r['rounds']}), or launched")
        plain[parts, label] = p
    log("[async] mode ell: every run bit-identical to mode auto, rounds "
        "equal, no launches")

    # -- times -----------------------------------------------------------
    times = {}
    for (parts, label), r in runs.items():
        _, eng, garr = engines[parts]
        sib = ASYNC_SIBLING[label.split(" ")[0]]
        sib_cell = program_ms.get(f"{sib}/parts={parts}") \
            or bsp["times"][f"{sib}/parts={parts}"]
        cell = {"rounds": r["rounds"], "syncs": r["syncs"],
                "wire_per_round": r["wire"],
                "launches": r["launches"]["spmv_ell"],
                "ms": median_ms(torch, eng.device,
                                lambda: r["prog"](garr, *r["args"])),
                "plain_ms": median_ms(
                    torch, eng.device,
                    lambda: plain[parts, label]["prog"](garr, *r["args"])),
                "bsp": sib, "bsp_ms": sib_cell["ms"],
                "bsp_rounds": sib_cell["rounds"]}
        if "rank_err" in r:
            cell["rank_err"] = r["rank_err"]
        if "max_age" in r["fields"]:
            cell["max_age"] = r["fields"]["max_age"]
        times[f"{label}/parts={parts}"] = cell
        log(f"[async] parts={parts} {label:24s} rounds={cell['rounds']:3d} "
            f"auto {cell['ms']:9.2f} ms  ell {cell['plain_ms']:9.2f} ms  "
            f"syncs {cell['syncs']:3d}  wire/round {cell['wire_per_round']}"
            f"  {sib} {cell['bsp_ms']:.2f} ms in {cell['bsp_rounds']} rounds"
            + (f"  rank err {cell['rank_err']:.2e}" if "rank_err" in cell
               else "")
            + (f"  max_age {cell['max_age']}" if "max_age" in cell
               else ""))
    secs = time.perf_counter() - t_phase
    log("[times] " + json.dumps({"async": times, "seconds": secs},
                                default=str))
    log(f"[async done] {secs:.1f} s")
    return {"launches": async_launches, "inc_launches": inc_launches}


# ---------------------------------------------------------------------------
# LM serving: flash_attention_fwd
# ---------------------------------------------------------------------------

def flash_bound(bh: int, sq: int, sk: int, d: int, itemsize: int,
                causal: bool) -> tuple[float, str]:
    """Least ms for one flash call: q, k, v read and o written once over
    HBM rate, against q k^T and p @ v on the unmasked (query, key) pairs
    (2 ops a multiply-add, D of each per pair and product) over the bf16
    tensor-core peak."""
    pairs = bh * (sum(min(q + 1, sk) for q in range(sq)) if causal
                  else sq * sk)
    return bound(itemsize * d * bh * (2 * sq + 2 * sk), 4 * d * pairs,
                 BF16_TC_OPS_PER_S)


def flash_times(port: Port, device, q, k, v, batch: int) -> dict:
    """The flash kernel on (BH, S, D) bf16 q, k, v, causal, beside ref.py,
    scaled_dot_product_attention on the same inputs as (batch, BH / batch,
    S, D) (checked to agree with the kernel), and the bound."""
    torch = port.torch
    bh, s, d = q.shape
    b_ms, b_by = flash_bound(bh, s, s, d, q.element_size(), True)
    sdpa_in = [t.reshape(batch, bh // batch, s, d) for t in (q, k, v)]

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            *sdpa_in, is_causal=True)

    check(torch.allclose(library().reshape(q.shape).float(),
                         port.flash(q, k, v, causal=True).float(),
                         atol=FLASH_TOL["bfloat16"],
                         rtol=FLASH_TOL["bfloat16"]),
          f"scaled_dot_product_attention disagrees with the kernel at "
          f"{tuple(q.shape)}")
    return {"ms": kernel_ms(torch, device,
                            lambda: port.flash(q, k, v, causal=True)),
            "plain_ms": kernel_ms(
                torch, device, lambda: port.flash_attention_ref(
                    q, k, v, causal=True), reps=5),
            "library_ms": kernel_ms(torch, device, library),
            "bound_ms": b_ms, "bound_by": b_by}


class FlashParity:
    """flash_attention_fwd against ref.py; keeps the max abs error."""

    def __init__(self, port: Port, device):
        self.port, self.device = port, device
        self.err = {"float32": 0.0, "bfloat16": 0.0}
        self.cases = 0

    def randn(self, shape, dtype, gen):
        torch = self.port.torch
        return torch.randn(shape, generator=gen, device=self.device) \
            .to(getattr(torch, dtype))

    def one(self, got, want, dtype, what):
        torch = self.port.torch
        _sync(torch, self.device)
        tol = FLASH_TOL[dtype]
        check(got.dtype == want.dtype, f"flash {what}: dtype {got.dtype}")
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol, msg=lambda m: f"flash {what} "
                                   f"{dtype}: {m}")
        self.err[dtype] = max(self.err[dtype],
                              float((got.float() - want.float()).abs().max()))
        self.cases += 1

    def run(self, prefill_shape):
        port, torch = self.port, self.port.torch
        gen = torch.Generator(device=self.device).manual_seed(SEED)
        cases = [((bh, s, d), (bh, s, d), dict(causal=c, window=w))
                 for bh, s, d in FLASH_SWEEP
                 for c, w in ((True, 0), (True, 64), (False, 0))]
        cases += [((2, 128, 128), (2, 512, 128), dict(causal=False)),
                  ((1, 128, 128), (1, 128, 128),
                   dict(causal=True, softcap=20.0))]
        cases += [((bh, sq, d), (bh, sk, d),
                   dict(causal=c, window=w, softcap=cap))
                  for bh, sq, sk, d, c, w, cap in FLASH_EDGES]
        for dtype in ("float32", "bfloat16"):
            for qs, ks, kw in cases:
                q = self.randn(qs, dtype, gen)
                k, v = self.randn(ks, dtype, gen), self.randn(ks, dtype, gen)
                self.one(port.flash(q, k, v, **kw),
                         port.flash_attention_ref(q, k, v, **kw), dtype,
                         f"{qs}x{ks} {kw}")
            # danube3's head dim 120 through ops, (B, S, H, D)
            q, k, v = (self.randn((2, 128, 4, 120), dtype, gen)
                       for _ in range(3))
            want = port.flash_attention_ref(
                *(t.transpose(1, 2).reshape(8, 128, 120) for t in (q, k, v)),
                causal=True).reshape(2, 4, 128, 120).transpose(1, 2)
            self.one(port.flash_ops.flash_attention(q, k, v, causal=True),
                     want, dtype, "ops D=120")
        q, k, v = (self.randn(prefill_shape, "bfloat16", gen)
                   for _ in range(3))
        self.one(port.flash(q, k, v, causal=True),
                 port.flash_attention_ref(q, k, v, causal=True), "bfloat16",
                 f"prefill shape {prefill_shape}")
        return q, k, v


def device_profile(port: Port, cfg, model, batch: int, prompt_len: int,
                   device, gen: int = 8) -> dict:
    """torch.profiler over one serve call with ``gen`` decode steps: the
    device kernels' time, summed by name (one stream, so they do not
    overlap), against serve's own synchronized prefill and decode time,
    and the kernels that take most.  Tracing slows the host, so the busy
    share is a lower bound on the untraced run's."""
    torch = port.torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, stats = port.serve(cfg, batch=batch, prompt_len=prompt_len,
                              gen=gen, device=device, params=model)
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    wall_ms = (stats["prefill_s"] + stats["decode_s"]) * 1e3
    out = {"gen": gen, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms,
           "prefill_ms": stats["prefill_s"] * 1e3,
           "decode_ms": stats["decode_s"] * 1e3,
           "top_kernels": [{"name": k[:80], "ms": ms, "calls": n}
                           for k, ms, n in kernels[:10]]}
    log(f"[profile] serve gen={gen} under torch.profiler: prefill "
        f"{out['prefill_ms']:.1f} ms + decode {out['decode_ms']:.1f} ms, "
        f"device kernels {busy_ms:.1f} ms ({out['device_busy_share']:.1%})")
    for r in out["top_kernels"]:
        log(f"[profile]   {r['ms']:9.3f} ms  x{r['calls']:<5d} {r['name']}")
    return out


def logit_diff(torch, a, b) -> dict:
    """Logits ``a`` against the reference ``b`` (rows of vocab logits):
    largest and mean difference, and the argmax row by row.  A row of
    ``a`` may take another token than ``b`` only where that token's logit
    in ``b`` is within one bf16 ulp of ``b``'s largest (a tie at the
    logits' own precision); such rows are counted in ``argmax_ties``, any
    other in ``argmax_other``.  ``top2_gap`` is each row's gap between
    ``b``'s two largest logits."""
    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    top = b.topk(2, dim=-1).values
    ulp = torch.ldexp(torch.ones_like(top[:, 0]),
                      torch.frexp(top[:, 0].abs()).exponent - 8)
    pick = a.argmax(-1)
    differ = pick != b.argmax(-1)
    tie = b.gather(-1, pick[:, None])[:, 0] >= top[:, 0] - ulp
    d = (a - b).abs()
    return {"max": float(d.max()), "mean": float(d.mean()),
            "argmax_ties": int((differ & tie).sum()),
            "argmax_other": int((differ & ~tie).sum()),
            "top2_gap": (top[:, 0] - top[:, 1]).tolist(),
            "max_logit": float(b.abs().max()),
            "finite": bool(torch.isfinite(a).all())}


def run_llm(port: Port, device, arch: str = LLM_ARCH, batch: int = LLM_BATCH,
            prompt_len: int = LLM_PROMPT, gen: int = LLM_GEN,
            decode_prompt: int = LLM_DECODE_PROMPT) -> dict:
    """The LM phases: parity, the serve main path and its checks, times."""
    torch, models = port.torch, port.models
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = port.arch_registry.get_arch(arch)
    prefill_shape = (batch * cfg.num_heads, prompt_len, cfg.head_dim)

    # -- llm-parity -----------------------------------------------------------
    parity = FlashParity(port, device)
    fq, fk, fv = parity.run(prefill_shape)
    log(f"[llm-parity] flash_attention_fwd: {parity.cases} cases ok, "
        f"max_abs_err {parity.err}")

    # -- llm-main -------------------------------------------------------------
    t0 = time.perf_counter()
    model = models.Transformer(cfg, models.init_params(
        models.param_spec(cfg), torch.Generator(device=device).manual_seed(0),
        device))
    _sync(torch, device)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[llm-main] {arch}: {n_params:,} f32 parameters "
        f"({n_params * 4 / 1e9:.2f} GB) drawn on the device in "
        f"{time.perf_counter() - t0:.1f} s")
    port.reset_launches()
    toks, stats = port.serve(cfg, batch=batch, prompt_len=prompt_len,
                             gen=gen, device=device, params=model)
    _sync(torch, device)
    launches = port.launches()
    log(f"[llm-main] serve batch={batch} prompt={prompt_len} gen={gen}: "
        f"launches {launches}; prefill {stats['prefill_s'] * 1e3:.1f} ms, "
        f"decode {stats['tok_per_s']:.1f} tok/s; sample "
        f"{toks[0, :8].tolist()}")
    check(launches["flash_attention_fwd"] == cfg.num_layers,
          f"flash_attention_fwd launched {launches['flash_attention_fwd']} "
          f"times in serve, want {cfg.num_layers} (one per prefill layer)")
    check(launches["flash_attention_fwd_tc"] == cfg.num_layers,
          f"{launches['flash_attention_fwd_tc']} of the prefill's flash "
          f"launches ran the bf16 tensor-core design, want "
          f"{cfg.num_layers}")
    check(tuple(toks.shape) == (batch, gen) and toks.dtype == torch.int32,
          f"served tokens {tuple(toks.shape)} {toks.dtype}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "served tokens out of range")

    with torch.inference_mode():
        prompt = port.batch_at(0, global_batch=batch, seq_len=prompt_len,
                               vocab_size=cfg.vocab_size).to(device)
        # the kernel at layer 0's real q, k, v (kv heads repeated)
        layers, blk = models.layers, model.segments[0][0]
        h = layers.apply_norm(blk.ln1, models.model._embed(model, cfg, prompt),
                              cfg.norm)
        q, k, v = layers.attn_qkv(blk.attn, h, cfg,
                                  torch.arange(prompt_len, device=device))
        g = cfg.num_heads // cfg.num_kv_heads
        q, k, v = (port.flash_ops._to_bh(t) for t in (
            q, layers.repeat_kv(k, g), layers.repeat_kv(v, g)))
        parity.one(port.flash(q, k, v, causal=True),
                   port.flash_attention_ref(q, k, v, causal=True),
                   "bfloat16", "layer-0 q, k, v")
        del h, q, k, v

        lg_k, _ = models.forward_prefill(model, cfg, {"tokens": prompt})
        lg_n, _ = models.forward_prefill(model, cfg, {"tokens": prompt},
                                         impl="naive")
        short = prompt[:, :decode_prompt]
        lg_p, _ = models.forward_prefill(model, cfg, {"tokens": short})
        lg_pn, _ = models.forward_prefill(model, cfg, {"tokens": short},
                                          impl="naive")
        cache = models.init_cache(cfg, batch, decode_prompt, device=device)
        for t in range(decode_prompt):
            lg_d, cache = models.forward_decode(model, cfg,
                                                short[:, t:t + 1], cache)
        _sync(torch, device)
        del cache
        errs = {}
        for what, a, b in (
                ("prefill kernel vs naive", lg_k, lg_n),
                (f"decode vs prefill ({decode_prompt} tokens)", lg_d, lg_p),
                (f"decode vs naive prefill ({decode_prompt} tokens)", lg_d,
                 lg_pn)):
            errs[what] = e = logit_diff(torch, a, b)
            log(f"[llm-main] logits, {what}: {e}")
            check(e["finite"], f"{what}: logits not finite")
            check(e["max"] <= LOGIT_MAX_TOL and e["mean"] <= LOGIT_MEAN_TOL
                  and e["argmax_other"] == 0,
                  f"{what}: {e} beyond max {LOGIT_MAX_TOL}, mean "
                  f"{LOGIT_MEAN_TOL} or argmax")
        del lg_n
    prefill_err = errs["prefill kernel vs naive"]["max"]
    decode_err = errs[f"decode vs prefill ({decode_prompt} tokens)"]["max"]

    # -- llm-times ------------------------------------------------------------
    runs = [port.serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen,
                       device=device, params=model)[1] for _ in range(3)]
    prefill_ms = statistics.median(r["prefill_s"] for r in runs) * 1e3
    tok_s = statistics.median(r["tok_per_s"] for r in runs)
    flash = flash_times(port, device, fq, fk, fv, batch)
    b_ms, b_by = flash["bound_ms"], flash["bound_by"]
    share = cfg.num_layers * flash["ms"] / prefill_ms
    log(f"[times] llm {arch} batch={batch} prompt={prompt_len} gen={gen}: "
        f"prefill {prefill_ms:.2f} ms, decode {tok_s:.1f} tok/s "
        f"(runs {[round(r['prefill_s'] * 1e3, 2) for r in runs]} ms, "
        f"{[round(r['tok_per_s'], 1) for r in runs]} tok/s)")
    log(f"[times] flash_attention_fwd {prefill_shape} bf16 causal: kernel "
        f"{flash['ms']:.4f} ms  plain {flash['plain_ms']:.4f} ms  bound "
        f"{b_ms:.4f} ms ({b_by})  sdpa {flash['library_ms']:.4f} ms; "
        f"{cfg.num_layers} layers = {share:.1%} of prefill")
    gen_w = torch.Generator(device=device).manual_seed(SEED + 1)
    widths = {}
    for shape in FLASH_WIDTHS:
        q, k, v = (torch.randn(shape, generator=gen_w, device=device)
                   .to(torch.bfloat16) for _ in range(3))
        widths[str(shape)] = w = flash_times(port, device, q, k, v, batch)
        log(f"[times] flash_attention_fwd {shape} bf16 causal: kernel "
            f"{w['ms']:.4f} ms  plain {w['plain_ms']:.4f} ms  bound "
            f"{w['bound_ms']:.4f} ms ({w['bound_by']})  sdpa "
            f"{w['library_ms']:.4f} ms")
        del q, k, v
    profile = device_profile(port, cfg, model, batch, prompt_len, device)
    log("[times] " + json.dumps({
        "arch": arch, "prefill_ms": prefill_ms, "decode_tok_per_s": tok_s,
        "profile": profile,
        "flash": flash, "flash_widths": widths,
        "flash_share_of_prefill": share,
        "prefill_logit_err": prefill_err, "decode_logit_err": decode_err}))
    return {"launches": launches["flash_attention_fwd"],
            "parity_err": max(parity.err.values()), "flash": flash}


def kernels_record(result: dict, llm: dict) -> dict:
    """The contract record of each kernel: spmv_ell at pagerank/bsp's
    ell_in buckets and bfs_pull at bfs/fast's, at the largest parts
    count; flash_attention_fwd at one TinyLlama prefill layer.  A graph
    kernel's launches are those of every path it runs on (the main path,
    the rest of the BSP suite, multi-source, the async programs, the
    incremental ones), each counted from zero around its run."""
    p = result["parts"]
    paths = {"graph-main": result["launches"], "bsp-suite":
             result["bsp_launches"], "multi-source": result["multi_launches"],
             "async": result["async_launches"],
             "incremental": result["inc_launches"]}
    rows = []
    for name, src, replaces, cell_key, design in (
            ("spmv_ell", "src/repro_torch/kernels/spmv/csrc/spmv_ell.cu",
             SPMV_REPLACES, f"spmv_ell/ell_in/parts={p}", SPMV_DESIGN),
            ("bfs_pull", "src/repro_torch/kernels/frontier/csrc/bfs_pull.cu",
             BFS_REPLACES, f"bfs_pull/ell_in/parts={p}", BFS_DESIGN)):
        cell = result["kernel_cells"][cell_key]
        rows.append({"name": name, "route": "cuda", "design": design,
                     "source": src, "replaces": replaces,
                     "launches": sum(c[name] for c in paths.values()),
                     "launches_by_path": {k: c[name]
                                          for k, c in paths.items()},
                     "max_abs_err": result["parity_err"][name],
                     "ms": cell["ms"], "plain_ms": cell["plain_ms"],
                     "bound_ms": cell["bound_ms"],
                     "bound_by": cell["bound_by"],
                     "library_ms": cell["library_ms"],
                     "gathers_per_s": cell["gathers"] / cell["ms"] * 1e3})
    cell = llm["flash"]
    rows.append({"name": "flash_attention_fwd", "route": "cuda",
                 "design": "wgmma (bf16 tensor cores, TMA k/v ring)",
                 "source": "src/repro_torch/kernels/flash_attention/csrc/"
                           "flash_attention_fwd.cu",
                 "replaces": FLASH_REPLACES, "launches": llm["launches"],
                 "max_abs_err": llm["parity_err"], "ms": cell["ms"],
                 "plain_ms": cell["plain_ms"], "bound_ms": cell["bound_ms"],
                 "bound_by": cell["bound_by"],
                 "library_ms": cell["library_ms"]})
    return {"kernels": rows}


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="checkout whose graph kernels to time beside "
                         "these (per bucket and per BFS round)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "a card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = card_line()
    log(f"[card] {card}")
    result = run(GRAPH, PARTS, "cuda", args.parent)
    log(f"[graph done] {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    llm = run_llm(Port(), "cuda")
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernels_record(result, llm)))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
