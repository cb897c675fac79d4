#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

It drives the port's two main paths and holds every CUDA kernel of each
against its plain-PyTorch version:

- the paper's graph path: bfs/bsp, bfs/fast, pagerank/bsp and
  pagerank/fast through ``GraphEngine.program`` on a urand graph cut
  into P vertex blocks stacked on the card (kernels ``spmv_ell``,
  ``bfs_pull``);
- LM token serving: ``launch/serve.py::serve`` on TinyLlama-1.1B at full
  width, weights drawn from a seeded ``torch.Generator`` on the card
  (kernel ``flash_attention_fwd``, one launch per prefill layer).

Phases, each of which raises on failure (the run then exits non-zero and
prints no result):

  card     the card's name and power limit, as nvidia-smi gives them.
  build    every kernel compiled from src/repro_torch/kernels/*/csrc, all
           at once (one nvcc per source); registers and spill stores of
           each kernel instantiation, any ptxas warning, and any note
           that ptxas serialized a kernel's wgmma products.
  parity   each kernel against its plain version on the card: the shape
           sweeps of the JAX package's kernel tests, then every ELL bucket
           of the main-path graph.  bfs_pull must match exactly; spmv_ell
           within rtol = atol = 1e-5, because the kernel adds a row's
           slots in another order than the plain version.
  main     the four programs once in local-ops mode ``auto`` (the
           kernels) at each parts count, launch counters zeroed just
           before and read just after: both kernels must have launched.
           BFS parents must equal the min-id in-neighbor one BFS level up
           (levels from a scipy sparse BFS) for both variants and every
           parts count; ranks must be within 1e-4 relative of a float64
           scipy power iteration of the same round count; rounds must be
           equal across parts counts.
  plain    the same programs in mode ``ell`` (no kernels) on the card:
           parents bit-identical, ranks within 1e-5 relative, rounds equal.
  times    per-program ms in both modes (median of 3 after a warm-up run),
           and each kernel at the main path's bucket shapes beside its
           plain version, its bound and, for spmv_ell, a torch.sparse CSR
           matvec of the same function (timed here only; the port never
           calls it).
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

SPMV_TOL = 1e-5          # rtol = atol, kernel vs plain (summation order)
PR_F64_TOL = 1e-4        # max rel err of ranks vs float64 power iteration
PR_PLAIN_TOL = 1e-5      # max rel diff of ranks, kernel vs plain mode

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
        from repro_torch.core import GraphEngine, localops, \
            partition_graph, registry
        from repro_torch.core.partitioned import pack_bits
        from repro_torch.graphs import generate_edges
        from repro_torch.kernels import _build
        from repro_torch.kernels.frontier import kernel as frontier_kernel
        from repro_torch.kernels.frontier.ref import bfs_pull_ref
        from repro_torch.kernels.spmv import kernel as spmv_kernel
        from repro_torch.kernels.spmv.ref import spmv_ell_ref
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
        self.build = _build
        self.frontier_kernel = frontier_kernel
        self.spmv_kernel = spmv_kernel
        self.bfs_pull_ref = bfs_pull_ref
        self.spmv_ell_ref = spmv_ell_ref

    # the wrappers are read through their modules at each call
    def spmv_ell(self, *args, **kw):
        return self.spmv_kernel.spmv_ell(*args, **kw)

    def bfs_pull(self, *args):
        return self.frontier_kernel.bfs_pull(*args)

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

def bfs_levels(edges: np.ndarray, n: int, root: int) -> np.ndarray:
    """BFS level of every vertex from ``root`` (-1 if unreached), one
    sparse in-neighbor matvec per level."""
    import scipy.sparse as sp
    src, dst = edges[:, 0], edges[:, 1]
    into = sp.csr_matrix((np.ones(src.size, np.int32), (dst, src)),
                         shape=(n, n))
    level = np.full(n, -1, np.int64)
    level[root] = 0
    frontier = np.zeros(n, np.int32)
    frontier[root] = 1
    d = 0
    while frontier.any():
        d += 1
        new = ((into @ frontier) > 0) & (level < 0)
        level[new] = d
        frontier = new.astype(np.int32)
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


def pagerank_f64(edges: np.ndarray, n: int, rounds: set) -> dict:
    """Float64 power iteration of the port's update (rank0 = 1/n,
    rank = (1-alpha)/n + alpha * sum of in-neighbors' rank/out_degree,
    no dangling redistribution); the ranks after each count in
    ``rounds``."""
    import scipy.sparse as sp
    src, dst = edges[:, 0], edges[:, 1]
    out_deg = np.bincount(src, minlength=n).astype(np.float64)
    m = sp.csr_matrix((1.0 / out_deg[src], (dst, src)), shape=(n, n))
    base = (1.0 - ALPHA) / n
    r = np.full(n, 1.0 / n)
    out = {}
    for t in range(1, max(rounds) + 1):
        r = base + ALPHA * (m @ r)
        if t in rounds:
            out[t] = r.copy()
    return out


def max_rel(a: np.ndarray, b: np.ndarray) -> float:
    """Elementwise max |a - b| / |b| (b has no zeros: ranks >= base)."""
    return float(np.max(np.abs(a.astype(np.float64) - b) / np.abs(b)))


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


def buckets(meta, flat):
    """(row0, rows, (P, rows, K) view) of each non-empty ELL bucket."""
    off = r0 = 0
    for rows, k in meta.buckets:
        if k:
            yield r0, rows, flat[:, off:off + rows * k].reshape(
                flat.shape[0], rows, k)
        off += rows * k
        r0 += rows


class Parity:
    """Kernel-vs-plain comparisons; keeps each kernel's max abs error."""

    def __init__(self, port: Port, device):
        self.port, self.device = port, device
        self.torch = port.torch
        self.err = {"spmv_ell": 0.0, "bfs_pull": 0.0}
        self.cases = {"spmv_ell": 0, "bfs_pull": 0}

    def spmv(self, idx, val, x, skip=None):
        torch = self.torch
        got = self.port.spmv_ell(idx, val, x, skip=skip)
        want = self.port.spmv_ell_ref(idx, val, x, skip=skip)
        _sync(torch, self.device)
        torch.testing.assert_close(got, want, rtol=SPMV_TOL, atol=SPMV_TOL)
        self._note("spmv_ell", (got - want).abs().max().item())
        return got

    def frontier(self, nbr, bits, unv):
        torch = self.torch
        got = self.port.bfs_pull(nbr, bits, unv)
        want = self.port.bfs_pull_ref(nbr, bits, unv)
        _sync(torch, self.device)
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"bfs_pull differs from its plain version "
                                 f"in {bad} rows at {tuple(nbr.shape)}")
        self._note("bfs_pull", 0.0)
        return got

    def _note(self, name, err):
        self.err[name] = max(self.err[name], float(err))
        self.cases[name] += 1

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

    def graph_buckets(self, g, garr, rng):
        """Every ELL bucket the main path hands a kernel: ell_in (spmv and
        bfs_pull) and ell_dst (spmv), on random x, bits and flags."""
        torch, dev = self.torch, self.device
        p = g.parts
        shapes = []
        for name in ("ell_in", "ell_dst"):
            meta = g.ell_meta[name]
            x = torch.rand((p, meta.sentinel + 1), device=dev)
            bits = torch.randint(-2 ** 31, 2 ** 31 - 1,
                                 (p, g.n // 32 + 1), dtype=torch.int32,
                                 device=dev)
            unv = torch.randint(0, 2, (p, meta.n_rows), dtype=torch.int32,
                                device=dev)
            for r0, rows, blk in buckets(meta, garr[f"{name}_idx"]):
                self.spmv(blk, None, x, skip=meta.sentinel)
                if name == "ell_in":
                    self.frontier(blk, bits, unv[:, r0:r0 + rows])
                shapes.append((name, tuple(blk.shape)))
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


def kernel_times(port: Port, g, garr, level: np.ndarray, device) -> dict:
    """Each kernel at this graph's shapes, beside its plain version, its
    bound and its library call: spmv_ell over one local-ops call's
    buckets (one PageRank round), bfs_pull over every call of one
    bfs/fast run."""
    torch = port.torch
    p, n = g.parts, g.n
    out = {}
    rng = torch.Generator(device=device).manual_seed(SEED)

    for name in ("ell_in", "ell_dst"):
        meta = g.ell_meta[name]
        blks = [b for _, _, b in buckets(meta, garr[f"{name}_idx"])]
        n_cols = meta.sentinel + 1
        x = torch.rand((p, n_cols), device=device, generator=rng)
        rows = sum(b.shape[1] for b in blks)
        slots = sum(b.shape[1] * b.shape[2] for b in blks)

        def kern(blks=blks, x=x, skip=meta.sentinel):
            return torch.cat([port.spmv_ell(b, None, x, skip=skip)
                              for b in blks], dim=1)

        def plain(blks=blks, x=x, skip=meta.sentinel):
            return torch.cat([port.spmv_ell_ref(b, None, x, skip=skip)
                              for b in blks], dim=1)

        # the same y as one CSR matvec over the stacked parts
        # (block-diagonal: part q's columns offset by q * n_cols)
        r_idx, c_idx = [], []
        r0 = 0
        for b in blks:
            _, br, bk = b.shape
            keep = b != meta.sentinel
            part = torch.arange(p, device=device)[:, None, None]
            row = part * rows + r0 + torch.arange(
                br, device=device)[None, :, None]
            r_idx.append(row.expand(p, br, bk)[keep])
            c_idx.append((b.long() + part * n_cols)[keep])
            r0 += br
        with warnings.catch_warnings():     # torch.sparse's beta notices
            warnings.simplefilter("ignore", UserWarning)
            coo = torch.sparse_coo_tensor(
                torch.stack([torch.cat(r_idx), torch.cat(c_idx)]),
                torch.ones(sum(t.numel() for t in r_idx), device=device),
                (p * rows, p * n_cols))
            csr = coo.coalesce().to_sparse_csr()
        del coo, r_idx, c_idx
        xf = x.reshape(-1)

        def library(csr=csr, xf=xf):
            return csr @ xf

        y = kern()
        torch.testing.assert_close(library().reshape(p, rows), y,
                                   rtol=SPMV_TOL, atol=SPMV_TOL)
        b_ms, b_by = bound(4 * (p * slots + p * n_cols + p * rows), p * slots)
        out[f"spmv_ell/{name}"] = {
            "ms": kernel_ms(torch, device, kern),
            "plain_ms": kernel_ms(torch, device, plain, reps=5),
            "library_ms": kernel_ms(torch, device, library),
            "bound_ms": b_ms, "bound_by": b_by,
            "timed_launches": len(blks), "rows": p * rows,
            "slots": p * slots}
        del csr

    # bfs_pull over one bfs/fast run: each round's calls rebuilt from the
    # BFS levels.  Round r reads the bitmap of level r - 1; a push round
    # (previous count under the pull threshold) passes the activated rows
    # (level r), a pull round every row not yet visited (level >= r).
    meta = g.ell_meta["ell_in"]
    thresh = max(1, int(n * port.registry.get_spec("bfs", "fast")
                        .defaults["pull_threshold"]))
    lvl = np.full(n, INT_INF, np.int64)
    lvl[:level.size] = np.where(level >= 0, level, INT_INF)
    lvl = torch.from_numpy(lvl).to(device)
    perm = garr["ell_in_perm"].long()
    blks = list(buckets(meta, garr["ell_in_idx"]))
    n_rows = sum(rows for _, rows, _ in blks)
    rounds, live_slots, modes = [], 0, ""
    for r in range(1, int(level.max()) + 2):
        push = int((lvl == r - 1).sum()) < thresh
        rows_in = (lvl == r) if push else (lvl >= r)
        bits = port.pack_bits(lvl == r - 1)
        bits = torch.cat([bits, bits.new_zeros(1)]).expand(p, -1) \
            .contiguous()
        unv = torch.gather(rows_in.reshape(p, g.n_local).to(torch.int32), 1,
                           perm)
        calls = [(blk, bits, unv[:, r0:r0 + rows]) for r0, rows, blk in blks]
        live_slots += sum(int(u.sum()) * blk.shape[2] for blk, _, u in calls)
        rounds.append(calls)
        modes += "u" if push else "l"

    def kern():
        return [port.bfs_pull(*c) for calls in rounds for c in calls]

    def plain():
        return [port.bfs_pull_ref(*c) for calls in rounds for c in calls]

    check(all(torch.equal(a, b) for a, b in zip(kern(), plain())),
          "bfs_pull differs from its plain version on the BFS rounds")
    b_ms, b_by = bound(len(rounds) * (4 * p * (g.n // 32 + 1)
                                      + 2 * 4 * p * n_rows)
                       + 4 * live_slots, live_slots)
    out["bfs_pull/ell_in"] = {
        "ms": kernel_ms(torch, device, kern),
        "plain_ms": kernel_ms(torch, device, plain, reps=5),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "timed_launches": len(rounds) * len(blks), "rows": p * n_rows,
        "live_slots": live_slots, "rounds": modes}
    return out


def run(graph: str, parts_list, device) -> dict:
    port = Port()
    torch = port.torch
    rng = np.random.default_rng(SEED)
    port.localops.set_mode("auto")

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    logs = port.build.build_all() if torch.device(device).type == "cuda" \
        else {}
    log(f"[build] {len(logs)} kernels in {time.perf_counter() - t0:.1f} s")
    cxxfilt = os.path.join(os.path.dirname(port.build._nvcc()), "cu++filt") \
        if logs else ""
    for name, text in logs.items():
        for entry, regs, spills in ptxas_entries(text, cxxfilt):
            log(f"[build] {name}: {entry}: {regs} registers, {spills} bytes "
                f"spill stores")
        for line in text.splitlines():
            if "warning" in line.lower() or "serialized" in line:
                log(f"[build] {name}: {line.strip()}")

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
    for name in ("spmv_ell", "bfs_pull"):
        check(main_launches[name] > 0,
              f"{name} never launched on the main path")
    for parts, res in main.items():
        for key, r in res.items():
            log(f"[main] parts={parts} {key:14s} rounds={r['rounds']:3d} "
                f"launches={r['launches']}")

    t0 = time.perf_counter()
    level = bfs_levels(edges, n, ROOT)
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
    want_ranks = pagerank_f64(edges, n, pr_rounds)
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
            if key.startswith("bfs"):
                check(np.array_equal(r["field"], k["field"]),
                    f"plain parts={parts} {key}: parents differ")
            else:
                err = max_rel(r["field"], k["field"].astype(np.float64))
                check(err < PR_PLAIN_TOL,
                    f"plain parts={parts} {key}: rel diff {err:.3e}")
    log("[plain] mode ell on the card: parents bit-identical, ranks within "
        f"{PR_PLAIN_TOL} rel, rounds equal")

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
        for key, cell in kernel_times(port, g, garr, level, device).items():
            kernel_cells[f"{key}/parts={parts}"] = cell
            log(f"[times] parts={parts} {key:16s} kernel {cell['ms']:.4f} ms"
                f"  plain {cell['plain_ms']:.4f} ms  bound "
                f"{cell['bound_ms']:.4f} ms ({cell['bound_by']})  library "
                f"{cell['library_ms']} ms  timed launches "
                f"{cell['timed_launches']}")
    log("[times] " + json.dumps({"graph": graph, "programs": program_ms,
                                 "kernels": kernel_cells}, default=str))
    return {"launches": main_launches, "parity_err": parity_err,
            "kernel_cells": kernel_cells, "parts": max(parts_list)}

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
    count; flash_attention_fwd at one TinyLlama prefill layer."""
    p = result["parts"]
    rows = []
    for name, src, replaces, cell_key in (
            ("spmv_ell", "src/repro_torch/kernels/spmv/csrc/spmv_ell.cu",
             SPMV_REPLACES, f"spmv_ell/ell_in/parts={p}"),
            ("bfs_pull", "src/repro_torch/kernels/frontier/csrc/bfs_pull.cu",
             BFS_REPLACES, f"bfs_pull/ell_in/parts={p}")):
        cell = result["kernel_cells"][cell_key]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": result["launches"][name],
                     "max_abs_err": result["parity_err"][name],
                     "ms": cell["ms"], "plain_ms": cell["plain_ms"],
                     "bound_ms": cell["bound_ms"],
                     "bound_by": cell["bound_by"],
                     "library_ms": cell["library_ms"]})
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
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "a card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = card_line()
    log(f"[card] {card}")
    result = run(GRAPH, PARTS, "cuda")
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
