"""Graph-engine dry-run: plan every registered program for paper-scale
urand graphs at production part counts (256 parts single-pod, 512
multi-pod), with no card and nothing allocated.

The JAX package lowers and compiles each program against abstract
``GraphShards`` on a 256- or 512-device host mesh.  The port runs each
program ONCE on ``device="meta"`` tensors: an ``abstract_graph`` whose
arrays (``GraphShards.abstract_arrays``) have the real shapes and
dtypes and no storage, all P parts stacked as ``StackedComm`` stacks
them, with a fixed ``static_iters`` trip count so every round runs.
What the planning run gives:

  * FLOPs and unfused bytes from ``roofline/jaxpr_cost.count_fn`` (every
    round counted, see there), and temp bytes as the counter's peak of
    live intermediates;
  * argument bytes: the graph arrays' bytes;
  * collectives from the exchange tallies, priced by the reference's
    ring model (``roofline/analysis.collective_stats``), psum_scalar's
    all-reduces included (:class:`PlanComm`);
  * a roofline under the reference's TPU v5e constants and the H100's.

The records carry the JAX package's keys (``dryrun.py``'s record) plus
``h100``.  ``lower_compile_s`` is the planning run's wall time, and
``localops_impl`` the local-ops route that was counted: ``ell`` on meta,
which is what the JAX package records on a CPU host too.
"""

from __future__ import annotations

import json
import pathlib
import time

import torch

from repro_torch.configs import graph_workloads
from repro_torch.core import localops, registry
from repro_torch.core.api import GraphEngine
from repro_torch.core.graph import abstract_graph
from repro_torch.core.partitioned import StackedComm
from repro_torch.core.registry import program_label
from repro_torch.roofline import analysis as RA
from repro_torch.roofline.jaxpr_cost import count_fn

# static trip counts per algorithm (the JAX package's): typical ER BFS
# depth is ~8; Bellman-Ford/label-prop converge in a few more rounds than
# the BFS depth; PageRank runs its full iteration budget; k-core peels in
# ~(degeneracy + wave) rounds; betweenness runs its static count PER
# PHASE (forward + backward).  "parts" means one superstep per partition
# (the triangle rotation runs exactly P rounds).  Algorithms registered
# without an entry fall back to DEFAULT_STATIC_ITERS.
STATIC_ITERS = {"bfs": 8, "pagerank": 50, "sssp": 12, "cc": 8,
                "triangles": "parts", "kcore": 30, "betweenness": 8}
DEFAULT_STATIC_ITERS = 12

# dry-run parameter overrides per (algo, variant): the steady-state
# compressed exchange (bf16 payload, no precision switch read)
DRYRUN_PARAMS = {
    ("pagerank", "fast"): {"compress": "always"},
}

_INPUT_DTYPES = {"vertex_f32": torch.float32, "vertex_i32": torch.int32}


def _graph_model_flops(g, algo: str, iters: int) -> float:
    e_total = g.e_max * g.parts
    if algo == "pagerank":
        return 2.0 * e_total * iters      # multiply-add per edge per iter
    if algo == "sssp":
        return 2.0 * e_total * iters      # relax (add+min) per edge per round
    if algo == "cc":
        return 4.0 * e_total * iters      # min-combine both edge directions
    if algo == "triangles":
        # dense masked-matmul intersection: (n_local, n) x (n, n_local)
        # per round x P rounds = one n x n x n_local contraction total
        return 2.0 * float(g.n) * g.n * g.n_local
    if algo == "kcore":
        return 4.0 * e_total * iters      # decrement scan, both directions
    if algo == "betweenness":
        return 4.0 * e_total * iters      # forward push + backward pull
    return 2.0 * e_total                  # bfs: one relax pass over all edges


class PlanComm(StackedComm):
    """``StackedComm`` that also tallies ``psum_scalar``: the JAX
    package's ``psum``, an all-reduce of one scalar, under op ``psum``
    (the blocking exchanges' tallies leave it out: it is control plane).
    Everything else is ``StackedComm``'s."""

    def __init__(self, parts: int, device):
        super().__init__(parts, device)
        self.psum: list[int] = [0, 0]           # bytes a part, calls

    def reset_wire(self) -> None:
        super().reset_wire()
        self.psum = [0, 0]

    def psum_scalar(self, x: torch.Tensor):
        self.psum[0] += x.element_size()
        self.psum[1] += 1
        return super().psum_scalar(x)

    def plan_tally(self) -> dict:
        """The exchange tallies by op (phases summed), psum included."""
        out: dict[str, tuple[int, int]] = {}
        for (_, op), (b, n) in self.tally().items():
            b0, n0 = out.get(op, (0, 0))
            out[op] = (b0 + b, n0 + n)
        if self.psum[1]:
            out["psum"] = tuple(self.psum)
        return out


def _inputs(spec, eng) -> tuple:
    """Per-query inputs of one planning run: root 0, or meta vertex
    fields of the input's dtype."""
    out = []
    for kind in spec.input_kinds:
        if kind == "scalar":
            out.append(0)
        else:
            out.append(torch.empty((eng.comm.local_parts, eng.g.n_local),
                                   dtype=_INPUT_DTYPES[kind],
                                   device=eng.device))
    return tuple(out)


def plan_program(eng: GraphEngine, garr: dict, algo: str, variant: str,
                 static_iters: int, **params):
    """Run one program's ``static_iters`` build once under the counter on
    ``eng``'s device.  Returns ``(prog, cost, plan tally, wall s)``; the
    engine's comm must be a :class:`PlanComm`."""
    comm = eng.comm
    prog = eng.program(algo, variant, static_iters=static_iters, **params)
    comm.reset_wire()
    t0 = time.perf_counter()
    cost = count_fn(prog, garr, *_inputs(prog.spec, eng))
    return prog, cost, comm.plan_tally(), time.perf_counter() - t0


def plan_engine(g, device="meta") -> GraphEngine:
    """A ``GraphEngine`` over ``g`` whose exchanges are a
    :class:`PlanComm` on ``device`` (programs are built lazily on the
    engine's comm, so it is swapped in before any is built)."""
    eng = GraphEngine(g, device=device)
    eng.comm = PlanComm(g.parts, eng.device)
    return eng


def graph_record(eng: GraphEngine, garr: dict, prog, cost, tally: dict,
                 wall_s: float, *, graph_name: str, mesh_name: str,
                 static_iters: int) -> dict:
    """The JAX package's dry-run record for one planned program."""
    g = eng.g
    parts = g.parts
    label = program_label(prog.spec.algo, prog.spec.variant)
    coll = RA.collective_stats(tally, parts)
    arg_bytes = sum(t.numel() * t.element_size() for t in garr.values())
    roof = RA.Roofline(
        arch=f"graph-{label}", shape=graph_name, mesh=mesh_name,
        devices=parts, flops_per_device=cost.total_flops / parts,
        # the reference's fusion estimate: a third of the unfused bytes
        bytes_per_device=cost.bytes_touched / parts / 3.0,
        collective_wire_bytes=coll["wire_bytes_f32_upper"],
        model_flops_total=_graph_model_flops(g, prog.spec.algo,
                                             static_iters),
        peak_hbm_bytes=(arg_bytes + cost.peak_live_bytes) / parts,
        collectives=coll).finalize()
    rec = roof.to_json()
    rec["jaxpr_matmul_flops_total"] = cost.matmul_flops
    rec["jaxpr_elementwise_flops_total"] = cost.elementwise_flops
    rec["jaxpr_bytes_unfused_total"] = cost.bytes_touched
    rec.update({
        "program": label,
        "exec_mode": prog.spec.exec_mode,
        "lower_compile_s": round(wall_s, 2),
        "arg_bytes_per_device": arg_bytes // parts,
        "temp_bytes_per_device": int(cost.peak_live_bytes) // parts,
        "status": "ok",
        "n_vertices": g.n, "e_max_per_part": g.e_max,
        "layout": eng.layout,
        "ell_slots_per_part": {name: m.slots
                               for name, m in g.ell_meta.items()},
        # the route that was counted: "ell" on meta (and on CPU tensors)
        "localops_impl": localops.resolve(device=eng.device),
    })
    # No bf16 halving of the reduce-scatter: the JAX package halves it
    # because the CPU backend promotes pagerank/fast's bf16 payload to
    # f32 in its HLO; the tallies count the bf16 bytes shipped.
    return rec


def lower_graph_programs(graph_name: str, mesh_name: str, out_dir=None,
                         algos=None, *, parts: int | None = None) -> list:
    """Plan every registered program (or the ``algo_variant`` labels in
    ``algos``) of ``graph_name`` at 256 parts (``mesh_name`` "pod") or
    512 ("multipod"), or ``parts`` when given; print each program's HBM
    per part and bottleneck, and write each record to ``out_dir``."""
    cfg = graph_workloads.ALL[graph_name]
    if parts is None:
        parts = 512 if mesh_name == "multipod" else 256
    g = abstract_graph(cfg.num_vertices, cfg.avg_degree, parts)
    eng = plan_engine(g)
    garr = g.abstract_arrays(eng.layout)

    records = []
    for algo, variant in registry.available():
        label = program_label(algo, variant)
        if algos is not None and label not in algos:
            continue
        it_count = STATIC_ITERS.get(algo, DEFAULT_STATIC_ITERS)
        if it_count == "parts":
            it_count = parts
        params = dict(DRYRUN_PARAMS.get((algo, variant), {}))
        prog, cost, tally, dt = plan_program(eng, garr, algo, variant,
                                             it_count, **params)
        rec = graph_record(eng, garr, prog, cost, tally, dt,
                           graph_name=graph_name, mesh_name=mesh_name,
                           static_iters=it_count)
        hbm = (rec["arg_bytes_per_device"]
               + rec["temp_bytes_per_device"]) / 1e9
        h = rec["h100"]
        print(f"[graph {label} x {graph_name} x {mesh_name}] "
              f"HBM/dev {hbm:.2f} GB | bottleneck {rec['bottleneck']} "
              f"(c={rec['compute_s'] * 1e3:.2f}ms "
              f"m={rec['memory_s'] * 1e3:.2f}ms "
              f"x={rec['collective_s'] * 1e3:.2f}ms) | H100 "
              f"{h['bottleneck']} (c={h['compute_s'] * 1e3:.2f}ms "
              f"m={h['memory_s'] * 1e3:.2f}ms "
              f"x={h['collective_s'] * 1e3:.2f}ms)")
        if out_dir:
            out = pathlib.Path(out_dir)
            out.mkdir(parents=True, exist_ok=True)
            (out / f"graph-{label}__{graph_name}__{mesh_name}.json") \
                .write_text(json.dumps(rec, indent=2))
        records.append(rec)
    return records


def measure_vs_plan(eng: GraphEngine, garr: dict, algo: str, variant: str,
                    static_iters: int, **params) -> dict:
    """Plan one program on meta copies of the resident arrays ``garr``
    (same graph, same metas), then run the same ``static_iters`` build
    on ``eng``'s device, in its local-ops mode.

    Returns the planned argument bytes beside the resident arrays'
    bytes, the planned temp bytes beside the run's measured peak above
    what was allocated before it (CUDA only; ``None`` elsewhere), and
    the planned exchange tallies beside the run's.  The plan counts the
    ``ell`` route; on the card a run in mode ``auto`` takes the kernels,
    which allocate no per-slot temporaries."""
    plan_eng = plan_engine(eng.g)
    meta = {k: torch.empty_like(v, device="meta") for k, v in garr.items()}
    _, cost, tally, wall = plan_program(plan_eng, meta, algo, variant,
                                        static_iters, **params)
    prog = eng.program(algo, variant, static_iters=static_iters, **params)
    inputs = tuple(0 if kind == "scalar" else torch.zeros(
        (eng.comm.local_parts, eng.g.n_local), dtype=_INPUT_DTYPES[kind],
        device=eng.device) for kind in prog.spec.input_kinds)
    card = eng.device.type == "cuda"
    if card:
        torch.cuda.synchronize(eng.device)
        torch.cuda.reset_peak_memory_stats(eng.device)
        before = torch.cuda.memory_allocated(eng.device)
    comm = eng.comm
    t0 = comm.tally()
    prog(garr, *inputs)
    peak = None
    if card:
        torch.cuda.synchronize(eng.device)
        peak = torch.cuda.max_memory_allocated(eng.device) - before
    run_tally: dict[str, tuple[int, int]] = {}
    for (ph, op), (b, n) in comm.tally().items():
        b0, n0 = t0.get((ph, op), (0, 0))
        cb, cn = run_tally.get(op, (0, 0))
        run_tally[op] = (cb + b - b0, cn + n - n0)
    plan_wire = {op: v for op, v in tally.items() if op != "psum"}
    return {"program": program_label(algo, variant),
            "planned_arg_bytes": sum(t.numel() * t.element_size()
                                     for t in meta.values()),
            "resident_bytes": sum(t.numel() * t.element_size()
                                  for t in garr.values()),
            "planned_temp_bytes": int(cost.peak_live_bytes),
            "measured_peak_bytes": peak,
            "planned_wire": plan_wire,
            "run_wire": {op: v for op, v in run_tally.items() if v[1]},
            "plan_s": wall}
