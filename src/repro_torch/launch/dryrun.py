"""Dry-run: plan every (architecture x input shape) cell of the LM
registry on one card or on the production meshes, or every registered
graph program for a paper-scale urand graph at production part counts,
on meta tensors, and write their roofline records.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh single --out build/dryrun_lm
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch tinyllama-1.1b --shape all --mesh both --out build/dryrun_lm
  PYTHONPATH=src python -m repro_torch.launch.dryrun --graph urand28 \\
      --mesh both --out artifacts/dryrun

Planning needs no card and allocates nothing.  An LM cell
(``launch/steps.py::lower_cell``) runs its train, prefill or decode step
once on meta tensors under the counter and writes
``<arch>__<shape>__single.json`` with the JAX package's keys (its
``analyze`` record plus ``program``, ``lower_s``, the argument, temp and
output bytes and ``status``), the H100's terms under ``h100``,
``attention_route`` (meta tensors take the plain attention forward, so
the temp bytes are that route's) and the counted FLOPs and unfused
bytes under the keys the reference's ``recost`` gives them
(``jaxpr_*_total``), which ``roofline/recost.py`` prices.  There is no compile step:
``lower_s`` is the planning run's wall time and ``compile_s`` is absent
(the record's ``timing`` says so).  ``--mesh single`` is
``launch/mesh.make_local_mesh()``, the one card; ``pod`` and
``multipod`` (``both`` plans each) plan one device's step of the
sharded plan (``lower_cell`` over a fake process group of 256 or 512
ranks, started and destroyed in the planning process) and write
``<arch>__<shape>__<mesh>.json`` with the collectives the step issued
priced by the reference's ring model.  Sharded plans cover every
family of ``launch/steps.py::SHARDED_FAMILIES`` (all six).
``--smoke`` plans the reduced configs.

A graph program (``core/dryrun.py``) writes
``graph-<program>__<graph>__<mesh>.json``.  ``--measure P`` also
partitions the graph into P parts, uploads it and runs bfs/fast,
pagerank/bsp and pagerank/fast with their static trip counts beside
their plans (on the card unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

MEASURED = (("bfs", "fast"), ("pagerank", "bsp"), ("pagerank", "fast"))


LOWER_NOTE = ("lower_s is the wall time of the planning run on meta "
              "tensors; the port compiles nothing ahead of time, so the "
              "record has no compile_s")


def _mesh(mesh_name: str):
    from repro_torch.launch.mesh import make_local_mesh, \
        make_production_mesh
    if mesh_name == "single":
        return make_local_mesh()
    return make_production_mesh(multi_pod=mesh_name == "multipod")


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir, *,
             impl: str = "chunked", cfg=None) -> dict:
    """Plan one (arch x shape) cell on ``mesh_name`` (``single``, ``pod``
    or ``multipod``; at a pod mesh every family plans one device's
    sharded step), print its memory and roofline terms, and
    write its record to ``out_dir``.  ``cfg`` overrides the registry's
    configuration of ``arch``."""
    from repro_torch.configs.registry import get_arch, get_shape
    from repro_torch.launch.steps import lower_cell
    from repro_torch.roofline import analysis as RA

    cfg = cfg or get_arch(arch)
    shape = get_shape(shape_name)
    mesh = _mesh(mesh_name)
    plan, meta = lower_cell(cfg, shape, mesh, impl=impl)
    cost = plan.cost
    roof = RA.analyze(cost, arch=arch, shape_name=shape_name,
                      mesh_name=mesh_name, devices=mesh.size,
                      model_flops_total=RA.model_flops(cfg, shape),
                      arg_bytes=plan.arg_bytes, temp_bytes=plan.temp_bytes)
    rec = roof.to_json()
    rec.update({
        "program": meta["program"],
        "jaxpr_matmul_flops_total": cost.matmul_flops,
        "jaxpr_elementwise_flops_total": cost.elementwise_flops,
        "jaxpr_bytes_unfused_total": cost.bytes_touched,
        "lower_s": round(plan.lower_s, 2),
        "arg_bytes_per_device": plan.arg_bytes,
        "temp_bytes_per_device": plan.temp_bytes,
        "out_bytes_per_device": plan.out_bytes,
        "status": "ok",
        "attention_route": plan.attention_route,
        "timing": LOWER_NOTE,
    })
    h = roof.h100
    print(f"[{arch} x {shape_name} x {mesh_name}] {meta['program']}\n"
          f"  counted: matmul flops={cost.matmul_flops:.3e} "
          f"elementwise={cost.elementwise_flops:.3e} "
          f"bytes(unfused)={cost.bytes_touched:.3e}\n"
          f"  per-device HBM: {(plan.arg_bytes + plan.temp_bytes) / 1e9:.2f}"
          f" GB (args {plan.arg_bytes / 1e9:.2f} + temps "
          f"{plan.temp_bytes / 1e9:.2f}, {plan.attention_route} attention) "
          f"| bottleneck: {roof.bottleneck} (c={roof.compute_s * 1e3:.1f}ms "
          f"m={roof.memory_s * 1e3:.1f}ms x={roof.collective_s * 1e3:.1f}ms)"
          f" | H100 {h['bottleneck']} (c={h['compute_s'] * 1e3:.1f}ms "
          f"m={h['memory_s'] * 1e3:.1f}ms) useful-flops="
          f"{roof.useful_flops_ratio:.2f} | planned in {plan.lower_s:.1f} s",
          flush=True)
    if out_dir:
        out = pathlib.Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{arch}__{shape_name}__{mesh_name}.json").write_text(
            json.dumps(rec, indent=2))
    return rec


def _cell(task):
    """One cell of run_arch_dryrun: its record, or a failure record."""
    arch, shape_name, mesh_name, out_dir, impl, smoke = task
    from repro_torch.configs.registry import get_arch, smoke_config
    cfg = smoke_config(arch) if smoke else get_arch(arch)
    try:
        return run_cell(arch, shape_name, mesh_name, out_dir, impl=impl,
                        cfg=cfg)
    except Exception as e:  # noqa: BLE001 - report and continue
        traceback.print_exc()
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "fail", "error": repr(e)[:500]}
        if out_dir:
            out = pathlib.Path(out_dir)
            out.mkdir(parents=True, exist_ok=True)
            (out / f"{arch}__{shape_name}__{mesh_name}.json").write_text(
                json.dumps(rec, indent=2))
        return rec


def run_arch_dryrun(archs, shapes, mesh_name: str, out_dir, *,
                    impl: str = "chunked", smoke: bool = False,
                    jobs: int = 1) -> list:
    """Plan every cell of ``archs`` (``shapes`` a list of shape names, or
    ``all``: the shapes ``shapes_for`` gives each arch), reporting and
    recording a failed cell and going on, as the reference does; with
    ``jobs`` > 1, that many cells at once in worker processes.  Returns
    the records in cell order; prints the pass's wall time."""
    from repro_torch.configs.base import shapes_for
    from repro_torch.configs.registry import get_arch, smoke_config

    t0 = time.perf_counter()
    tasks = []
    for arch in archs:
        cfg = smoke_config(arch) if smoke else get_arch(arch)
        names = ([s.name for s in shapes_for(cfg)] if shapes == "all"
                 else list(shapes))
        tasks += [(arch, name, mesh_name, out_dir, impl, smoke)
                  for name in names]
    if jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(
                jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
            recs = list(ex.map(_cell, tasks))
    else:
        recs = [_cell(t) for t in tasks]
    print(f"[dryrun] {len(tasks)} cells of {len(archs)} archs planned in "
          f"{time.perf_counter() - t0:.1f} s ({jobs} at a time)", flush=True)
    return recs


def run_graph_dryrun(graph_name: str, mesh_name: str, out_dir) -> list:
    """Plan the paper's graph engine (every registered program)."""
    from repro_torch.core.dryrun import lower_graph_programs

    return lower_graph_programs(graph_name, mesh_name, out_dir)


def run_measured(graph_name: str, parts: int, device=None) -> list:
    """Plan and run MEASURED at ``parts`` on ``device`` (CUDA unless
    given); print and return each comparison."""
    import torch

    from repro_torch.configs import graph_workloads
    from repro_torch.core import GraphEngine, partition_graph
    from repro_torch.core.dryrun import DRYRUN_PARAMS, STATIC_ITERS, \
        measure_vs_plan
    from repro_torch.graphs import generate_edges

    cfg = graph_workloads.ALL[graph_name]
    edges = generate_edges(cfg)
    eng = GraphEngine(partition_graph(edges, cfg.num_vertices, parts),
                      device=device)
    garr = eng.device_graph()
    out = []
    for algo, variant in MEASURED:
        r = measure_vs_plan(eng, garr, algo, variant, STATIC_ITERS[algo],
                            **DRYRUN_PARAMS.get((algo, variant), {}))
        peak = r["measured_peak_bytes"]
        print(f"[measure {r['program']} x {graph_name} x parts={parts}] "
              f"args planned {r['planned_arg_bytes']} resident "
              f"{r['resident_bytes']} | temp planned "
              f"{r['planned_temp_bytes']} measured "
              f"{'not measured' if peak is None else peak} | wire "
              f"planned {r['planned_wire']} run {r['run_wire']}")
        out.append(r)
    del garr
    if eng.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None,
                    help="LM dry-run: an arch of the registry, several "
                         "joined by commas, or all")
    ap.add_argument("--shape", default="all",
                    help="a shape, several joined by commas, or all")
    ap.add_argument("--mesh", default=None,
                    choices=["single", "pod", "multipod", "both"],
                    help="single (the one card; --arch's default) or the "
                         "production meshes (--graph's; pod by default)")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--graph", default=None,
                    help="run the graph-engine dry-run for this workload")
    ap.add_argument("--impl", default="chunked")
    ap.add_argument("--smoke", action="store_true",
                    help="--arch: plan the reduced configs")
    ap.add_argument("--jobs", type=int, default=1,
                    help="--arch: cells planned at once (worker processes)")
    ap.add_argument("--measure", type=int, default=0, metavar="P",
                    help="also run the measured programs at P parts")
    ap.add_argument("--device", default=None,
                    help="device of --measure: cuda (the default) or cpu")
    args = ap.parse_args()

    if args.graph:
        mesh = args.mesh or "pod"
        if mesh == "single":
            ap.error("--graph plans the production meshes: pod, multipod "
                     "or both")
        for m in (["pod", "multipod"] if mesh == "both" else [mesh]):
            run_graph_dryrun(args.graph, m, args.out)
        if args.measure:
            recs = run_measured(args.graph, args.measure, args.device)
            print(json.dumps(recs))
        return
    if args.arch is None:
        ap.error("give --arch (an arch or all) or --graph")
    mesh = args.mesh or "single"
    from repro_torch.configs.registry import ARCHS
    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = "all" if args.shape == "all" else args.shape.split(",")
    recs = []
    for m in (["pod", "multipod"] if mesh == "both" else [mesh]):
        recs += run_arch_dryrun(archs, shapes, m, args.out, impl=args.impl,
                                smoke=args.smoke, jobs=args.jobs)
    failures = [r for r in recs if r["status"] != "ok"]
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", (f["arch"], f["shape"], f["mesh"], f["error"][:200]))
        raise SystemExit(1)
    print("\nAll dry-run cells passed.")


if __name__ == "__main__":
    main()
