"""The control of a cell's check, at the cell's own size, on the card.

    python3 graphbench/control.py --workload urand22-pagerank \
        --seeds 11 12 13

Every reading is a sample of the mix's ``check_sample`` answers judged
by the harness's own rule (``harness.judge``):

* ``control``: a mix with ``control_params`` runs the program with them
  (pagerank/fast's bf16 exchange every round, ``compress="always"``);
  the others put the reference in the program's place with the stated
  rule broken (``Session.control``), on the seed's graph alone.  It has
  to come out not correct;
* ``program`` (where the program runs): the program as the benchmark
  runs it, on the same set-up (the graph from the seed, partitioned, the
  program built), a sound reading;
* ``early`` (a mix with ``early_stop``): the program stopped
  ``early_stop`` rounds before the reference's rule stops (one halt
  test), the fault a change that stops early would make.

Each seed prints one JSON line.  The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from graphbench.run import environment  # noqa: E402


def _sample(setup, count: int) -> list:
    session = setup.session
    answers = [session.answer(i, session.call(i)) for i in range(count)]
    if setup.engine.device.type == "cuda":
        import torch
        torch.cuda.synchronize(setup.engine.device)
    return answers


def readings(cell, seed: int, device) -> dict:
    """``{reading: {"correct": ..., "values": ...}}`` on one seed."""
    import torch
    from graphbench import generate, harness, manifest

    device = torch.device(device)
    traffic, limits = cell.traffic, cell.limits
    count = int(traffic["check_sample"])
    params = traffic.get("control_params")
    early = traffic.get("early_stop")

    if params is None and not early:
        # the reference in the program's place: no set-up of the program
        n, _ = generate.sizes(cell.config)
        edges = generate.make_edges(cell.config, seed, device)
        session = manifest.program(traffic["program"]).Session(
            cell, seed, n, int(edges.shape[0]),
            torch.bincount(edges[:, 0], minlength=n))
        answers = session.control(edges, count)
        values = session.check(answers, edges)
        ok, _ = harness.judge(values, limits)
        return {"control": {"correct": bool(ok and answers),
                            "values": values}}

    setup = harness.prepare(cell, seed, device)
    session = setup.session
    base = traffic.get("params", {})
    edges = torch.from_numpy(setup.edges_host).to(device)
    out = {}

    def judged(answers):
        ok, _, values = harness.check(setup, answers, limits, device)
        return {"correct": bool(ok and answers), "values": values}

    out["program"] = judged(_sample(setup, count))
    if params is not None:
        session.bind(setup.engine, {**base, **params})
        out["control"] = judged(_sample(setup, count))
    if early:
        _, ref_rounds = session.reference(edges)
        session.bind(setup.engine,
                     {**base, "iters": max(1, ref_rounds - int(early))})
        out["early"] = judged(_sample(setup, count))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    environment()
    from graphbench import manifest

    cell = manifest.cell(manifest.load(), args.workload)
    for seed in args.seeds:
        r = readings(cell, seed, args.device)
        print(json.dumps({"workload": cell.name, "seed": seed, **r,
                          "limits": {k: v["limit"]
                                     for k, v in cell.limits.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
