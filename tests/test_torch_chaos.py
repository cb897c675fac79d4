"""The port's fault layer against the JAX package's: the chaos sweep of
tests/test_chaos.py at parts 2 (this file) and 4
(test_torch_chaos_p4.py), on urand N=256, seed 5, root 3, with the
conformance parameters.

One reference subprocess per parts count records, for every registered
pair: the uninterrupted run's rounds and outputs, and the chaos run's
detections, recoveries, checkpoints and rounds under the sweep's
schedule (a drop, a corruption and a stall, clipped to the run's
rounds, seed 7, ``checkpoint_every=2``); for bfs/fast, pagerank/fast,
betweenness and bfs/async also the guarded verdict and rounds under
each of five one-event schedules (seed 3).  The port must give:

  * the same rounds, and outputs equal to the reference's (pagerank's
    ranks within the parity tolerances of test_torch_programs.py and
    test_torch_async.py);
  * a checkpointed run and a resume from its middle snapshot
    bit-identical to its own uninterrupted run;
  * the same detections, recoveries, checkpoints and rounds under the
    chaos schedule, outputs bit-identical to its uninterrupted run and
    passing the NumPy oracle (tests/oracle.py);
  * the same guarded verdicts and rounds under the one-event schedules,
    and the same vertex outputs where the guarded run stopped (pagerank's
    within the same tolerances, NaN where the reference has NaN);
  * the reference's ``guards_markdown_table()`` and ``guard_doc``s.
"""

import json
import os

import numpy as np
import pytest
import torch

import oracle
from conftest import run_with_devices
from repro.core import registry as ref_registry
from repro_torch.core import CheckpointRunner, GraphEngine, incremental, \
    partition_graph, registry

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
N, SEED, ROOT = 256, 5, 3
PAIRS = registry.available()
VERDICT_PAIRS = (("bfs", "fast"), ("pagerank", "fast"),
                 ("betweenness", "default"), ("bfs", "async"))
VERDICT_SCHEDULES = ("drop@r1p0", "corrupt@r1p0:min", "stall@r1p0x2",
                     "dup@r1p0", "stale@r1p0")
VERDICT_SEED = 3
PARTS = 2

_REFERENCE = """
import json, sys
sys.path.insert(0, {tests_dir!r})
import numpy as np
import jax.numpy as jnp
import oracle
from repro.core import CheckpointRunner, GraphEngine, incremental, \\
    partition_graph, registry
from repro.launch.mesh import make_graph_mesh

parts, root = {parts}, {root}
edges, n = oracle.family_edges("urand", {n}, {seed})
g = partition_graph(edges, n, parts)
eng = GraphEngine(g, make_graph_mesh(parts))
garr = eng.device_graph()
meta, arrays = {{}}, {{}}
for algo, variant in registry.available():
    spec = registry.get_spec(algo, variant)
    params = oracle.CONFORMANCE_PARAMS.get((algo, variant), {{}})
    if any(k != "scalar" for k in spec.input_kinds):
        (seed_arr,) = incremental.cold_seed(spec, g)
        ins = (eng.scatter_vertex_field(
            seed_arr, incremental.KIND_DTYPES[spec.input_kinds[0]]),)
    else:
        ins = (jnp.int32(root),) * len(spec.inputs)
    key = f"{{algo}}/{{variant}}"
    prog = eng.program(algo, variant, **params)
    *outs, rounds = prog(garr, *ins)
    cell = meta[key] = {{"rounds": int(rounds), "scalars": {{}}}}
    p = prog.program
    for name, o, isv in zip(p.output_names, outs, p.output_is_vertex):
        if isv:
            arrays[f"{{key}}/{{name}}"] = eng.gather_vertex_field(o)
        else:
            cell["scalars"][name] = np.asarray(o).item()
    R = max(int(rounds), 1)
    r1, r2, r3 = min(1, R - 1), min(2, R - 1), min(3, R - 1)
    sched = (f"drop@r{{r1}}p0 corrupt@r{{r2}}p{{min(1, parts - 1)}} "
             f"stall@r{{r3}}p0x2 seed=7")
    rep = CheckpointRunner(eng, algo, variant, checkpoint_every=2,
                           faults=sched, **params).run(garr, *ins)
    cell["chaos"] = {{"schedule": sched, "rounds": int(rep.rounds),
                     "detections": [int(d) for d in rep.detections],
                     "recoveries": rep.recoveries,
                     "checkpoints": rep.checkpoints}}
    if (algo, variant) in {verdict_pairs!r}:
        cell["verdicts"] = {{}}
        for spec_ in {verdict_schedules!r}:
            gp = eng.program(algo, variant, guard=True,
                             faults=f"{{spec_}} seed={verdict_seed}",
                             **params)
            *gouts, grounds, ok = gp(garr, *ins)
            cell["verdicts"][spec_] = [int(grounds), int(ok)]
            for name, o, isv in zip(p.output_names, gouts,
                                    p.output_is_vertex):
                if isv:
                    arrays[f"{{key}}/{{spec_}}/{{name}}"] = \
                        eng.gather_vertex_field(o)
np.savez({out!r} + ".npz", **arrays)
json.dump(meta, open({out!r} + ".json", "w"))
print("REFERENCE-OK")
"""


def reference(parts: int, tmp_dir):
    """The reference's records at ``parts``: (meta, arrays)."""
    out = os.path.join(str(tmp_dir), f"chaos{parts}")
    log = run_with_devices(_REFERENCE.format(
        tests_dir=TESTS_DIR, parts=parts, root=ROOT, n=N, seed=SEED,
        verdict_pairs=VERDICT_PAIRS, verdict_schedules=VERDICT_SCHEDULES,
        verdict_seed=VERDICT_SEED, out=out), devices=parts, timeout=900)
    assert "REFERENCE-OK" in log
    return json.load(open(out + ".json")), dict(np.load(out + ".npz"))


class Port:
    """The port's engine on the same partition, and the inputs of each
    pair (the incremental variants from their cold seeds)."""

    def __init__(self, parts: int):
        self.parts = parts
        self.edges, self.n = oracle.family_edges("urand", N, SEED)
        self.g = partition_graph(self.edges, self.n, parts)
        self.eng = GraphEngine(self.g, device="cpu")
        self.garr = self.eng.device_graph()

    def inputs(self, algo: str, variant: str) -> tuple:
        spec = registry.get_spec(algo, variant)
        if any(k != "scalar" for k in spec.input_kinds):
            (seed_arr,) = incremental.cold_seed(spec, self.g)
            return (self.eng.scatter_vertex_field(
                seed_arr, incremental.KIND_DTYPES[spec.input_kinds[0]]),)
        return (ROOT,) * len(spec.inputs)

    def fields(self, prog, outs) -> dict:
        return {nm: (self.eng.gather_vertex_field(o) if isv else o)
                for nm, o, isv in zip(prog.output_names, outs,
                                      prog.output_is_vertex)}


def _same(a: tuple, b: tuple) -> bool:
    """Outputs equal bit for bit (tensors by dtype, shape and bytes)."""
    for x, y in zip(a, b, strict=True):
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or x.shape != y.shape \
                    or x.numpy().tobytes() != y.numpy().tobytes():
                return False
        elif x != y:
            return False
    return True


def _rank_tol(variant: str) -> float:
    return oracle.ASYNC_PR_REL_TOL if variant in ("warm", "async") else 1e-5


def check_pair(port: Port, ref, algo: str, variant: str) -> None:
    meta, arrays = ref
    key = f"{algo}/{variant}"
    cell = meta[key]
    what = f"{key} parts={port.parts}"
    eng, garr = port.eng, port.garr
    params = oracle.CONFORMANCE_PARAMS.get((algo, variant), {})
    ins = port.inputs(algo, variant)
    prog = eng.program(algo, variant, **params)
    *outs, rounds = prog(garr, *ins)
    p = prog.program
    assert rounds == cell["rounds"], what
    fields = port.fields(p, outs)
    for name, got in fields.items():
        if isinstance(got, np.ndarray):
            want = arrays[f"{key}/{name}"]
            assert got.dtype == want.dtype, f"{what} {name}"
            if algo == "pagerank":
                rel = np.abs(got - want).max() / np.abs(want).max()
                assert rel < _rank_tol(variant), f"{what}: rank rel {rel:.2e}"
            else:
                np.testing.assert_array_equal(got, want, err_msg=what)
        elif name != "err":
            assert got == cell["scalars"][name], f"{what} {name}"

    # checkpointed, and resumed from the middle snapshot: the same bits
    runner = CheckpointRunner(eng, algo, variant, checkpoint_every=2,
                              keep_history=True, **params)
    rep = runner.run(garr, *ins)
    assert rep.recoveries == 0 and rep.detections == (), what
    assert rep.rounds == rounds and rep.checkpoints == len(rep.history)
    assert _same(rep.outputs, outs), f"{what}: checkpointed outputs"
    mid = rep.history[len(rep.history) // 2]
    rep2 = runner.run(garr, *ins, resume_from=mid)
    assert rep2.recoveries == 0, what
    assert _same(rep2.outputs, outs), f"{what}: resumed outputs"

    # chaos: the reference's detections, recoveries, checkpoints and
    # rounds; the uninterrupted bits; the oracle
    chaos = cell["chaos"]
    rep3 = CheckpointRunner(eng, algo, variant, checkpoint_every=2,
                            faults=chaos["schedule"], **params) \
        .run(garr, *ins)
    assert rep3.recoveries >= 1 and rep3.detections, what
    assert list(rep3.detections) == chaos["detections"], what
    assert (rep3.recoveries, rep3.checkpoints, rep3.rounds) \
        == (chaos["recoveries"], chaos["checkpoints"], chaos["rounds"]), what
    assert _same(rep3.outputs, outs), f"{what}: recovered outputs"
    oracle.check_conformance(algo, variant, port.fields(p, rep3.outputs),
                             port.edges, port.n, ROOT)


def check_verdict(port: Port, ref, algo: str, variant: str,
                  schedule: str) -> None:
    meta, arrays = ref
    key = f"{algo}/{variant}"
    what = f"{key} parts={port.parts} {schedule}"
    params = oracle.CONFORMANCE_PARAMS.get((algo, variant), {})
    prog = port.eng.program(algo, variant, guard=True,
                            faults=f"{schedule} seed={VERDICT_SEED}",
                            **params)
    *outs, rounds, ok = prog(port.garr, *port.inputs(algo, variant))
    assert [rounds, ok] == meta[key]["verdicts"][schedule], what
    for name, got in port.fields(prog.program, outs).items():
        if not isinstance(got, np.ndarray):
            continue
        want = arrays[f"{key}/{schedule}/{name}"]
        if algo == "pagerank":
            assert np.array_equal(np.isnan(got), np.isnan(want)), what
            ok_ = ~np.isnan(want)
            rel = np.abs(got[ok_] - want[ok_]).max() / np.abs(want[ok_]).max()
            assert rel < _rank_tol(variant), f"{what}: rank rel {rel:.2e}"
        else:
            np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread a worker keeps the test
    workers, which share the cores, from oversubscribing them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(PARTS, tmp_path_factory.mktemp("ref"))


@pytest.fixture(scope="module")
def port():
    return Port(PARTS)


@pytest.mark.chaos
@pytest.mark.parametrize("algo,variant", PAIRS)
def test_chaos_matches_reference(algo, variant, ref, port):
    check_pair(port, ref, algo, variant)


@pytest.mark.chaos
@pytest.mark.parametrize("schedule", VERDICT_SCHEDULES)
@pytest.mark.parametrize("algo,variant", VERDICT_PAIRS)
def test_guarded_verdicts_match_reference(algo, variant, schedule, ref,
                                          port):
    check_verdict(port, ref, algo, variant, schedule)


def test_guard_docs_match_reference():
    assert registry.guards_markdown_table() \
        == ref_registry.guards_markdown_table()
    assert registry.available() == ref_registry.available()
    for algo, variant in PAIRS:
        assert registry.get_spec(algo, variant).guard_doc \
            == ref_registry.get_spec(algo, variant).guard_doc, (algo, variant)
