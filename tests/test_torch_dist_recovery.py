"""``CheckpointRunner`` over ``DistComm`` (one part a rank, gloo ranks on
the CPU) against ``StackedComm``'s runner at the same parts, and at parts
4 against the JAX package's records.

  * urand N=4096 (seed 5, root 3), parts 2 and 4, under ``drop@r1p0
    corrupt@r2p1 stall@r3p0x2 seed=7`` at ``checkpoint_every=2``:
    bfs/fast, pagerank/bsp, pagerank/fast, bfs/async and sssp/async give
    gathered outputs, rounds, detections, recoveries and checkpoints
    bit-equal to the stacked runner's, and outputs bit-equal to a direct
    run's;
  * every rank resumes a clean checkpointed run from its own middle
    checkpoint, bit-equal;
  * bfs/async at ``checkpoint_every=1``: every checkpoint was taken with
    an exchange in flight and holds it as a finished ``Pending``; a
    resume from each gives the bits of a run never rolled back;
  * a resume from checkpoints of different rounds raises ``ValueError``
    on every rank;
  * at parts 4, on tests/test_torch_chaos.py's graph (urand N=256) under
    the schedules its reference helper clips to each run's rounds: the
    reference's detections, recoveries, checkpoints and rounds.

One spawn of P rank processes a parts count (a file rendezvous, one
torch thread a rank); a rank that fails fails the test.  The spawn
helper is shared with tests/test_torch_dist_serve.py."""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import oracle
from conftest import SRC
from repro_torch.core import CheckpointRunner, GraphEngine, partition_graph
from repro_torch.core.partitioned import Pending
from repro_torch.launch.mesh import make_graph_mesh

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
N, SEED, ROOT = 4096, 5, 3
PARTS = (2, 4)
CHAOS = "drop@r1p0 corrupt@r2p1 stall@r3p0x2 seed=7"
EVERY = 2
PROGRAMS = (("bfs", "fast"), ("pagerank", "bsp"), ("pagerank", "fast"),
            ("bfs", "async"), ("sssp", "async"))
IN_FLIGHT = ("bfs", "async")
REF_N = 256             # tests/test_torch_chaos.py's graph
SPAWN_TIMEOUT_S = 240


# ---------------------------------------------------------------------------
# the spawn: P rank processes of a test module's ``rank_main``
# ---------------------------------------------------------------------------

_WORKER = ("import sys; sys.path[:0] = [{tests!r}, {src!r}]; "
           "import {module} as t; t.rank_main(sys.argv[1:])")


def spawn(tmp_path, world: int, job: str, module: str = __name__,
          **args) -> list:
    """Run ``job`` of ``module``'s ``rank_main`` on ``world`` rank
    processes; every rank's pickled result, in rank order.  A rank that
    exits non-zero, or outlives the timeout, fails the spawn."""
    out_dir = tmp_path / f"{job}-{world}-{len(os.listdir(tmp_path))}"
    out_dir.mkdir()
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    code = _WORKER.format(tests=TESTS_DIR, src=SRC, module=module)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world),
         str(out_dir / "rdzv"), job, json.dumps(args), str(out_dir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(
        log[-3000:] for log in logs)
    return [pickle.load(open(out_dir / f"rank{r}.pkl", "rb"))
            for r in range(world)]


def join_group(argv):
    """Parse a rank's argv, pin one torch thread and join the gloo
    group: ``(rank, world, job, args, out_dir)``."""
    import torch.distributed as dist
    rank, world, rdzv, job, args, out_dir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                            rank=rank, world_size=world)
    return rank, world, job, json.loads(args), out_dir


def leave_group(rank: int, out_dir: str, res) -> None:
    import torch.distributed as dist
    try:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# what both meshes run
# ---------------------------------------------------------------------------

def _params(algo, variant) -> dict:
    return oracle.CONFORMANCE_PARAMS.get((algo, variant), {})


def _fields(eng, prog, outs) -> dict:
    return {nm: (eng.gather_vertex_field(o) if isv else o)
            for nm, o, isv in zip(prog.output_names, outs,
                                  prog.output_is_vertex)}


def _report(eng, runner, rep) -> dict:
    return {"fields": _fields(eng, runner.program, rep.outputs),
            "rounds": rep.rounds, "detections": rep.detections,
            "recoveries": rep.recoveries, "checkpoints": rep.checkpoints}


def recovery_runs(eng) -> dict:
    """Per program: the direct run, the chaos runner, and a clean
    checkpointed run resumed from its middle checkpoint; for bfs/async
    also every checkpoint's handle type and a resume from each."""
    garr = eng.device_graph()
    out = {}
    for algo, variant in PROGRAMS:
        params = _params(algo, variant)
        prog = eng.program(algo, variant, **params)
        *outs, rounds = prog(garr, ROOT)
        chaos = CheckpointRunner(eng, algo, variant, checkpoint_every=EVERY,
                                 faults=CHAOS, **params)
        clean = CheckpointRunner(eng, algo, variant, checkpoint_every=EVERY,
                                 keep_history=True, **params)
        crep = clean.run(garr, ROOT)
        mid = crep.history[len(crep.history) // 2]
        cell = out[f"{algo}/{variant}"] = {
            "direct": {"fields": _fields(eng, prog.program, outs),
                       "rounds": rounds},
            "chaos": _report(eng, chaos, chaos.run(garr, ROOT)),
            "checkpointed": _report(eng, clean, crep),
            "resumed": _report(eng, clean,
                               clean.run(garr, ROOT, resume_from=mid)),
            "mid": (mid.phase, mid.rounds, mid.part)}
        if (algo, variant) == IN_FLIGHT:
            every = CheckpointRunner(eng, algo, variant, checkpoint_every=1,
                                     keep_history=True, **params)
            hist = every.run(garr, ROOT).history
            cell["handles"] = [
                (type(ck.carry[1]).__name__,
                 getattr(ck.carry[1], "work", None) is None)
                for ck in hist]
            cell["each"] = [_report(eng, every,
                                    every.run(garr, ROOT, resume_from=ck))
                            for ck in hist]
    return out


def reference_runs(eng) -> dict:
    """The five programs on tests/test_torch_chaos.py's graph under the
    schedule its reference helper builds from each run's rounds."""
    garr = eng.device_graph()
    parts = eng.g.parts
    out = {}
    for algo, variant in PROGRAMS:
        params = _params(algo, variant)
        *_, rounds = eng.program(algo, variant, **params)(garr, 3)
        R = max(int(rounds), 1)
        r1, r2, r3 = min(1, R - 1), min(2, R - 1), min(3, R - 1)
        sched = (f"drop@r{r1}p0 corrupt@r{r2}p{min(1, parts - 1)} "
                 f"stall@r{r3}p0x2 seed=7")
        runner = CheckpointRunner(eng, algo, variant, checkpoint_every=2,
                                  faults=sched, **params)
        rep = runner.run(garr, 3)
        out[f"{algo}/{variant}"] = {
            "schedule": sched, "rounds": rep.rounds,
            "detections": [int(d) for d in rep.detections],
            "recoveries": rep.recoveries, "checkpoints": rep.checkpoints,
            "fields": _fields(eng, runner.program, rep.outputs)}
    return out


def mismatched_resume(eng, rank: int) -> str:
    """Rank 0 resumes bfs/fast from its first checkpoint, the others
    from their second: what every rank raises."""
    garr = eng.device_graph()
    runner = CheckpointRunner(eng, "bfs", "fast", checkpoint_every=1,
                              keep_history=True)
    hist = runner.run(garr, ROOT).history
    try:
        runner.run(garr, ROOT, resume_from=hist[0 if rank == 0 else 1])
    except ValueError as e:
        return str(e)
    return "no error"


def rank_main(argv) -> None:
    rank, world, job, args, out_dir = join_group(argv)
    res = None
    try:
        mesh = make_graph_mesh(world)
        edges = np.load(args["edges"])
        eng = GraphEngine(partition_graph(edges, args["n"], world),
                          device="cpu", mesh=mesh)
        res = {"runs": recovery_runs(eng),
               "mismatch": mismatched_resume(eng, rank),
               "comm": repr(eng.comm)}
        if "ref_edges" in args:
            ref = GraphEngine(partition_graph(np.load(args["ref_edges"]),
                                              REF_N, world),
                              device="cpu", mesh=mesh)
            res["reference"] = reference_runs(ref)
    finally:
        leave_group(rank, out_dir, res)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def _same(a, b) -> bool:
    """Equal bits for arrays (and dtypes), equal values otherwise."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() \
            and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) \
            and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape \
            and a.tobytes() == b.tobytes()
    if isinstance(a, float) and isinstance(b, float):
        return np.float64(a).tobytes() == np.float64(b).tobytes()
    return a == b


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """parts -> (rank results, StackedComm's runs[, its reference
    runs]), each spawned once for the module."""
    cache = {}

    def get(parts):
        if parts not in cache:
            tmp = tmp_path_factory.mktemp(f"recovery{parts}")
            edges, n = oracle.family_edges("urand", N, SEED)
            np.save(tmp / "edges.npy", edges)
            args = {"edges": str(tmp / "edges.npy"), "n": n}
            stacked = {"runs": recovery_runs(GraphEngine(
                partition_graph(edges, n, parts), device="cpu"))}
            if parts == 4:
                ref_edges, _ = oracle.family_edges("urand", REF_N, SEED)
                np.save(tmp / "ref_edges.npy", ref_edges)
                args["ref_edges"] = str(tmp / "ref_edges.npy")
                stacked["reference"] = reference_runs(GraphEngine(
                    partition_graph(ref_edges, REF_N, parts), device="cpu"))
            cache[parts] = (spawn(tmp, parts, "recovery", **args), stacked)
        return cache[parts]
    return get


@pytest.mark.parametrize("parts", PARTS)
def test_chaos_runner_matches_stacked(parts, runs):
    ranks, stacked = runs(parts)
    for rank, got in enumerate(ranks):
        assert got["comm"] == f"DistComm(parts={parts}, rank={rank}, " \
            "backend=gloo, device=cpu)"
        for key, want in stacked["runs"].items():
            g = got["runs"][key]
            cell = f"{key} parts={parts} rank={rank}"
            for run in ("direct", "chaos", "checkpointed"):
                assert _same(g[run], want[run]), f"{cell}: {run}"
            chaos = g["chaos"]
            assert chaos["detections"] and chaos["recoveries"] >= 1, cell
            assert _same(chaos["fields"], g["direct"]["fields"]), cell
            assert chaos["rounds"] == g["direct"]["rounds"], cell


@pytest.mark.parametrize("parts", PARTS)
def test_resume_from_each_ranks_middle_checkpoint(parts, runs):
    ranks, stacked = runs(parts)
    for rank, got in enumerate(ranks):
        for key, want in stacked["runs"].items():
            g = got["runs"][key]
            cell = f"{key} parts={parts} rank={rank}"
            assert g["mid"] == want["mid"][:2] + (rank,), cell
            assert _same(g["resumed"]["fields"], g["direct"]["fields"]), cell
            assert _same(g["resumed"], want["resumed"]), cell


@pytest.mark.parametrize("parts", PARTS)
def test_in_flight_handle_snapshot_restores_bits(parts, runs):
    ranks, stacked = runs(parts)
    key = "/".join(IN_FLIGHT)
    want = stacked["runs"][key]
    for rank, got in enumerate(ranks):
        g = got["runs"][key]
        # every checkpoint of the async loop holds the exchange it
        # snapshotted in flight, finished into its received rows
        assert g["handles"] and g["handles"] == \
            [("Pending", True)] * len(g["handles"]), g["handles"]
        assert want["handles"] == [("Tensor", True)] * len(g["handles"])
        assert len(g["each"]) == len(want["each"])
        for i, (res, w) in enumerate(zip(g["each"], want["each"])):
            assert _same(res["fields"], g["direct"]["fields"]), (rank, i)
            assert _same(res, w), (rank, i)


@pytest.mark.parametrize("parts", PARTS)
def test_mismatched_resume_raises_on_every_rank(parts, runs):
    ranks, _ = runs(parts)
    for got in ranks:
        assert "resume checkpoints disagree across ranks" \
            in got["mismatch"], got["mismatch"]


def test_parts4_match_reference_records(runs, tmp_path_factory):
    """The reference's records (tests/test_torch_chaos.py's helper at
    parts 4) for the five programs, on every rank and stacked."""
    from test_torch_chaos import reference
    meta, arrays = reference(4, tmp_path_factory.mktemp("ref4"))
    ranks, stacked = runs(4)
    for key, want in stacked["reference"].items():
        rec = meta[key]["chaos"]
        for who, got in [("stacked", want)] + [
                (f"rank {r}", x["reference"][key])
                for r, x in enumerate(ranks)]:
            assert got["schedule"] == rec["schedule"], (key, who)
            assert (got["detections"], got["recoveries"],
                    got["checkpoints"], got["rounds"]) == (
                rec["detections"], rec["recoveries"], rec["checkpoints"],
                rec["rounds"]), (key, who)
            assert _same(got["fields"], want["fields"]), (key, who)
        for name, field in want["fields"].items():
            if isinstance(field, np.ndarray) and "pagerank" not in key:
                np.testing.assert_array_equal(field,
                                              arrays[f"{key}/{name}"],
                                              err_msg=key)
