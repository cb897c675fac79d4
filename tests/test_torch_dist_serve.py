"""The graph server, its mutations and its durability over ``DistComm``
(one part a rank, gloo ranks on the CPU; rank 0 leads, the others
follow), against the stacked server at the same parts.

On urand N=1024 (seed 5), at parts 2 and 4, the same code runs on every
rank and, stacked, in this process:

  * served answers (bfs/fast over a bucket of 8 and a singleton, sssp,
    cc and pagerank/fast refreshes, then cc/incremental and
    pagerank/warm from the seed store) bit-equal to the stacked server's
    and to direct runs; the other ranks return no results;
  * a query whose deadline passes in the queue, and one shed at
    admission, resolve on rank 0 alone and no rank hangs;
  * a launch failing on rank 1 alone (monkeypatched) is retried on
    every rank and answers;
  * a patching batch (16 deletes, 16 inserts, sampled on every rank
    from one generator: the stacked planner's batch) and a rebuilding
    batch leave every rank's mirrors, planner state and device arrays
    equal to the stacked server's row ``rank``, with ``MutationStats``
    equal; the answers after each equal the stacked server's;
  * a delete of an absent edge whose source only rank 1 holds raises
    ``KeyError`` on every rank and leaves every part untouched;
  * a durable server (4 batches of 16 + 16, a snapshot every 2 epochs,
    then a rebuilding batch): rank 0's WAL bytes equal the stacked
    server's, ``GraphServer.recover(mesh=)`` gives every rank the
    uninterrupted server's part and answers, a crash between two ranks'
    snapshot writes (the newest manifest and one rank's file gone)
    recovers the previous snapshot epoch and replays to the same state,
    and a stacked recovery of the ranks' directory, or a rank recovery
    of the stacked one, raises ``ValueError``;
  * the launcher under ``torchrun`` with two gloo ranks serves a timed
    trace with a mutation stream and a WAL, then ``--recover`` resumes
    it; its WAL bytes and final epoch equal the one-process launcher's.
"""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import oracle
from conftest import REPO, SRC
from repro_torch.core import GraphEngine, partition_graph, registry
from repro_torch.launch.mesh import make_graph_mesh
from repro_torch.serve import GraphServer, Persistence, query
from repro_torch.serve.persist.snapshot import find_manifests
from repro_torch.serve.persist.wal import wal_path
from test_torch_dist_recovery import join_group, leave_group, spawn

N, SEED = 1024, 5
PARTS = (2, 4)
BUCKETS = (1, 8)
BATCH = 16              # deletes and inserts a patching batch
HOT = 200               # copies of edge (0, 1): past any part's free pool
DURABLE_BATCHES = 4
FAIL_RANK = 1
COO_KEYS = ("out_src_local", "out_dst_global", "in_src_global",
            "in_dst_local", "out_degree", "in_degree")


def _queries():
    return ([query("bfs", "fast", root=r) for r in range(9)]
            + [query("sssp", root=r) for r in (0, 5)]
            + [query("cc"), query("pagerank", "fast")])


def _seeded():
    return [query("cc", "incremental"), query("pagerank", "warm")]


def _records(results) -> list:
    return [(r.status, f"{r.key.algo}/{r.key.variant}", r.root, r.rounds,
             r.bucket, r.epoch,
             dict(r.fields)) for r in results]


def _mirrors(server) -> dict:
    """The part(s) this process holds: host mirrors, planner state, and
    whether every device array equals its mirror."""
    g, dyn = server.engine.g, server.dynamic_graph()
    out = {k: getattr(g, k).copy() for k in COO_KEYS}
    out.update({k: v.copy() for k, v in g.ell_arrays.items()})
    st = dyn.planner_state()
    out["planner"] = {k: st[k] for k in ("occ", "free_out", "free_in",
                                         "pos_out", "pos_in")}
    out["on device"] = all(
        np.array_equal(server.garr[k].cpu().numpy(), out[k])
        for k in out if k in server.garr)
    return out


def _stats(s) -> tuple:
    return (s.epoch, s.n_insert, s.n_delete, s.slots_patched,
            s.arrays_patched, s.rebuild)


def serve_job(make_engine, args: dict) -> dict:
    """What every rank (or the one stacked process) runs; a follower
    passes the same calls, and its results are the empty lists."""
    out = {}
    eng = make_engine()
    rank = eng.comm.first_part
    server = GraphServer(eng, buckets=BUCKETS, retry_backoff_s=0.0)
    out["warmed"] = server.warmup(["bfs/fast", "cc"])
    out["served"] = _records(server.serve(_queries()))
    out["seeded"] = _records(server.serve(_seeded()))

    # deadlines and shedding: rank 0's decisions
    late = GraphServer(eng, buckets=BUCKETS)
    shed = GraphServer(eng, buckets=BUCKETS, max_queued=2)
    if late.leader:
        late.submit("bfs", "fast", root=1, deadline_s=1e-9)
        for r in (1, 2, 3):
            shed.submit("bfs", "fast", root=r)
    out["late"] = sorted((r.qid, r.status) for r in late.drain())
    out["shed"] = sorted((r.qid, r.status) for r in shed.drain())

    # a launch failing on one rank alone
    failing = GraphServer(eng, buckets=BUCKETS, retry_backoff_s=0.0)
    calls = {"program": 0, "launch": 0}
    program, run_launch = failing._program, failing._run_launch

    def bad_program(key, bucket):
        calls["program"] += 1
        if rank == FAIL_RANK and calls["program"] == 1:
            raise RuntimeError("injected launch failure")
        return program(key, bucket)

    def counted_launch(*a):
        calls["launch"] += 1
        return run_launch(*a)

    failing._program, failing._run_launch = bad_program, counted_launch
    out["failure"] = _records(failing.serve([query("bfs", "fast",
                                                   root=5)]))
    out["failure counts"] = (failing.metrics.counts["retries"],
                             calls["launch"])

    # mutation: a patching batch, a rebuilding batch, an absent delete
    mut = GraphServer(make_engine(), buckets=BUCKETS)
    dyn = mut.dynamic_graph()
    rng = np.random.default_rng(7)
    dels = dyn.sample_deletable(BATCH, rng)
    ins = dyn.sample_insertable(BATCH, rng)
    out["sampled"] = (dels, ins)
    out["patch"] = _stats(mut.mutate(inserts=ins, deletes=dels))
    out["patch mirrors"] = _mirrors(mut)
    out["patch served"] = _records(mut.serve(_queries()[7:]))
    out["rebuild"] = _stats(mut.mutate(inserts=np.tile([[0, 1]], (HOT, 1))))
    out["rebuild mirrors"] = _mirrors(mut)
    out["rebuild served"] = _records(mut.serve(_queries()[7:]))
    try:
        mut.mutate(deletes=np.array([args["absent"]]))
        out["absent"] = "no error"
    except KeyError as e:
        out["absent"] = str(e)
    out["absent untouched"] = _same(_mirrors(mut),
                                    out["rebuild mirrors"]) \
        and mut.epoch == out["rebuild"][0]

    # durability: batches, a snapshot every 2 epochs, a rebuild; recover
    d = args["dir"]
    dur = GraphServer(make_engine(), buckets=BUCKETS,
                      persistence=Persistence(dir=d, snapshot_every=2,
                                              fsync=False))
    rng = np.random.default_rng(11)
    ddyn = dur.dynamic_graph()
    for _ in range(DURABLE_BATCHES):
        dels = ddyn.sample_deletable(BATCH, rng)
        ins = ddyn.sample_insertable(BATCH, rng)
        dur.mutate(inserts=ins, deletes=dels)
    dur.mutate(inserts=np.tile([[2, 3]], (HOT, 1)))
    out["durable"] = _mirrors(dur)
    out["durable served"] = _records(dur.serve(_queries()[7:]))
    out["durable epoch"] = dur.epoch
    dur.close()
    rec = GraphServer.recover(d, mesh=eng.mesh, device="cpu",
                              buckets=BUCKETS)
    out["recovered"] = _mirrors(rec)
    out["recovered served"] = _records(rec.serve(_queries()[7:]))
    out["recovered report"] = (rec.epoch, rec.recovery_report.snapshot_epoch,
                               rec.recovery_report.replayed)
    rec.close()
    return out


def crash_job(eng, args: dict) -> dict:
    """Ranks only: a crash between two ranks' snapshot writes (the
    newest manifest never committed, rank 1's file of that epoch
    written), recovered; and a rank recovery of a stacked directory."""
    out = {}
    d, crashed = args["dir"], args["dir"] + "-crash"
    if eng.comm.leader:
        shutil.copytree(d, crashed)
        epoch, path = find_manifests(crashed)[0]
        os.unlink(path)
        os.unlink(os.path.join(crashed,
                               f"rank001-snapshot-{epoch:010d}.bin"))
        out["dropped"] = epoch
    eng.comm.agree(True)
    rec = GraphServer.recover(crashed, mesh=eng.mesh, device="cpu",
                              buckets=BUCKETS)
    out["crash mirrors"] = _mirrors(rec)
    out["crash report"] = (rec.epoch, rec.recovery_report.snapshot_epoch,
                           rec.recovery_report.replayed)
    rec.close()
    try:
        GraphServer.recover(args["stacked_dir"], mesh=eng.mesh, device="cpu")
        out["stacked dir"] = "no error"
    except ValueError as e:
        out["stacked dir"] = str(e)
    return out


def rank_main(argv) -> None:
    rank, world, job, args, out_dir = join_group(argv)
    res = None
    try:
        mesh = make_graph_mesh(world)
        edges = np.load(args["edges"])

        def make_engine():
            return GraphEngine(partition_graph(edges, args["n"], world),
                               device="cpu", mesh=mesh)
        res = serve_job(make_engine, args)
        res.update(crash_job(make_engine(), args))
    finally:
        leave_group(rank, out_dir, res)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def _same(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() \
            and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, (np.ndarray, np.generic)):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape \
            and a.tobytes() == b.tobytes()
    return a == b


def _row(want: dict, rank: int) -> dict:
    """The stacked server's mirrors of part ``rank``."""
    out = {k: v[rank:rank + 1] for k, v in want.items()
           if isinstance(v, np.ndarray)}
    pl = want["planner"]
    out["planner"] = {"occ": {k: v[rank:rank + 1]
                              for k, v in pl["occ"].items()},
                      **{k: pl[k][rank:rank + 1]
                         for k in ("free_out", "free_in", "pos_out",
                                   "pos_in")}}
    out["on device"] = want["on device"]
    return out


def _absent_edge(edges, n, parts) -> list:
    """An edge absent from the graph whose source lies in part 1."""
    have = set(map(tuple, edges.tolist()))
    n_local = partition_graph(edges, n, parts).n_local
    u = n_local + 1
    v = next(v for v in range(n) if (u, v) not in have)
    return [u, v]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """parts -> (rank results, the stacked run, the two directories)."""
    cache = {}

    def get(parts):
        if parts not in cache:
            tmp = tmp_path_factory.mktemp(f"serve{parts}")
            edges, n = oracle.family_edges("urand", N, SEED)
            np.save(tmp / "edges.npy", edges)
            absent = _absent_edge(edges, n, parts)
            stacked = serve_job(
                lambda: GraphEngine(partition_graph(edges, n, parts),
                                    device="cpu"),
                {"absent": absent, "dir": str(tmp / "stacked")})
            ranks = spawn(tmp, parts, "serve", module=__name__,
                          edges=str(tmp / "edges.npy"), n=n, absent=absent,
                          dir=str(tmp / "ranks"),
                          stacked_dir=str(tmp / "stacked"))
            cache[parts] = (ranks, stacked, tmp)
        return cache[parts]
    return get


@pytest.mark.parametrize("parts", PARTS)
def test_served_answers_match_stacked_and_direct(parts, runs):
    ranks, want, _ = runs(parts)
    lead, *rest = ranks
    assert lead["warmed"] == want["warmed"] == 3
    for key in ("served", "seeded"):
        assert _same(lead[key], want[key]), key
        assert [x[0] for x in lead[key]] == ["ok"] * len(lead[key]), key
    # each served answer is a direct run's (a batched launch's with the
    # spec's batch defaults)
    edges, n = oracle.family_edges("urand", N, SEED)
    eng = GraphEngine(partition_graph(edges, n, parts), device="cpu")
    garr = eng.device_graph()
    for _, label, root, rounds, bucket, _, fields in lead["served"]:
        spec = registry.get_spec(label)
        prog = eng.program(spec.algo, spec.variant,
                           **(spec.batch_defaults if bucket else {}))
        *outs, r = prog(garr, *(() if root is None else (root,)))
        assert rounds == r, label
        for name, o, isv in zip(prog.program.output_names, outs,
                                prog.program.output_is_vertex):
            if isv:
                assert _same(fields[name], eng.gather_vertex_field(o)), \
                    (label, root, name)
    for got in rest:
        assert got["served"] == got["seeded"] == [], "a follower answered"
        assert got["warmed"] == 3


@pytest.mark.parametrize("parts", PARTS)
def test_deadline_and_shedding_resolve_on_rank0(parts, runs):
    ranks, want, _ = runs(parts)
    assert ranks[0]["late"] == want["late"] == [(0, "timed_out")]
    assert ranks[0]["shed"] == want["shed"]
    assert sorted(s for _, s in want["shed"]) == ["ok", "ok", "shed"]
    assert all(r["late"] == r["shed"] == [] for r in ranks[1:])


@pytest.mark.parametrize("parts", PARTS)
def test_one_ranks_launch_failure_retries_everywhere(parts, runs):
    ranks, want, _ = runs(parts)
    # stacked, the one process is rank 0: its launch never fails
    assert want["failure counts"] == (0, 1)
    assert [x[0] for x in ranks[0]["failure"]] == ["ok"]
    assert _same(ranks[0]["failure"], want["failure"])
    # the failure on rank 1 failed the launch on every rank, and the
    # leader's retry ran on every rank
    assert ranks[0]["failure counts"] == (1, 2)
    assert all(r["failure counts"][1] == 2 for r in ranks[1:])


@pytest.mark.parametrize("parts", PARTS)
def test_mutations_match_stacked_rows(parts, runs):
    ranks, want, _ = runs(parts)
    assert want["patch"][5] is False and want["rebuild"][5] is True
    for rank, got in enumerate(ranks):
        assert _same(got["sampled"], want["sampled"]), rank
        for step in ("patch", "rebuild"):
            assert got[step] == want[step], (rank, step)
            mirrors = got[f"{step} mirrors"]
            assert mirrors["on device"], (rank, step)
            assert _same(mirrors, _row(want[f"{step} mirrors"], rank)), \
                (rank, step)
    for step in ("patch served", "rebuild served"):
        assert _same(ranks[0][step], want[step]), step
        assert [x[0] for x in want[step]] == ["ok"] * 6


@pytest.mark.parametrize("parts", PARTS)
def test_absent_delete_raises_on_every_rank(parts, runs):
    ranks, want, _ = runs(parts)
    assert "only 0 instance(s) present" in want["absent"]
    for got in ranks:
        assert got["absent"] == want["absent"]
        assert got["absent untouched"] is True


@pytest.mark.parametrize("parts", PARTS)
def test_durable_rank_server_recovers(parts, runs):
    ranks, want, tmp = runs(parts)
    wal = open(wal_path(tmp / "ranks"), "rb").read()
    assert wal == open(wal_path(tmp / "stacked"), "rb").read()
    assert want["durable epoch"] == DURABLE_BATCHES + 1
    assert want["recovered report"] == (DURABLE_BATCHES + 1, 4, 1)
    for rank, got in enumerate(ranks):
        row = _row(want["durable"], rank)
        assert _same(got["durable"], row), rank
        assert _same(got["recovered"], row), rank
        assert got["recovered report"] == want["recovered report"], rank
    assert _same(ranks[0]["durable served"], want["durable served"])
    assert _same(ranks[0]["recovered served"], want["durable served"])
    # one manifest a committed epoch, one file a rank under each
    names = sorted(os.listdir(tmp / "ranks"))
    assert [x for x in names if x.startswith("manifest-")] == [
        "manifest-0000000002.json", "manifest-0000000004.json"]
    assert sum(x.startswith("rank") for x in names) == 2 * parts


@pytest.mark.parametrize("parts", PARTS)
def test_crash_between_rank_writes_recovers_previous_epoch(parts, runs):
    ranks, want, _ = runs(parts)
    assert ranks[0]["dropped"] == 4
    for rank, got in enumerate(ranks):
        # the snapshot of epoch 2, then the WAL's three later batches
        assert got["crash report"] == (DURABLE_BATCHES + 1, 2, 3), rank
        assert _same(got["crash mirrors"], _row(want["durable"], rank))


@pytest.mark.parametrize("parts", PARTS)
def test_directory_kind_mismatch_raises(parts, runs):
    ranks, _, tmp = runs(parts)
    for got in ranks:
        assert "holds one process's snapshots" in got["stacked dir"]
    with pytest.raises(ValueError, match=f"written by {parts} ranks"):
        GraphServer.recover(str(tmp / "ranks"), device="cpu")


# ---------------------------------------------------------------------------
# the launcher under torchrun
# ---------------------------------------------------------------------------

LAUNCH = ["-m", "repro_torch.launch.graph_serve", "--graph", "urand12",
          "--parts", "2", "--device", "cpu", "--duration", "1.5",
          "--rate", "8", "--mix", "bfs:4,cc:1", "--buckets", "1,8",
          "--snapshot-every", "2", "--mutate-every", "0.4",
          "--mutate-size", "16", "--json", "-"]


def _launch(cmd):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def test_launcher_torchrun_serves_then_recovers(tmp_path):
    torchrun = shutil.which("torchrun") or os.path.join(
        os.path.dirname(sys.executable), "torchrun")
    ranks = [torchrun, "--standalone", "--nproc-per-node", "2"]
    d2, d1 = str(tmp_path / "ranks"), str(tmp_path / "one")
    served = _launch(ranks + LAUNCH + ["--wal-dir", d2])
    wal = open(wal_path(d2), "rb").read()
    one = _launch([sys.executable] + LAUNCH + ["--wal-dir", d1])
    assert wal == open(wal_path(d1), "rb").read()
    assert find_manifests(d2) and not find_manifests(d1)
    # the recovered server resumes at the final epoch, then serves the
    # trace again (its mutation batches open further epochs)
    recovered = _launch(ranks + LAUNCH + ["--wal-dir", d2, "--recover"])
    # rank 0 alone prints
    assert served.count("SERVE_JSON ") == recovered.count("SERVE_JSON ") \
        == 1
    epochs = re.findall(r"final epoch (\d+)", served)
    assert epochs and epochs == re.findall(r"final epoch (\d+)", one)
    m = re.search(r"recovered .* epoch (\d+) \(snapshot (\d+)", recovered)
    assert m and m.group(1) == epochs[0], recovered[-2000:]
    assert re.findall(r"final epoch (\d+)", recovered) == [
        str(2 * int(epochs[0]))]
