"""The port's durable serving state (``repro_torch.serve.persist``).

  * Ports of tests/test_persist.py on the port (parts 1, CPU): WAL
    framing, torn tails and bit flips, the commutative edge digest,
    snapshot envelopes, recovery by replay and by skipping, rebuild
    records, WAL-before-apply ordering both ways, corrupt-snapshot
    fallback, the seed store, the metrics fields, the crash-point
    machinery and its table (equal to the JAX package's).
  * The four crash drills: a victim server at parts 2 is killed in a
    subprocess at each crash point (``REPRO_CRASH_POINT``), the
    directory is recovered, and the recovered epoch, edge multiset and
    every probe answer equal an uninterrupted server's at that epoch.
  * Against the JAX package: a durable server over the same stream
    (deletes, inserts, an overflow into the rebuild path, more deletes;
    parts 2, urand and rmat) writes a byte-identical ``wal.log``, with
    equal digests and snapshot epochs; each package reads the other's
    records.  Snapshot files differ by design (the payload pickles each
    package's own classes).
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import oracle
from conftest import REPO, SRC, run_with_devices
from repro_torch.core import GraphEngine, partition_graph
from repro_torch.graphs import urand_edges
from repro_torch.serve import GraphServer, Persistence, Query, make_key
from repro_torch.serve.dynamic.mutation import DynamicGraph
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.persist import CRASH_EXIT_CODE, CRASH_POINTS, \
    crash_points_markdown_table, maybe_crash, reset_counts
from repro_torch.serve.persist.recover import RecoveryFailed, recover_state
from repro_torch.serve.persist.snapshot import SnapshotCorrupt, \
    find_snapshots, load_snapshot, pack_snapshot, unpack_snapshot, \
    write_snapshot
from repro_torch.serve.persist.wal import FILE_MAGIC, WalRecord, \
    WriteAheadLog, edge_digest, encode_record, update_digest

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker: the workers share the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rec(bid, epoch, ins=(), dels=(), rebuild=False):
    return WalRecord(batch_id=bid, epoch=epoch, rebuild=rebuild,
                     digest=bid * 17, count=bid,
                     inserts=np.asarray(ins, np.int64).reshape(-1, 2),
                     deletes=np.asarray(dels, np.int64).reshape(-1, 2))


def _same(a: WalRecord, b: WalRecord) -> bool:
    return (a.batch_id == b.batch_id and a.epoch == b.epoch
            and a.rebuild == b.rebuild and a.digest == b.digest
            and a.count == b.count
            and np.array_equal(a.inserts, b.inserts)
            and np.array_equal(a.deletes, b.deletes))


def _make_server(pdir=None, *, n=256, e=2048, seed=11, snapshot_every=2,
                 retain=2, **kw):
    edges = urand_edges(n, e, seed=seed)
    eng = GraphEngine(partition_graph(edges, n, 1), device="cpu")
    pers = Persistence(dir=str(pdir), snapshot_every=snapshot_every,
                       retain=retain, fsync=False) \
        if pdir is not None else None
    return GraphServer(eng, buckets=(4,), persistence=pers, **kw)


def _recover(pdir, **kw):
    return GraphServer.recover(pdir, device="cpu", **kw)


def _run_rounds(server, rounds, rng):
    """Per round one delete batch, one insert batch (sampled against
    live capacity), one served query."""
    dyn = server.dynamic_graph()
    for _ in range(rounds):
        server.mutate(deletes=dyn.sample_deletable(12, rng))
        server.mutate(inserts=dyn.sample_insertable(12, rng))
        server.serve([Query(make_key("bfs"), 3)])


def _sorted_edges(dyn):
    cur = dyn.current_edges()
    return cur[np.lexsort((cur[:, 1], cur[:, 0]))]


# -- WAL framing -------------------------------------------------------------

def test_wal_roundtrip_and_reopen(tmp_path):
    path = tmp_path / "wal.log"
    wal = WriteAheadLog(path, fsync=False)
    recs = [_rec(1, 1, ins=[[0, 1]]),
            _rec(2, 2, dels=[[3, 4], [5, 6]], rebuild=True),
            _rec(3, 3)]
    for r in recs:
        wal.append(r)
    wal.close()
    wal2 = WriteAheadLog(path, fsync=False)
    assert wal2.n_records == 3
    assert all(_same(a, b) for a, b in zip(recs, wal2.records))
    wal2.close()


def test_wal_torn_tail_truncated(tmp_path):
    path = tmp_path / "wal.log"
    wal = WriteAheadLog(path, fsync=False)
    wal.append(_rec(1, 1, ins=[[0, 1]]))
    wal.append(_rec(2, 2, ins=[[2, 3]]))
    wal.close()
    frame = encode_record(_rec(3, 3, ins=[[4, 5]]))
    with open(path, "ab") as f:
        f.write(frame[:len(frame) // 2])      # the crash mid-append
    wal2 = WriteAheadLog(path, fsync=False)
    assert [r.batch_id for r in wal2.records] == [1, 2]
    wal2.close()
    assert os.path.getsize(path) == len(FILE_MAGIC) + sum(
        len(encode_record(r)) for r in wal2.records)


def test_wal_bitflip_stops_scan(tmp_path):
    path = tmp_path / "wal.log"
    wal = WriteAheadLog(path, fsync=False)
    for i in (1, 2, 3):
        wal.append(_rec(i, i, ins=[[i, i + 1]]))
    wal.close()
    data = bytearray(open(path, "rb").read())
    flip = len(FILE_MAGIC) + len(encode_record(_rec(1, 1,
                                                    ins=[[1, 2]]))) + 12
    data[flip] ^= 0x10                         # inside record 2
    open(path, "wb").write(bytes(data))
    wal2 = WriteAheadLog(path, fsync=False)
    assert [r.batch_id for r in wal2.records] == [1]
    wal2.close()


def test_wal_truncate_to_drops_appended_record(tmp_path):
    wal = WriteAheadLog(tmp_path / "wal.log", fsync=False)
    wal.append(_rec(1, 1))
    off = wal.append(_rec(2, 2, ins=[[7, 8]]))
    wal.truncate_to(off)
    assert [r.batch_id for r in wal.records] == [1]
    wal.append(_rec(2, 2, ins=[[9, 9]]))       # the log stays appendable
    wal.close()
    wal2 = WriteAheadLog(tmp_path / "wal.log", fsync=False)
    assert [r.batch_id for r in wal2.records] == [1, 2]
    assert wal2.records[1].inserts[0, 0] == 9
    wal2.close()


def test_edge_digest_commutative_update():
    rng = np.random.default_rng(0)
    edges = rng.integers(0, 100, size=(50, 2))
    d, c = edge_digest(edges)
    assert (d, c) == edge_digest(rng.permutation(edges, axis=0))
    ins, dels = rng.integers(0, 100, size=(7, 2)), edges[:5]
    after = np.concatenate([edges[5:], ins])
    assert update_digest(d, c, ins, dels) == edge_digest(after)
    assert edge_digest(np.concatenate([edges, edges[:1]])) != (d, c)


def test_wal_and_digest_match_reference_encoding():
    """Records, framing and digests are the JAX package's, byte for
    byte, for the same inputs."""
    from repro.serve.persist import wal as ref_wal
    rng = np.random.default_rng(1)
    edges = rng.integers(0, 1 << 20, size=(300, 2))
    assert edge_digest(edges) == ref_wal.edge_digest(edges)
    assert update_digest(5, 9, edges[:7], edges[7:9]) == \
        ref_wal.update_digest(5, 9, edges[:7], edges[7:9])
    for rec in (_rec(1, 1, ins=edges[:5]),
                _rec(7, 9, dels=edges[5:8], rebuild=True), _rec(3, 3)):
        ref = ref_wal.WalRecord(rec.batch_id, rec.epoch, rec.rebuild,
                                rec.digest, rec.count, rec.inserts,
                                rec.deletes)
        assert encode_record(rec) == ref_wal.encode_record(ref)


# -- snapshots ---------------------------------------------------------------

def test_snapshot_envelope_detects_any_flip(tmp_path):
    from repro.serve.persist import snapshot as ref_snapshot
    state = {"x": np.arange(5), "epoch": 7}
    data = pack_snapshot(7, state)
    assert data == ref_snapshot.pack_snapshot(7, state)
    epoch, loaded = unpack_snapshot(data)
    assert epoch == 7 and np.array_equal(loaded["x"], state["x"])
    for pos in (2, 9, len(data) - 3):          # magic, header, payload
        bad = bytearray(data)
        bad[pos] ^= 1
        with pytest.raises(SnapshotCorrupt):
            unpack_snapshot(bytes(bad))
    with pytest.raises(SnapshotCorrupt):
        unpack_snapshot(data[:-1])             # truncation

    write_snapshot(tmp_path, 3, state, fsync=False)
    write_snapshot(tmp_path, 9, state, fsync=False)
    assert open(tmp_path / "snapshot-0000000009.bin", "rb").read() == \
        pack_snapshot(9, state)
    (tmp_path / ".snapshot-0000000011.tmp").write_bytes(b"torn")
    assert [e for e, _ in find_snapshots(tmp_path)] == [9, 3]
    assert load_snapshot(find_snapshots(tmp_path)[0][1])[0] == 9


def test_persistence_refuses_resumable_dir(tmp_path):
    _make_server(tmp_path)
    with pytest.raises(ValueError, match="already holds durable state"):
        _make_server(tmp_path)


def test_recover_empty_dir_raises(tmp_path):
    with pytest.raises(RecoveryFailed, match="no snapshots"):
        recover_state(str(tmp_path), device="cpu")


# -- recovery semantics ------------------------------------------------------

def test_recover_replay_bit_identical(tmp_path):
    # snapshot_every huge => recovery replays EVERY batch from the base
    # snapshot, the pure-WAL path
    server = _make_server(tmp_path, snapshot_every=100)
    _run_rounds(server, 2, np.random.default_rng(3))
    (res,) = server.serve([Query(make_key("bfs"), 3)])
    ref_edges = _sorted_edges(server.dynamic)
    logged = {r.epoch for r in server.durability.wal.records}
    assert {m["epoch"] for m in server.mutation_log} <= logged

    rec = _recover(tmp_path, buckets=(4,))
    rep = rec.recovery_report
    assert (rep.snapshot_epoch, rep.epoch, rep.replayed, rep.skipped) \
        == (0, 4, 4, 0)
    assert rec.epoch == server.epoch == 4
    assert rec.engine.device.type == "cpu"
    np.testing.assert_array_equal(ref_edges, _sorted_edges(rec.dynamic))
    (res2,) = rec.serve([Query(make_key("bfs"), 3)])
    np.testing.assert_array_equal(res["parents"], res2["parents"])
    assert res2.rounds == res.rounds
    assert rec.metrics.recoveries == 1


def test_replay_of_snapshotted_batch_is_noop(tmp_path):
    server = _make_server(tmp_path, snapshot_every=1)
    rng = np.random.default_rng(5)
    _run_rounds(server, 2, rng)
    ref_edges = _sorted_edges(server.dynamic)

    rec = _recover(tmp_path)
    rep = rec.recovery_report
    assert (rep.replayed, rep.skipped, rep.epoch) == (0, 4, 4)
    np.testing.assert_array_equal(ref_edges, _sorted_edges(rec.dynamic))
    dyn = rec.dynamic_graph()
    rec.mutate(deletes=dyn.sample_deletable(3, rng))
    assert rec.epoch == 5 and rec.durability.batch_id == 5
    rec2 = _recover(tmp_path)
    assert rec2.epoch == 5
    np.testing.assert_array_equal(_sorted_edges(rec.dynamic),
                                  _sorted_edges(rec2.dynamic))


def test_rebuild_record_replays_rebuild_path(tmp_path):
    server = _make_server(tmp_path, snapshot_every=100)
    rng = np.random.default_rng(7)
    dyn = server.dynamic_graph()
    server.mutate(deletes=dyn.sample_deletable(8, rng))
    hot = np.tile([[0, 1]], (len(dyn._free_out[0]) + 1, 1))
    stats = server.mutate(inserts=hot)
    assert stats.rebuild
    assert server.durability.wal.records[-1].rebuild
    server.mutate(deletes=dyn.sample_deletable(5, rng))
    ref_edges = _sorted_edges(dyn)

    rec = _recover(tmp_path)
    rep = rec.recovery_report
    assert (rep.replayed, rep.rebuilds, rep.epoch) == (3, 1, 3)
    np.testing.assert_array_equal(ref_edges, _sorted_edges(rec.dynamic))


def test_wal_append_failure_blocks_apply(tmp_path, monkeypatch):
    server = _make_server(tmp_path)
    dyn = server.dynamic_graph()
    before = _sorted_edges(dyn)
    monkeypatch.setattr(WriteAheadLog, "append",
                        lambda self, rec: (_ for _ in ()).throw(
                            OSError("disk full")))
    with pytest.raises(OSError, match="disk full"):
        server.mutate(deletes=dyn.sample_deletable(
            4, np.random.default_rng(9)))
    assert server.epoch == 0 and dyn.epoch == 0
    np.testing.assert_array_equal(before, _sorted_edges(dyn))
    monkeypatch.undo()
    assert server.durability.wal.n_records == 0


def test_apply_failure_truncates_orphan_record(tmp_path, monkeypatch):
    server = _make_server(tmp_path)
    rng = np.random.default_rng(13)
    dyn = server.dynamic_graph()
    before = _sorted_edges(dyn)
    monkeypatch.setattr(DynamicGraph, "_apply_patches",
                        lambda self, touched: (_ for _ in ()).throw(
                            RuntimeError("device fell over")))
    with pytest.raises(RuntimeError, match="device fell over"):
        server.mutate(deletes=dyn.sample_deletable(4, rng))
    monkeypatch.undo()
    assert server.durability.wal.n_records == 0
    assert server.epoch == 0
    np.testing.assert_array_equal(before, _sorted_edges(dyn))
    server.mutate(deletes=dyn.sample_deletable(4, rng))
    assert server.durability.wal.n_records == 1
    rec = _recover(tmp_path)
    assert rec.epoch == 1
    np.testing.assert_array_equal(_sorted_edges(dyn),
                                  _sorted_edges(rec.dynamic))


def test_snapshot_corruption_falls_back_to_previous(tmp_path):
    server = _make_server(tmp_path, snapshot_every=1, retain=3)
    _run_rounds(server, 2, np.random.default_rng(17))   # snapshots 0..4
    ref_edges = _sorted_edges(server.dynamic)
    newest = find_snapshots(tmp_path)[0][1]
    data = bytearray(open(newest, "rb").read())
    data[len(data) // 2] ^= 1                  # flip a payload bit
    open(newest, "wb").write(bytes(data))

    rec = _recover(tmp_path)
    rep = rec.recovery_report
    assert rep.snapshots_tried == 2            # newest condemned by CRC
    assert (rep.snapshot_epoch, rep.replayed, rep.epoch) == (3, 1, 4)
    np.testing.assert_array_equal(ref_edges, _sorted_edges(rec.dynamic))


def test_seed_store_roundtrip(tmp_path):
    server = _make_server(tmp_path)
    server.serve([Query(make_key("pagerank"), None)])   # harvests the seed
    assert ("pagerank", "rank") in server._seeds
    server.durability.snapshot_now(server)
    rec = _recover(tmp_path)
    assert set(rec._seeds) == set(server._seeds)
    ep0, arr0 = server._seeds[("pagerank", "rank")]
    ep1, arr1 = rec._seeds[("pagerank", "rank")]
    assert ep0 == ep1 and isinstance(arr1, np.ndarray)
    np.testing.assert_array_equal(arr0, arr1)


def test_snapshot_holds_touched_keys_only(tmp_path):
    """The planner state a snapshot carries lists the position lists of
    the keys mutations touched, not every edge's."""
    server = _make_server(tmp_path, snapshot_every=1)
    dyn = server.dynamic_graph()
    dels = dyn.sample_deletable(6, np.random.default_rng(2))
    server.mutate(deletes=dels)
    _, state = load_snapshot(find_snapshots(tmp_path)[0][1])
    keys = {(u, v) for part in state["planner"]["pos_out"]
            for u, v, _ in part}
    assert keys == set(map(tuple, dels.tolist()))


# -- observability / machinery ----------------------------------------------

def test_metrics_snapshot_fields(tmp_path):
    snap = ServeMetrics().snapshot()
    assert (snap["epoch"], snap["recoveries"], snap["wal_records"]) \
        == (0, 0, 0)
    assert set(snap) == {"window_s", "epoch", "recoveries", "wal_records",
                         "counts", "rows"}
    server = _make_server(tmp_path)
    dyn = server.dynamic_graph()
    server.mutate(deletes=dyn.sample_deletable(2, np.random.default_rng(1)))
    snap = server.metrics.snapshot()
    assert snap["epoch"] == 1 and snap["wal_records"] == 1
    snap = _recover(tmp_path).metrics.snapshot()
    assert snap["recoveries"] == 1 and snap["epoch"] == 1 \
        and snap["wal_records"] == 1


def test_crash_point_machinery(monkeypatch):
    fired = []
    monkeypatch.setattr(os, "_exit",
                        lambda code: fired.append(code) or (_ for _ in ())
                        .throw(SystemExit(code)))
    monkeypatch.setenv("REPRO_CRASH_POINT", "between-batches:2")
    reset_counts()
    maybe_crash("between-batches")             # occurrence 1: survives
    maybe_crash("after-wal-append")            # other points don't count
    assert not fired
    with pytest.raises(SystemExit):
        maybe_crash("between-batches")         # occurrence 2: dies
    assert fired == [CRASH_EXIT_CODE] == [113]
    reset_counts()
    with pytest.raises(ValueError, match="unknown crash point"):
        maybe_crash("not-a-point")


def test_crash_point_table_matches_reference():
    from repro.serve.persist import crash_points_markdown_table as ref_table
    table = crash_points_markdown_table()
    assert table == ref_table()
    assert table in open(os.path.join(REPO, "docs", "API.md")).read()


# -- the kill drills ---------------------------------------------------------

_DRILL_SETUP = r"""
import hashlib, json, os
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.core import GraphEngine, partition_graph
from repro_torch.graphs import urand_edges
from repro_torch.serve import GraphServer, Persistence, Query, make_key

N, PARTS, E, ROUNDS = 512, 2, 4096, 3
PROBES = (("bfs", 3), ("pagerank", None), ("cc", None))

def hsh(a):
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(a)).tobytes()).hexdigest()

def probe(server):
    out = {}
    for algo, root in PROBES:
        (res,) = server.serve([Query(make_key(algo), root)])
        out[algo] = {"rounds": int(res.rounds),
                     "fields": {k: hsh(v)
                                for k, v in sorted(res.fields.items())}}
    return out

def build(persistence=None):
    edges = urand_edges(N, E, seed=11)
    eng = GraphEngine(partition_graph(edges, N, PARTS), device="cpu")
    return GraphServer(eng, buckets=(4,), persistence=persistence)

def edges_hash(dyn):
    cur = dyn.current_edges()
    return hsh(cur[np.lexsort((cur[:, 1], cur[:, 0]))])
"""

_VICTIM_CODE = _DRILL_SETUP + r"""
server = build(Persistence(dir=os.environ["DRILL_DIR"], snapshot_every=2))
rng = np.random.default_rng(3)
dyn = server.dynamic_graph()
for k in range(ROUNDS):
    server.mutate(deletes=dyn.sample_deletable(12, rng))
    server.mutate(inserts=dyn.sample_insertable(12, rng))
    server.serve([Query(make_key("bfs"), 3)])
print("VICTIM-SURVIVED")
"""

_REFERENCE_CODE = _DRILL_SETUP + r"""
server = build()
rng = np.random.default_rng(3)
dyn = server.dynamic_graph()
report = {}
for k in range(ROUNDS):
    server.mutate(deletes=dyn.sample_deletable(12, rng))
    report[str(server.epoch)] = {"edges": edges_hash(dyn),
                                 "answers": probe(server)}
    server.mutate(inserts=dyn.sample_insertable(12, rng))
    report[str(server.epoch)] = {"edges": edges_hash(dyn),
                                 "answers": probe(server)}
    server.serve([Query(make_key("bfs"), 3)])
print("REF " + json.dumps(report))
"""

_RECOVER_CODE = _DRILL_SETUP + r"""
server = GraphServer.recover(os.environ["DRILL_DIR"], device="cpu",
                             buckets=(4,))
rep = server.recovery_report
print("RECOVERED " + json.dumps({
    "epoch": server.epoch, "snapshot_epoch": rep.snapshot_epoch,
    "replayed": rep.replayed, "skipped": rep.skipped,
    "recoveries": server.metrics.recoveries,
    "wal_records": server.metrics.wal_records,
    "edges": edges_hash(server.dynamic_graph()),
    "answers": probe(server)}))
"""

# crash spec -> what recovery must land on.  The victim trace is 6
# mutate() calls (epochs 1..6) with snapshots at epochs 0/2/4/6; the
# occurrence counter picks the exact protocol instruction to die at.
_DRILLS = [
    ("after-wal-append:5",
     dict(epoch=5, snapshot_epoch=4, replayed=1, skipped=4)),
    ("between-batches:5",
     dict(epoch=4, snapshot_epoch=4, replayed=0, skipped=4)),
    ("mid-snapshot-temp-write:3",
     dict(epoch=4, snapshot_epoch=2, replayed=2, skipped=2)),
    ("post-rename:3",
     dict(epoch=4, snapshot_epoch=4, replayed=0, skipped=4)),
]


def _run_drill_proc(code, *, expect_rc=0, extra_env=None, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.update(extra_env or {})
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == expect_rc, (
        f"rc={r.returncode} (expected {expect_rc})\n"
        f"STDOUT:{r.stdout[-3000:]}\nSTDERR:{r.stderr[-3000:]}")
    return r.stdout


def _tagged(out: str, tag: str) -> dict:
    return next(json.loads(line[len(tag) + 1:])
                for line in out.splitlines() if line.startswith(tag + " "))


@pytest.fixture(scope="module")
def reference_report():
    """One uninterrupted run of the drill trace, probed at every epoch:
    the answers the recovered servers must match bit for bit."""
    return _tagged(_run_drill_proc(_REFERENCE_CODE), "REF")


@pytest.mark.durability
@pytest.mark.parametrize("crash_spec,expect", _DRILLS,
                         ids=[d[0] for d in _DRILLS])
def test_crash_drill(crash_spec, expect, reference_report, tmp_path):
    pdir = str(tmp_path / "store")
    out = _run_drill_proc(_VICTIM_CODE, expect_rc=CRASH_EXIT_CODE,
                          extra_env={"REPRO_CRASH_POINT": crash_spec,
                                     "DRILL_DIR": pdir})
    assert "VICTIM-SURVIVED" not in out, \
        f"{crash_spec}: the crash point never fired"
    rec = _tagged(_run_drill_proc(_RECOVER_CODE,
                                  extra_env={"DRILL_DIR": pdir}),
                  "RECOVERED")
    for k in ("epoch", "snapshot_epoch", "replayed", "skipped"):
        assert rec[k] == expect[k], \
            f"{crash_spec}: {k}={rec[k]}, expected {expect[k]}"
    assert rec["recoveries"] == 1
    ref = reference_report[str(expect["epoch"])]
    assert rec["edges"] == ref["edges"], \
        f"{crash_spec}: recovered edge multiset differs from reference"
    assert rec["answers"] == ref["answers"], \
        f"{crash_spec}: recovered answers not bit-identical to reference"


def test_drill_crash_points_are_exhaustive():
    drilled = {spec.split(":")[0] for spec, _ in _DRILLS}
    assert drilled == set(CRASH_POINTS)


# -- the WAL against the JAX package's ----------------------------------------

# both packages' durable servers run this stream: each step samples from
# the planner's state after the previous one; "overflow" takes the
# rebuild path (logged as a rebuild record)
_WAL_STREAM = '''
def wal_stream(server, rng):
    dyn = server.dynamic_graph()
    server.mutate(deletes=dyn.sample_deletable(16, rng))
    server.mutate(inserts=dyn.sample_insertable(10, rng))
    u, v = (int(x) for x in dyn.current_edges()[0])
    k = 1
    while not dyn.plan(np.tile([[u, v]], (k, 1)))[2]:
        k += 1
    server.mutate(inserts=np.tile([[u, v]], (k, 1)))
    dyn = server.dynamic_graph()
    server.mutate(deletes=dyn.sample_deletable(9, rng),
                  inserts=dyn.sample_insertable(7, rng))
    server.mutate(deletes=dyn.sample_deletable(5, rng))
'''
WAL_PARTS, WAL_SEED = 2, 21

_WAL_REFERENCE = """
import json, os, sys
sys.path.insert(0, {tests_dir!r})
import numpy as np
import oracle
from repro.core import GraphEngine, partition_graph
from repro.launch.mesh import make_graph_mesh
from repro.serve import GraphServer, Persistence
from repro.serve.persist.snapshot import find_snapshots
from repro.serve.persist.wal import edge_digest
{stream}
edges, n = oracle.family_edges({family!r}, 384, {seed})
eng = GraphEngine(partition_graph(edges, n, {parts}),
                  make_graph_mesh({parts}))
server = GraphServer(eng, buckets=(4,), persistence=Persistence(
    dir={out!r}, snapshot_every=2, fsync=False))
wal_stream(server, np.random.default_rng({seed}))
dur = server.durability
print("REF " + json.dumps({{
    "digest": dur.digest, "count": dur.count, "batch_id": dur.batch_id,
    "edges": list(edge_digest(server.dynamic.current_edges())),
    "epoch": server.epoch,
    "rebuild": [m["rebuild"] for m in server.mutation_log],
    "snapshots": [e for e, _ in find_snapshots({out!r})]}}))
"""

_wal_ns: dict = {"np": np}
exec(_WAL_STREAM, _wal_ns)


@pytest.mark.parametrize("family", ("urand", "rmat"))
def test_wal_bytes_match_reference(family, tmp_path):
    """Same stream, same graph: the port's wal.log is byte-identical to
    the JAX package's, its digests and snapshot epochs equal, and each
    package decodes the other's records."""
    from repro.serve.persist.wal import WriteAheadLog as RefWal
    ref_dir, dir_ = str(tmp_path / "ref"), str(tmp_path / "port")
    ref = _tagged(run_with_devices(_WAL_REFERENCE.format(
        tests_dir=TESTS_DIR, stream=_WAL_STREAM, family=family,
        seed=WAL_SEED, parts=WAL_PARTS, out=ref_dir), devices=WAL_PARTS),
        "REF")
    edges, n = oracle.family_edges(family, 384, WAL_SEED)
    eng = GraphEngine(partition_graph(edges, n, WAL_PARTS), device="cpu")
    server = GraphServer(eng, buckets=(4,), persistence=Persistence(
        dir=dir_, snapshot_every=2, fsync=False))
    _wal_ns["wal_stream"](server, np.random.default_rng(WAL_SEED))
    dur = server.durability
    assert [m["rebuild"] for m in server.mutation_log] == ref["rebuild"] \
        == [False, False, True, False, False]
    assert (dur.digest, dur.count, dur.batch_id, server.epoch) == \
        (ref["digest"], ref["count"], ref["batch_id"], ref["epoch"])
    assert list(edge_digest(server.dynamic.current_edges())) == ref["edges"]
    assert [e for e, _ in find_snapshots(dir_)] == ref["snapshots"]
    got = open(os.path.join(dir_, "wal.log"), "rb").read()
    want = open(os.path.join(ref_dir, "wal.log"), "rb").read()
    assert got == want, "wal.log bytes differ from the JAX package's"
    ref_wal, wal = RefWal(os.path.join(dir_, "wal.log"), fsync=False), \
        WriteAheadLog(os.path.join(ref_dir, "wal.log"), fsync=False)
    assert ref_wal.n_records == wal.n_records == 5
    assert all(_same(a, b) for a, b in zip(wal.records, ref_wal.records))
    ref_wal.close()
    wal.close()
    # the port's own snapshot recovers to the same state
    rec = _recover(dir_, buckets=(4,))
    assert rec.epoch == 5 and list(edge_digest(
        rec.dynamic.current_edges())) == ref["edges"]
    assert hashlib.sha256(_sorted_edges(rec.dynamic).tobytes()).digest() \
        == hashlib.sha256(_sorted_edges(server.dynamic).tobytes()).digest()
