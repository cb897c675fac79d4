"""``DistComm``: the graph engine's exchanges over P ranks of
``torch.distributed`` (gloo, CPU tensors), one part a rank, against
``StackedComm``'s P parts stacked in one process on the same inputs.

  * every primitive at P = 2 and 4 on seeded payloads: float32 and bf16
    sums, int32 sums that wrap, min, packed OR, broadcast, the ``shift``
    ring, ``own_slice``, ``gid``, ``psum_scalar`` and the other control
    reductions, each ``*_start`` / ``*_finish`` pair, a corrupt fault
    on bitmap words (it writes -1), and the ``wire`` / ``taps`` tallies:
    each rank's rows equal ``StackedComm``'s rows of its part, bit for
    bit; ``make_graph_mesh`` raises unless P is the world size, an
    engine given no mesh stays stacked while a process group is up, and
    ``CheckpointRunner`` and ``GraphServer`` construct over a
    ``DistComm`` engine (neither refuses it); ``part_sums`` gives a part's bits whatever rows it is
    reduced beside;
  * all sixteen registered programs at parts 2 and 4 on urand,
    smallworld and rmat (N=384, seed 5, root 3, the conformance params;
    the incremental ones from their cold seeds): gathered outputs,
    rounds and per-(phase, op) wire bit-equal to ``StackedComm``'s at
    the same parts (both comms add the rmat rows past 32 slots in the
    same order).  On urand also the guarded builds (clean, and
    ``drop@r1p0 corrupt@r2p1`` on bfs/fast and pagerank/bsp: verdicts
    and outputs), the telemetry builds (rank 0's series and wire),
    ``batch=4`` against the single-source runs, ``static_iters`` and
    ``exec_mode``;
  * urand at parts 4 against the JAX package's programs directly (one
    reference subprocess): rounds and integer outputs equal, float
    outputs within the stated tolerances.

One spawn of P rank processes a family and parts count (a file
rendezvous, one torch thread a rank); a rank that fails fails the
test."""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import oracle
from conftest import SRC, run_with_devices
from repro_torch.core import CheckpointRunner, DistComm, FaultSchedule, \
    GraphEngine, StackedComm, faults, incremental, partition_graph, \
    registry
from repro_torch.core.partitioned import GraphMesh, part_sums
from repro_torch.launch.mesh import make_graph_mesh
from repro_torch.obs.telemetry import tally_delta
from repro_torch.serve import GraphServer

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
N, SEED, ROOT = 384, 5, 3
FAMILIES = ("urand", "smallworld", "rmat")
PARTS = (2, 4)
CHAOS = "drop@r1p0 corrupt@r2p1"
CHAOS_PROGRAMS = (("bfs", "fast"), ("pagerank", "bsp"))
STATIC = (("bfs", "fast", 6), ("pagerank", "bsp", 6), ("cc", "async", 6))
BATCH_ROOTS = (3, 0, 7, 3)
SPAWN_TIMEOUT_S = 180
# float outputs against the JAX package (the port's sums run in torch's
# order): pagerank's ranks as tests/test_torch_programs.py holds them,
# betweenness's dependencies and path counts as tests/oracle.py does
REF_RTOL = {"rank": 1e-5, "bc": 1e-4, "sigma": 1e-6}


def _builds():
    """label -> (algo, variant, params): the sixteen programs with their
    conformance params."""
    return {f"{a}/{v}": (a, v, oracle.CONFORMANCE_PARAMS.get((a, v), {}))
            for a, v in registry.available()}


BUILDS = _builds()


# ---------------------------------------------------------------------------
# what both comms run: the same code on an engine over either mesh
# ---------------------------------------------------------------------------

def _args(eng, garr, spec, root=ROOT):
    if any(k != "scalar" for k in spec.input_kinds):
        (seed_arr,) = incremental.cold_seed(spec, eng.g)
        return (garr, eng.scatter_vertex_field(
            seed_arr, incremental.KIND_DTYPES[spec.input_kinds[0]]))
    return (garr,) + (root,) * len(spec.inputs)


def _fields(eng, prog, outs) -> dict:
    p = prog.program
    return {nm: (eng.gather_vertex_field(o) if isv else o)
            for nm, o, isv in zip(p.output_names, outs, p.output_is_vertex)}


def _run(eng, garr, prog, args) -> dict:
    before = eng.comm.tally()
    *outs, rounds = prog(*args)
    return {"fields": _fields(eng, prog, outs), "rounds": rounds,
            "wire": tally_delta(before, eng.comm.tally())}


def run_programs(eng, extras: bool) -> dict:
    """Every registered program once (and with ``extras`` the guarded,
    chaotic, telemetry, batched, static and exec-mode builds): outputs
    gathered to every part, rounds, and the wire each run tallied."""
    garr = eng.device_graph()
    out = {}
    for label, (algo, variant, params) in BUILDS.items():
        spec = registry.get_spec(algo, variant)
        out[label] = _run(eng, garr, eng.program(algo, variant, **params),
                          _args(eng, garr, spec))
    if not extras:
        return out
    for label, (algo, variant, params) in BUILDS.items():
        spec = registry.get_spec(algo, variant)
        prog = eng.program(algo, variant, guard=True, **params)
        *outs, rounds, ok = prog(*_args(eng, garr, spec))
        out[f"guard {label}"] = {"fields": _fields(eng, prog, outs),
                                 "rounds": rounds, "ok": ok}
        prog = eng.program(algo, variant, telemetry=True, **params)
        *outs, rounds, series = prog(*_args(eng, garr, spec))
        tel = prog.run_telemetry(series)
        out[f"telemetry {label}"] = {
            "fields": _fields(eng, prog, outs), "rounds": rounds,
            "rows": tel.series.rows, "wire": tel.wire}
    for algo, variant in CHAOS_PROGRAMS:
        params = BUILDS[f"{algo}/{variant}"][2]
        prog = eng.program(algo, variant, guard=True, faults=CHAOS,
                           **params)
        *outs, rounds, ok = prog(*_args(eng, garr,
                                        registry.get_spec(algo, variant)))
        out[f"chaos {algo}/{variant}"] = {
            "fields": _fields(eng, prog, outs), "rounds": rounds, "ok": ok}
    for label, (algo, variant, params) in BUILDS.items():
        spec = registry.get_spec(algo, variant)
        if not spec.inputs or any(k != "scalar" for k in spec.input_kinds):
            continue
        prog = eng.program(algo, variant, batch=len(BATCH_ROOTS), **params)
        *outs, rounds = prog(garr, list(BATCH_ROOTS))
        p = prog.program
        out[f"batch {label}"] = {"rounds": rounds, "fields": {
            nm: (eng.gather_batched_vertex_field(o) if isv else o)
            for nm, o, isv in zip(p.output_names, outs,
                                  p.output_is_vertex)}}
    for algo, variant, iters in STATIC:
        params = BUILDS[f"{algo}/{variant}"][2]
        prog = eng.program(algo, variant, static_iters=iters, **params)
        out[f"static {algo}/{variant}"] = _run(
            eng, garr, prog, _args(eng, garr,
                                   registry.get_spec(algo, variant)))
    prog = eng.program("sssp", exec_mode="async")
    out["exec_mode sssp async"] = _run(eng, garr, prog, (garr, ROOT))
    return out


def _payloads(parts: int) -> dict:
    rng = np.random.default_rng(11)
    n_local = 64
    n = parts * n_local
    return {
        "n_local": n_local,
        "f32": rng.standard_normal((parts, n)).astype(np.float32),
        "i32": rng.integers(-2 ** 31, 2 ** 31, (parts, n)).astype(np.int32),
        "mask": rng.random((parts, n)) < 0.3,
        "loc": rng.standard_normal((parts, n_local)).astype(np.float32),
        "words": rng.integers(-2 ** 31, 2 ** 31, (parts, 3, 5))
        .astype(np.int32),
        "scal": rng.standard_normal(parts).astype(np.float32),
        "cnt": rng.integers(0, 100, parts).astype(np.int32),
    }


def run_primitives(comm) -> dict:
    """Each primitive on the seeded payloads, as this comm's rows: every
    payload is ``(P, ...)``, of which the comm takes the parts it holds."""
    pl = _payloads(comm.parts)
    lo, hi = comm.first_part, comm.first_part + comm.local_parts

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(pl[a][lo:hi]))

    n_local = pl["n_local"]
    f32, i32, mask = t("f32"), t("i32"), t("mask")
    words = t("words")
    flat_words = words.reshape(words.shape[0], -1)
    out = {
        "sum f32": comm.exchange_sum(f32),
        "sum bf16": comm.exchange_sum(f32.to(torch.bfloat16)),
        "sum i32": comm.exchange_sum(i32),
        "min i32": comm.exchange_min_int(i32),
        "min f32": comm.exchange_min_int(f32),
        "or": comm.exchange_or(mask),
        "bcast": comm.broadcast_global(t("loc")),
        "bcast words": comm.broadcast_global(flat_words, words=True),
        "shift": comm.shift(words, words=True),
        "own_slice": comm.own_slice(f32),
        "gid": comm.gid(n_local),
        "psum f32": comm.psum_scalar(t("scal")),
        "psum i32": comm.psum_scalar(t("cnt")),
        "sum_parts": comm.sum_parts(t("scal")),
        "max_scalar": comm.max_scalar(t("cnt")),
        "all_parts true": comm.all_parts(t("cnt") >= 0),
        "all_parts false": comm.all_parts(
            t("cnt") != int(pl["cnt"][comm.parts - 1])),
        "min start/finish": comm.exchange_min_finish(
            comm.exchange_min_start(f32, t("scal"))),
        "min start/finish int": comm.exchange_min_finish(
            comm.exchange_min_start(i32, 1)),
        "sum start/finish": comm.exchange_sum_finish(
            comm.exchange_sum_start(f32, t("scal"))),
        "sum start/finish bf16": comm.exchange_sum_finish(
            comm.exchange_sum_start(f32.to(torch.bfloat16), 1.0)),
        "or start/finish": comm.exchange_or_finish(
            comm.exchange_or_start(mask, t("cnt")), n_local),
        "gather_parts": comm.gather_parts(f32),
    }
    with faults.active(FaultSchedule.parse(
            "corrupt@r0p1 drop@r0p0:sum seed=3"), detect=True):
        faults.set_round(0)
        out["chaos or"] = comm.exchange_or(mask)
        out["chaos bcast words"] = comm.broadcast_global(flat_words,
                                                         words=True)
        out["chaos sum"] = comm.exchange_sum(f32)
        out["chaos min start/finish"] = comm.exchange_min_finish(
            comm.exchange_min_start(i32, t("cnt")))
        out["chaos stamp"] = faults.stamp_violation()
    out["tally"] = comm.tally()
    return out


# ---------------------------------------------------------------------------
# the rank processes
# ---------------------------------------------------------------------------

def _host(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    if isinstance(x, tuple):
        return tuple(_host(v) for v in x)
    return x


def _refusals(eng) -> list:
    """What a DistComm engine is refused, by the exception's text, or
    the class of what it built."""
    said = []
    for make in (lambda: CheckpointRunner(eng, "bfs", "fast"),
                 lambda: GraphServer(eng)):
        try:
            said.append(type(make()).__name__)
        except ValueError as e:
            said.append(str(e))
    return said


def rank_main(argv) -> None:
    """One rank: ``rank world rendezvous job args-json out-dir``."""
    import torch.distributed as dist
    rank, world, rdzv, job, args, out_dir = argv
    rank, world, args = int(rank), int(world), json.loads(args)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                            rank=rank, world_size=world)
    try:
        if job == "primitives":
            comm = DistComm(world, "cpu")
            res = {k: _host(v) for k, v in run_primitives(comm).items()}
            try:
                make_graph_mesh(world + 1)
                res["mesh raises"] = False
            except ValueError:
                res["mesh raises"] = True
            mesh = make_graph_mesh(world)
            res["mesh"] = mesh
            edges = np.load(args["edges"])
            g = partition_graph(edges, args["n"], world)
            # the group is up, but an engine given no mesh is stacked
            res["default comm"] = repr(GraphEngine(g, device="cpu").comm)
            eng = GraphEngine(g, device="cpu", mesh=mesh)
            res["refusals"] = _refusals(eng)
            res["held"] = (eng.g.part_index, eng.g.out_degree.shape[0],
                           sorted(k for k, v in eng.device_graph().items()
                                  if v.shape[0] != 1))
        else:
            edges = np.load(args["edges"])
            eng = GraphEngine(partition_graph(edges, args["n"], world),
                              device="cpu", mesh=make_graph_mesh(world))
            res = run_programs(eng, args["extras"])
            res["comm"] = repr(eng.comm)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


_WORKER = ("import sys; sys.path[:0] = [{tests!r}, {src!r}]; "
           "import test_torch_distcomm as t; t.rank_main(sys.argv[1:])")


def spawn(tmp_path, world: int, job: str, **args) -> list:
    """Run ``job`` on ``world`` rank processes; every rank's result, in
    rank order.  A rank that exits non-zero, or outlives the timeout,
    fails the spawn."""
    out_dir = tmp_path / f"{job}-{world}-{len(os.listdir(tmp_path))}"
    out_dir.mkdir()
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    code = _WORKER.format(tests=TESTS_DIR, src=SRC)
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


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def _same(a, b) -> bool:
    """Equal bits (and dtype) for arrays, equal values otherwise."""
    if isinstance(a, tuple):
        return isinstance(b, tuple) and len(a) == len(b) \
            and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, (np.ndarray, np.generic)) or isinstance(
            b, (np.ndarray, np.generic)):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape \
            and a.tobytes() == b.tobytes()
    if isinstance(a, float) and isinstance(b, float):
        return np.float64(a).tobytes() == np.float64(b).tobytes()
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() \
            and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def _rows(x, rank):
    """StackedComm's rows of part ``rank``."""
    if isinstance(x, tuple):
        return tuple(_rows(v, rank) for v in x)
    if isinstance(x, np.ndarray) and x.ndim:
        return x[rank:rank + 1]
    return x


def _stacked(edges, n, parts, extras):
    eng = GraphEngine(partition_graph(edges, n, parts), device="cpu")
    return run_programs(eng, extras)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(family, parts) -> (rank results, StackedComm's results, graph),
    each spawned once for the module."""
    cache = {}

    def get(family, parts):
        if (family, parts) not in cache:
            tmp = tmp_path_factory.mktemp(f"{family}{parts}")
            edges, n = oracle.family_edges(family, N, SEED)
            np.save(tmp / "edges.npy", edges)
            extras = family == "urand"
            ranks = spawn(tmp, parts, "programs", edges=str(
                tmp / "edges.npy"), n=n, extras=extras)
            cache[family, parts] = (ranks, _stacked(edges, n, parts,
                                                    extras), (edges, n))
        return cache[family, parts]
    return get


@pytest.mark.parametrize("parts", PARTS)
def test_primitives_match_stacked(parts, tmp_path):
    edges, n = oracle.family_edges("urand", N, SEED)
    np.save(tmp_path / "edges.npy", edges)
    ranks = spawn(tmp_path, parts, "primitives",
                  edges=str(tmp_path / "edges.npy"), n=n)
    want = {k: _host(v) for k, v in
            run_primitives(StackedComm(parts, "cpu")).items()}
    # the corrupt event writes -1, the reference's 0xFFFFFFFF, into one
    # bitmap word of part 1's broadcast block
    block = want["chaos bcast words"].reshape(parts, -1)[1]
    clean = want["bcast words"].reshape(parts, -1)[1]
    assert (block != clean).sum() == 1 and (block == -1).sum() \
        == (clean == -1).sum() + 1
    assert want["chaos stamp"] is True
    for rank, got in enumerate(ranks):
        for key, w in want.items():
            if key == "tally":
                assert got[key] == w, (rank, got[key], w)
            elif key in ("bcast", "bcast words", "chaos bcast words",
                         "gather_parts"):
                # every rank holds the whole replica
                assert _same(got[key][0] if key != "gather_parts"
                             else got[key], w[0] if key != "gather_parts"
                             else w), (rank, key)
            else:
                assert _same(got[key], _rows(w, rank)), (rank, key)
        assert got["mesh raises"] is True
        assert got["mesh"] == GraphMesh(parts, distributed=True)
        assert got["default comm"] == \
            f"StackedComm(parts={parts}, device=cpu)"
        assert got["refusals"] == ["CheckpointRunner", "GraphServer"], \
            got["refusals"]
        assert got["held"] == (rank, 1, [])


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("parts", PARTS)
def test_programs_match_stacked(family, parts, runs):
    ranks, want, _ = runs(family, parts)
    assert len(BUILDS) == 16 and set(BUILDS) <= set(want)
    assert all(set(got) == set(want) | {"comm"} for got in ranks)
    for rank, got in enumerate(ranks):
        assert got["comm"] == f"DistComm(parts={parts}, rank={rank}, " \
            "backend=gloo, device=cpu)"
        for label, w in want.items():
            g = got[label]
            cell = f"{label} parts={parts} family={family} rank={rank}"
            assert _same(g["rounds"], w["rounds"]), cell
            assert g["fields"].keys() == w["fields"].keys(), cell
            for nm in w["fields"]:
                assert _same(g["fields"][nm], w["fields"][nm]), \
                    f"{cell}: {nm}"
            for extra in ("wire", "ok", "rows"):
                if extra in w:
                    assert _same(g[extra], w[extra]), f"{cell}: {extra}"


def test_guard_chaos_and_batch_verdicts(runs):
    """The urand extras say what they should, beside being equal to
    StackedComm's: the clean guarded runs pass, the chaotic ones are
    caught, and each batched lane equals its single-source run."""
    for parts in PARTS:
        ranks, want, _ = runs("urand", parts)
        for label in BUILDS:
            assert want[f"guard {label}"]["ok"] == 1, label
            assert _same(want[f"guard {label}"]["fields"],
                         want[label]["fields"]), label
        for algo, variant in CHAOS_PROGRAMS:
            assert want[f"chaos {algo}/{variant}"]["ok"] == 0
        for label in BUILDS:
            if f"batch {label}" not in want:
                continue
            b = ranks[0][f"batch {label}"]
            lane = BATCH_ROOTS.index(ROOT)
            assert b["rounds"][lane] == want[label]["rounds"], label
            for nm, v in want[label]["fields"].items():
                if isinstance(v, np.ndarray):
                    assert _same(b["fields"][nm][lane], v), (label, nm)


_REFERENCE = """
import json, sys
sys.path.insert(0, {tests_dir!r})
import numpy as np
import jax.numpy as jnp
import oracle
from repro.core import GraphEngine, incremental, partition_graph, registry
from repro.launch.mesh import make_graph_mesh

edges, n = oracle.family_edges("urand", {n}, {seed})
g = partition_graph(edges, n, {parts})
eng = GraphEngine(g, make_graph_mesh({parts}))
garr = eng.device_graph()
meta, arrays = {{}}, {{}}
for label, (algo, variant, params) in {builds!r}.items():
    spec = registry.get_spec(algo, variant)
    if any(k != "scalar" for k in spec.input_kinds):
        (seed_arr,) = incremental.cold_seed(spec, g)
        args = (garr, eng.scatter_vertex_field(
            seed_arr, incremental.KIND_DTYPES[spec.input_kinds[0]]))
    else:
        args = (garr,) + (jnp.int32({root}),) * len(spec.inputs)
    prog = eng.program(algo, variant, **params)
    *outs, rounds = prog(*args)
    p = prog.program
    scal = {{}}
    for nm, o, isv in zip(p.output_names, outs, p.output_is_vertex):
        if isv:
            arrays[label + "|" + nm] = eng.gather_vertex_field(o)
        else:
            scal[nm] = float(o)
    meta[label] = {{"rounds": int(rounds), "scalars": scal}}
np.savez({out!r} + ".npz", **arrays)
json.dump(meta, open({out!r} + ".json", "w"))
print("REFERENCE-OK")
"""


def test_urand_parts4_matches_reference(runs, tmp_path):
    ranks, _, _ = runs("urand", 4)
    out = str(tmp_path / "ref")
    log = run_with_devices(_REFERENCE.format(
        tests_dir=TESTS_DIR, n=N, seed=SEED, parts=4, root=ROOT,
        builds=BUILDS, out=out), devices=4, timeout=900)
    assert "REFERENCE-OK" in log
    meta = json.load(open(out + ".json"))
    arrays = np.load(out + ".npz")
    got = ranks[0]
    for label in BUILDS:
        ref, g = meta[label], got[label]
        assert g["rounds"] == ref["rounds"], label
        for nm, v in g["fields"].items():
            if not isinstance(v, np.ndarray):
                want = ref["scalars"][nm]
                if nm == "err":
                    assert abs(float(v) - want) <= 1e-6, (label, v, want)
                else:
                    assert float(v) == want, (label, nm, v, want)
                continue
            want = arrays[f"{label}|{nm}"]
            if np.issubdtype(v.dtype, np.integer):
                np.testing.assert_array_equal(v, want, err_msg=label)
            elif nm in REF_RTOL:
                rel = np.abs(v - want).max() / max(np.abs(want).max(),
                                                   1e-30)
                assert rel < REF_RTOL[nm], (label, nm, rel)
            else:
                np.testing.assert_array_equal(v, want, err_msg=label)


def test_stacked_mesh_is_explicit_and_default():
    """With no process group the engine's mesh is the stacked one, and a
    one-part shards needs the distributed mesh."""
    edges, n = oracle.family_edges("urand", N, SEED)
    g = partition_graph(edges, n, 2)
    eng = GraphEngine(g, device="cpu")
    assert eng.mesh == GraphMesh(2) == make_graph_mesh(2)
    assert not eng.distributed and type(eng.comm) is StackedComm
    one = g.take_part(1)
    assert one.part_index == 1 and one.out_degree.shape[0] == 1
    assert one.take_part(1) is one
    whole = g.device_arrays("ell", "cpu")
    for k, v in one.device_arrays("ell", "cpu").items():
        assert torch.equal(v, whole[k][1:2]), k
    with pytest.raises(ValueError, match="distributed mesh"):
        GraphEngine(one, device="cpu")
    with pytest.raises(ValueError, match="hold no part 0"):
        one.take_part(0)
    deg = incremental.host_und_degree(g)
    part = incremental.host_und_degree(one)
    nl = g.n_local
    assert np.array_equal(part[nl:2 * nl], deg[nl:2 * nl])
    assert not part[:nl].any()


def test_part_sums_one_reduction_a_part():
    """A float field's per-part sums have the same bits whether the
    process holds every part or one.  One ``x.sum(dim=1)`` over the
    stacked rows need not: with several threads a lone row's sum is
    split across them and the stacked rows' are not, so some rows of
    these seeded fields differ.  ``part_sums`` reduces one part at a
    time, as a rank holding its part alone does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        rng = np.random.default_rng(0)
        differ = 0
        for _ in range(5):
            x = torch.from_numpy(rng.random((4, 1 << 16), dtype=np.float32))
            one = torch.cat([x[p:p + 1].sum(dim=1) for p in range(4)])
            differ += int((x.sum(dim=1) != one).sum())
            assert torch.equal(part_sums(x), one)
            for p in range(4):
                assert torch.equal(part_sums(x[p:p + 1]), one[p:p + 1])
        assert differ > 0
    finally:
        torch.set_num_threads(prev)
