"""Registry, engine and launcher of the port: the sixteen registrations
carry the JAX package's order, defaults, input kinds, exec modes and
incremental metadata, programs (batched and phased ones too) are
interned, the engine refuses to fall back to the CPU, and the launcher's
verify lines pass."""

import numpy as np
import pytest
import torch

import oracle
from repro.core import registry as ref_registry
from repro_torch.core import GraphEngine, localops, partition_graph, \
    registry, run_program
from repro_torch.launch import graph_analytics

# every pair the reference registers, in its order
PORTED = ref_registry.available()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests run many small tensor ops; one intra-op thread a
    worker keeps the test workers, which share the cores, from
    oversubscribing them (8 threads each thrash under load)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def engine():
    edges, n = oracle.family_edges("urand", 384, 5)
    return GraphEngine(partition_graph(edges, n, 2), device="cpu")


def test_registrations_match_reference():
    assert registry.available() == PORTED and len(PORTED) == 16
    for algo, variant in PORTED:
        ours = registry.get_spec(algo, variant)
        ref = ref_registry.get_spec(algo, variant)
        assert ours.defaults == ref.defaults
        assert ours.batch_defaults == ref.batch_defaults
        assert ours.inputs == ref.inputs
        assert ours.input_kinds == ref.input_kinds
        assert ours.exec_mode == ref.exec_mode
        assert (ours.incremental is None) == (ref.incremental is None)
        if ref.incremental is not None:
            assert vars(ours.incremental) == vars(ref.incremental)
        assert ours.n_budget == ref.n_budget
        assert ours.doc == ref.doc
        assert ours.key == ref.key and ours.label == ref.label
    assert registry.async_pairs() == ref_registry.async_pairs()
    assert registry.INPUT_KINDS == ref_registry.INPUT_KINDS
    assert registry.EXEC_MODES == ref_registry.EXEC_MODES
    for algo in {a for a, _ in PORTED}:
        assert registry.default_variant(algo) \
            == ref_registry.default_variant(algo)
        assert registry.variants(algo) == ref_registry.variants(algo)
        for mode in registry.EXEC_MODES:
            assert registry.mode_variant(algo, mode) \
                == ref_registry.mode_variant(algo, mode)
    with pytest.raises(ValueError, match="exec_mode"):
        registry.mode_variant("bfs", "speculative")


def test_spec_checks_match_reference():
    """The spec's __post_init__ checks: input kinds default to scalar,
    and a kind count, kind or exec mode out of line raises."""
    spec = registry.get_spec("bfs", "fast")
    assert spec.input_kinds == ("scalar",)
    import dataclasses
    for bad in ({"input_kinds": ("scalar", "scalar")},
                {"input_kinds": ("vertex_u8",)},
                {"exec_mode": "speculative"}):
        with pytest.raises(ValueError):
            dataclasses.replace(spec, **bad)


def test_get_spec_errors():
    assert registry.get_spec("bfs/bsp") is registry.get_spec("bfs", "bsp")
    assert registry.get_spec("bfs").variant == "fast"
    with pytest.raises(KeyError, match="bfs/fast"):
        registry.get_spec("nope")
    with pytest.raises(KeyError, match="registered programs"):
        registry.get_spec("bfs", "nope")
    with pytest.raises(ValueError):
        registry.register(registry.get_spec("bfs", "bsp"))


def test_program_cache_identity(engine):
    a = engine.program("bfs", "fast")
    assert engine.program("bfs", "fast") is a
    assert engine.program("bfs/fast") is a
    assert engine.program("bfs") is a                # default variant
    assert engine.program("bfs", "fast", direction="adaptive") is a
    assert engine.program("bfs", "fast", direction="pull") is not a
    assert engine.program("bfs", "fast", static_iters=3) is not a
    with localops.using("ref"):
        assert engine.program("bfs", "fast") is not a
    with pytest.raises(TypeError, match="unknown params"):
        engine.program("bfs", "fast", bogus=1)


def test_engine_without_device_raises_here(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    edges, n = oracle.family_edges("urand", 384, 5)
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphEngine(partition_graph(edges, n, 1))


def test_kernel_mode_on_cpu_raises(engine):
    garr = engine.device_graph()
    with localops.using("kernel"):
        prog = engine.program("pagerank", "bsp")
    with pytest.raises(RuntimeError, match="CUDA"):
        prog(garr)


def test_static_iters_and_vertex_fields(engine):
    garr = engine.device_graph()
    parents, rounds = engine.program("bfs", "bsp")(garr, 3)
    fixed, fixed_rounds = engine.program("bfs", "bsp",
                                         static_iters=rounds + 3)(garr, 3)
    assert fixed_rounds == rounds + 3
    assert torch.equal(parents, fixed)
    field = np.arange(engine.g.n_orig, dtype=np.int32)
    back = engine.gather_vertex_field(engine.scatter_vertex_field(field))
    np.testing.assert_array_equal(back, field)
    with pytest.raises(ValueError):
        engine.scatter_vertex_field(field[:10])


@pytest.mark.parametrize("parts", [1, 2])
def test_launcher_verify_lines(parts, capsys):
    results = graph_analytics.run("urand12", parts, device="cpu")
    out = capsys.readouterr().out
    assert "[verify] BFS reachability bsp==fast: True" in out
    rel = float(out.split("PageRank bsp-vs-fast max rel diff:")[1].split()[0])
    assert rel < 1e-4, out
    assert "[verify] k-core degeneracy: " in out
    assert "[verify] betweenness delta_s(s) == 0: True" in out
    assert "[verify] triangles sum/3 == total: True" in out
    assert "[verify] BFS reachability async==fast: True" in out
    assert "[verify] CC labels async==bsp: True" in out
    assert "[verify] SSSP dist async==bsp: True" in out
    rel = float(out.split("PageRank bsp-vs-async max rel diff:")[1]
                .split()[0])
    assert rel < 1e-2, out
    assert sorted(results) == sorted(
        registry.program_label(a, v) for a, v in registry.available())
    assert "spmv_ell=" in out and "bfs_pull=" in out


@pytest.mark.parametrize("exec_mode", ["bsp", "async"])
def test_launcher_exec_mode(exec_mode, capsys):
    """--exec-mode keeps the programs of one loop (the incremental
    variants, bsp programs, from their cold seeds); the async-vs-bsp
    verify lines need both and are absent."""
    results = graph_analytics.run("urand12", 2, device="cpu", pr_iters=20,
                                  exec_mode=exec_mode, multi_source=2)
    out = capsys.readouterr().out
    want = {registry.program_label(a, v) for a, v in registry.available()
            if registry.get_spec(a, v).exec_mode == exec_mode}
    batched = {"bfs_fast", "sssp", "betweenness"} if exec_mode == "bsp" \
        else {"bfs_async", "sssp_async"}
    assert set(results) == want | {f"{b}_x2" for b in batched}
    assert "async==" not in out and "bsp-vs-async" not in out
    if exec_mode == "async":
        for label in ("BFS async", "SSSP async"):
            assert f"[verify] multi-source {label} root0 == " \
                   "single-source: True" in out, out


def test_launcher_multi_source_and_budget(capsys, monkeypatch):
    """--multi-source batches bfs/fast, sssp and betweenness, whose root-0
    rows equal the single-source runs; a program past its n_budget (here
    triangles with the budget cut to 1024) is skipped with a note."""
    import dataclasses
    key = ("triangles", "default")
    monkeypatch.setitem(registry._REGISTRY, key, dataclasses.replace(
        registry.get_spec(*key), n_budget=1024))
    results = graph_analytics.run("urand12", 2, device="cpu", pr_iters=5,
                                  multi_source=2)
    out = capsys.readouterr().out
    assert "triangles" not in results
    assert "skipped (n=4,096 exceeds its n_budget=1,024)" in out
    assert {"bfs_fast_x2", "sssp_x2", "betweenness_x2"} <= set(results)
    assert not {"bfs_bsp_x2", "pagerank_fast_x2", "cc_x2"} & set(results)
    for label in ("BFS", "SSSP", "betweenness"):
        assert f"[verify] multi-source {label} root0 == single-source: " \
               "True" in out, out


def test_batch_builds(engine):
    """batch=B is part of the cache key, merges batch_defaults under
    explicit params, refuses programs without per-query inputs and calls
    with the wrong number of roots; batched fields gather to (B, n)."""
    a = engine.program("bfs", "fast", batch=3)
    assert engine.program("bfs", "fast", batch=3) is a
    assert a is not engine.program("bfs", "fast", batch=2)
    assert a.program is not engine.program("bfs", "fast").program
    assert engine.program("bfs", "fast", batch=3, direction="pull") is a
    with pytest.raises(ValueError, match="no per-query inputs"):
        engine.program("pagerank", "fast", batch=2)
    garr = engine.device_graph()
    with pytest.raises(ValueError, match="batch=3"):
        a(garr, [0, 1])
    parents, rounds = a(garr, [3, 0, 3])
    assert parents.shape == (engine.g.parts, 3, engine.g.n_local)
    assert len(rounds) == 3 and rounds[0] == rounds[2]
    rows = engine.gather_batched_vertex_field(parents)
    assert rows.shape == (3, engine.g.n_orig)
    single, _ = engine.program("bfs", "fast")(garr, 3)
    np.testing.assert_array_equal(rows[0], engine.gather_vertex_field(single))
    np.testing.assert_array_equal(rows[2], rows[0])


def test_phased_program_through_engine(engine):
    """betweenness is a PhasedProgram: interned like any program, its
    rounds the sum of its phases', and static_iters runs each phase that
    many rounds."""
    prog = engine.program("betweenness")
    assert engine.program("betweenness", "default") is prog
    assert len(prog.program.phases) == 2
    garr = engine.device_graph()
    bc, sigma, dist, rounds = prog(garr, 3)
    fwd, back = prog.program.phases
    (dist1, sigma1), r1 = run_program(fwd, garr, 3)
    (bc2, _, _), r2 = run_program(back, garr, dist1, sigma1)
    assert rounds == r1 + r2
    assert torch.equal(bc, bc2) and torch.equal(sigma, sigma1)
    fixed = engine.program("betweenness", static_iters=max(r1, r2) + 2)
    *outs, fixed_rounds = fixed(garr, 3)
    assert fixed_rounds == 2 * (max(r1, r2) + 2)
    assert torch.equal(outs[0], bc) and torch.equal(outs[2], dist)


def test_prepare_runs_before_init_and_once_per_batch(engine):
    """run_program applies prepare once before init; the batched loop
    applies a non-phased program's prepare once for all B queries, and
    inits once per distinct root (lane 2 repeats lane 0's run)."""
    import dataclasses
    from repro_torch.core import run_program_batched
    base = engine.program("sssp").program
    seen = []

    def prepare(g):
        seen.append("prepare")
        return base.prepare(g)

    def init(g, root):
        assert "out_weight" in g
        seen.append("init")
        return base.init(g, root)

    prog = dataclasses.replace(base, prepare=prepare, init=init)
    garr = engine.device_graph()
    (dist,), rounds = run_program(prog, garr, 3)
    assert seen == ["prepare", "init"] and "out_weight" not in garr
    seen.clear()
    (dists,), rounds_b = run_program_batched(prog, garr, [3, 5, 3])
    assert seen == ["prepare", "init", "init"]
    assert rounds_b[0] == rounds_b[2] == rounds
    assert torch.equal(dists[:, 0], dist) and torch.equal(dists[:, 2], dist)
