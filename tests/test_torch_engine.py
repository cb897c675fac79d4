"""Registry, engine and launcher of the port: the four main-path
registrations carry the JAX package's defaults, programs are interned,
the engine refuses to fall back to the CPU, and the launcher's verify
lines pass."""

import numpy as np
import pytest
import torch

import oracle
from repro.core import registry as ref_registry
from repro_torch.core import GraphEngine, localops, partition_graph, \
    registry
from repro_torch.launch import graph_analytics

MAIN_PATH = [("bfs", "bsp"), ("bfs", "fast"), ("pagerank", "bsp"),
             ("pagerank", "fast")]


@pytest.fixture(scope="module")
def engine():
    edges, n = oracle.family_edges("urand", 384, 5)
    return GraphEngine(partition_graph(edges, n, 2), device="cpu")


def test_registrations_match_reference():
    assert registry.available() == MAIN_PATH
    for algo, variant in MAIN_PATH:
        ours = registry.get_spec(algo, variant)
        ref = ref_registry.get_spec(algo, variant)
        assert ours.defaults == ref.defaults
        assert ours.batch_defaults == ref.batch_defaults
        assert ours.inputs == ref.inputs
        assert ours.key == ref.key and ours.label == ref.label
    for algo in ("bfs", "pagerank"):
        assert registry.default_variant(algo) \
            == ref_registry.default_variant(algo) == "fast"


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
    assert sorted(results) == ["bfs_bsp", "bfs_fast", "pagerank_bsp",
                               "pagerank_fast"]
    assert "spmv_ell=" in out and "bfs_pull=" in out
