"""Host graph data of the port: generators and partition arrays are
byte-identical to the JAX package's, and ``GraphShards.from_arrays``
carries the reference's arrays across unchanged."""

import dataclasses

import numpy as np
import pytest
import torch

import oracle
from repro.configs import graph_workloads as ref_workloads
from repro.core import graph as ref_graph
from repro.graphs import generate as ref_generate
from repro_torch.configs import graph_workloads
from repro_torch.core import graph
from repro_torch.graphs import generate

CASES = [(fam, parts) for fam in ("urand", "smallworld", "rmat")
         for parts in (1, 2, 4)]


def _port_edges(family, n, seed):
    """The oracle's families, generated by the PORT's generators."""
    if family == "urand":
        return generate.urand_edges(n, 8 * n, seed=seed), n
    if family == "smallworld":
        return generate.smallworld_edges(n, k=8, p=0.2, seed=seed), n
    scale = max(1, int(np.ceil(np.log2(n))))
    n2 = 1 << scale
    return generate.rmat_edges(scale, 8 * n2, seed=seed), n2


def _assert_same_shards(ours, ref):
    for f in ("n", "n_orig", "parts", "n_local", "e_max"):
        assert getattr(ours, f) == getattr(ref, f), f
    for f in ("out_src_local", "out_dst_global", "in_src_global",
              "in_dst_local", "out_degree", "in_degree"):
        a, b = getattr(ours, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert sorted(ours.ell_arrays) == sorted(ref.ell_arrays)
    for k, b in ref.ell_arrays.items():
        a = ours.ell_arrays[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    assert sorted(ours.ell_meta) == sorted(ref.ell_meta)
    for name, m in ref.ell_meta.items():
        assert dataclasses.astuple(ours.ell_meta[name]) \
            == dataclasses.astuple(m), name
    assert ours.layout_signature() == ref.layout_signature()


@pytest.mark.parametrize("family,parts", CASES)
def test_partition_byte_identical(family, parts):
    edges, n = _port_edges(family, 384, 5)
    ref_edges, ref_n = oracle.family_edges(family, 384, 5)
    assert n == ref_n and edges.tobytes() == ref_edges.tobytes()
    _assert_same_shards(graph.partition_graph(edges, n, parts),
                        ref_graph.partition_graph(ref_edges, n, parts))


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_urand12_byte_identical(parts):
    cfg = graph_workloads.URAND12
    assert dataclasses.astuple(cfg) \
        == dataclasses.astuple(ref_workloads.URAND12)
    edges = generate.generate_edges(cfg, seed=42)
    ref_edges = ref_generate.generate_edges(ref_workloads.URAND12, seed=42)
    assert edges.tobytes() == ref_edges.tobytes()
    _assert_same_shards(
        graph.partition_graph(edges, cfg.num_vertices, parts),
        ref_graph.partition_graph(ref_edges, cfg.num_vertices, parts))


def test_workload_table_matches():
    assert {k: dataclasses.astuple(v)
            for k, v in graph_workloads.ALL.items()} \
        == {k: dataclasses.astuple(v)
            for k, v in ref_workloads.ALL.items()}


@pytest.mark.parametrize("family,parts", [("rmat", 2), ("urand", 4)])
def test_from_arrays_carries_reference_arrays(family, parts):
    edges, n = oracle.family_edges(family, 384, 5)
    ref = ref_graph.partition_graph(edges, n, parts)
    ours = graph.GraphShards.from_arrays(dataclasses.asdict(ref))
    _assert_same_shards(ours, ref)
    dev = ours.device_arrays("ell", "cpu")
    ref_dev = ref.device_arrays("ell")
    assert sorted(dev) == sorted(ref_dev)
    for k, v in dev.items():
        assert v.dtype == torch.int32 and v.shape[0] == parts, k
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref_dev[k]))
    coo = ours.device_arrays("coo", "cpu")
    assert sorted(coo) == sorted(ref.device_arrays("coo"))


def test_ell_placeholder_without_layout():
    edges, n = oracle.family_edges("urand", 384, 5)
    ours = graph.partition_graph(edges, n, 2, build_ell_layout=False)
    ref = ref_graph.partition_graph(edges, n, 2, build_ell_layout=False)
    assert not ours.ell_meta and not ours.ell_arrays
    for name in ("ell_in", "ell_out", "ell_dst", "ell_src"):
        assert dataclasses.astuple(ours.ell(name)) \
            == dataclasses.astuple(ref.ell(name))


def test_ell_helpers_match_reference():
    edges, n = oracle.family_edges("rmat", 384, 5)
    ours = graph.partition_graph(edges, n, 2)
    ref = ref_graph.partition_graph(edges, n, 2)
    for name, meta in ours.ell_meta.items():
        rmeta = ref.ell_meta[name]
        for a, b in zip(graph.ell_row_layout(meta.buckets),
                        ref_graph.ell_row_layout(rmeta.buckets)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            graph.ell_slot_rows(meta.buckets),
            ref_graph.ell_slot_rows(rmeta.buckets))
        idx = ours.ell_arrays[f"{name}_idx"]
        np.testing.assert_array_equal(
            graph.ell_occupancy(meta, idx),
            ref_graph.ell_occupancy(rmeta, idx))
        inv = ours.ell_arrays[f"{name}_inv"]
        assert graph.ell_entries(meta, idx[1], inv[1]) \
            == ref_graph.ell_entries(rmeta, idx[1], inv[1])
