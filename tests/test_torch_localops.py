"""Local ops of the port against the JAX package's, on the same
partition arrays: port ``ref`` against reference ``ref`` and port
``ell`` against reference ``ell`` (its CPU ``auto``), for every primitive
and op, plus mode resolution.  The reference primitives are pure
per-partition compute, so they run here part by part outside
shard_map; the port runs all parts stacked.  Integer and boolean results
must be equal; float32 sums agree to 1e-5."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracle
from repro.core import localops as ref_localops
from repro.core import partition_graph
from repro_torch.core import GraphShards, localops

INT_INF = 2 ** 30
MODES = (("ref", "ref"), ("ell", "auto"))     # (port mode, reference mode)


@pytest.fixture(scope="module",
                params=[("urand", 2), ("smallworld", 2), ("rmat", 4)],
                ids=lambda p: f"{p[0]}-p{p[1]}")
def graph(request):
    family, parts = request.param
    edges, n = oracle.family_edges(family, 384, 5)
    g = partition_graph(edges, n, parts)
    ours = GraphShards.from_arrays(dataclasses.asdict(g))
    ref_arrs = g.device_arrays()
    ref_parts = [{k: v[p] for k, v in ref_arrs.items()}
                 for p in range(parts)]
    return g, ours.device_arrays("ell", "cpu"), ref_parts


def _check(got, want, float_sum):
    if float_sum:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_array_equal(got, want)


def test_spmv_pull_parity(graph):
    g, garr, ref_parts = graph
    x = np.random.default_rng(0).normal(size=(g.parts, g.n)) \
        .astype(np.float32)
    for mode, ref_mode in MODES:
        got = localops.spmv_pull(garr, g.ell_meta["ell_in"],
                                 torch.from_numpy(x), mode=mode).numpy()
        for p, rg in enumerate(ref_parts):
            want = np.asarray(ref_localops.spmv_pull(
                rg, g.ell_meta["ell_in"], jnp.asarray(x[p]), mode=ref_mode))
            _check(got[p], want, True)


def test_frontier_pull_parity(graph):
    g, garr, ref_parts = graph
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2 ** 32, (g.parts, g.n // 32), dtype=np.uint32)
    unv = rng.integers(0, 2, (g.parts, g.n_local)).astype(bool)
    for mode, ref_mode in MODES:
        got = localops.frontier_pull(
            garr, g.ell_meta["ell_in"], torch.from_numpy(bits.view(np.int32)),
            torch.from_numpy(unv), mode=mode).numpy()
        assert (got < INT_INF).any()
        for p, rg in enumerate(ref_parts):
            want = np.asarray(ref_localops.frontier_pull(
                rg, g.ell_meta["ell_in"], jnp.asarray(bits[p]),
                jnp.asarray(unv[p]), mode=ref_mode))
            _check(got[p], want, False)


_KEY = {"ell_dst": "out_dst_global", "ell_src": "in_src_global",
        "ell_out": "out_dst_global"}


@pytest.mark.parametrize("which,op", [
    ("ell_dst", "add"), ("ell_dst", "min"), ("ell_dst", "max"),
    ("ell_dst", "or"), ("ell_src", "min"), ("ell_src", "add"),
    ("ell_src", "max"), ("ell_src", "or"), ("ell_out", "add"),
    ("ell_out", "min"),
])
def test_scatter_combine_parity(graph, which, op):
    g, garr, ref_parts = graph
    rng = np.random.default_rng(2)
    valid = garr[_KEY[which]].numpy() < g.n
    if op == "add":
        identity = 0.0
        vals = np.where(valid, rng.normal(size=valid.shape), 0.0) \
            .astype(np.float32)
    elif op == "or":
        identity = False
        vals = valid & (rng.integers(0, 2, valid.shape) > 0)
    else:
        identity = INT_INF if op == "min" else 0
        vals = np.where(valid, rng.integers(0, 10 ** 6, valid.shape),
                        identity).astype(np.int32)
    for mode, ref_mode in MODES:
        got = localops.scatter_combine(
            garr, g.ell_meta[which], torch.from_numpy(vals), op,
            identity=identity, mode=mode).numpy()
        for p, rg in enumerate(ref_parts):
            want = np.asarray(ref_localops.scatter_combine(
                rg, g.ell_meta[which], jnp.asarray(vals[p]), op,
                identity=identity, mode=ref_mode))
            assert got[p].dtype == want.dtype, (got.dtype, want.dtype)
            _check(got[p], want, op == "add")


def test_coo_layout_takes_ref_path(graph):
    """Without ELL arrays every mode runs the COO scatter path."""
    g, garr, _ = graph
    coo = {k: v for k, v in garr.items() if not k.startswith("ell_")}
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(g.parts, g.n)).astype(np.float32))
    want = localops.spmv_pull(garr, g.ell_meta["ell_in"], x, mode="ref")
    for mode in ("auto", "ell"):
        assert torch.equal(localops.spmv_pull(coo, g.ell_meta["ell_in"], x,
                                              mode=mode), want)


def test_kernel_mode_on_cpu_raises(graph):
    g, garr, _ = graph
    x = torch.zeros((g.parts, g.n))
    with pytest.raises(RuntimeError, match="CUDA"):
        localops.spmv_pull(garr, g.ell_meta["ell_in"], x, mode="kernel")


def test_mode_resolution(monkeypatch):
    monkeypatch.delenv("REPRO_LOCALOPS", raising=False)
    localops.set_mode(None)
    assert localops.get_mode() == "auto"
    monkeypatch.setenv("REPRO_LOCALOPS", "ref")
    assert localops.get_mode() == "ref"
    localops.set_mode("kernel")         # override beats the env var
    assert localops.get_mode() == "kernel"
    with localops.using("ell"):
        assert localops.get_mode() == "ell"
    assert localops.get_mode() == "kernel"
    localops.set_mode(None)
    assert localops.get_mode() == "ref"
    monkeypatch.setenv("REPRO_LOCALOPS", "bogus")
    with pytest.raises(ValueError):
        localops.get_mode()
    with pytest.raises(ValueError):
        localops.set_mode("bogus")
    monkeypatch.delenv("REPRO_LOCALOPS")
    assert localops.resolve("ref", "cuda") == "ref"
    assert localops.resolve("ell", "cuda") == "ell"
    assert localops.resolve("auto", "cuda") == "kernel"
    assert localops.resolve("kernel", "cuda") == "kernel"
    assert localops.resolve("auto", "cpu") == "ell"
    with pytest.raises(RuntimeError):
        localops.resolve("kernel", "cpu")
