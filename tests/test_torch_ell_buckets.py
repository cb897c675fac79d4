"""The multi-bucket entry points of the ELL kernels on the CPU (their
plain versions) against the JAX package's Pallas kernels in interpret
mode, bucket by bucket; the slot-order sums against ``localops``; and
the kernel route of ``localops`` (run here through the wrappers' CPU
path) against the ell path, bit for bit.  The kernels themselves are
held to the same plain versions on a card by
tests/test_torch_kernels_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracle
from repro.kernels.frontier.kernel import bfs_pull as ref_bfs_pull
from repro.kernels.spmv.kernel import spmv_ell as ref_spmv_ell
from repro_torch.core import localops, partition_graph
from repro_torch.kernels._ell import MAX_BUCKETS, bucket_views, \
    launch_tables
from repro_torch.kernels.frontier.kernel import INT_INF, bfs_pull_buckets
from repro_torch.kernels.frontier.ref import bfs_pull_ref
from repro_torch.kernels.spmv.kernel import spmv_ell_buckets
from repro_torch.kernels.spmv.ref import spmv_ell_ref

FAMILIES = [(f, p) for f in ("urand", "smallworld", "rmat") for p in (1, 4)]


@pytest.fixture(scope="module", params=FAMILIES,
                ids=lambda p: f"{p[0]}-p{p[1]}")
def graph(request):
    family, parts = request.param
    edges, n = oracle.family_edges(family, 384, 5)
    g = partition_graph(edges, n, parts)
    return g, g.device_arrays("ell", "cpu")


def _bits_of(a: torch.Tensor) -> torch.Tensor:
    return a.contiguous().view(torch.int32)


def _jax_spmv(blk, x_pad, sentinel):
    """The Pallas kernel on one part's bucket, val = (idx != sentinel)."""
    idx = blk.numpy()
    return np.asarray(ref_spmv_ell(
        jnp.asarray(idx), jnp.asarray((idx != sentinel).astype(np.float32)),
        jnp.asarray(x_pad), row_block=idx.shape[0], interpret=True))


def _jax_bfs(blk, bits_g, unv):
    return np.asarray(ref_bfs_pull(
        jnp.asarray(blk.numpy()), jnp.asarray(bits_g.view(np.uint32)),
        jnp.asarray(unv.astype(np.int32)), row_block=blk.shape[0],
        interpret=True))


@pytest.mark.parametrize("name", ["ell_in", "ell_dst"])
def test_spmv_buckets_equal_jax_per_bucket(graph, name):
    """spmv_ell_buckets' plain version is the JAX kernel's per-bucket
    outputs, concatenated (zero-width buckets give 0).  The port adds a
    row's slots left to right; the Pallas body's ``sum(axis=1)`` under
    interpret mode adds in XLA's order, so the two agree within 1e-5,
    the tolerance of tests/test_kernels_spmv.py."""
    g, garr = graph
    meta = g.ell_meta[name]
    idx = garr[f"{name}_idx"]
    x = np.random.default_rng(0).normal(
        size=(g.parts, meta.sentinel)).astype(np.float32)
    got = spmv_ell_buckets(idx, None, torch.from_numpy(x), meta.buckets,
                           skip=meta.sentinel).numpy()
    assert got.shape == (g.parts, meta.n_rows)
    x_pad = np.concatenate([x, np.zeros((g.parts, 1), np.float32)], 1)
    for p in range(g.parts):
        want = np.concatenate([
            _jax_spmv(blk[p], x_pad[p], meta.sentinel) if k else
            np.zeros(rows, np.float32)
            for _, rows, k, blk in bucket_views(idx, meta.buckets)])
        np.testing.assert_allclose(got[p], want, rtol=1e-5, atol=1e-5)


def test_bfs_buckets_equal_jax_per_bucket(graph):
    """bfs_pull_buckets' plain version (uint8 flags, no guard word, the
    sentinel skipped) is the JAX kernel's per-bucket outputs with the
    guard word, concatenated (zero-width buckets give INT_INF)."""
    g, garr = graph
    meta = g.ell_meta["ell_in"]
    idx = garr["ell_in_idx"]
    rng = np.random.default_rng(1)
    bits = rng.integers(-2 ** 31, 2 ** 31, (g.parts, g.n // 32),
                        dtype=np.int64).astype(np.int32)
    unv = rng.integers(0, 2, (g.parts, meta.n_rows)).astype(np.uint8)
    got = bfs_pull_buckets(idx, torch.from_numpy(bits),
                           torch.from_numpy(unv), meta.buckets,
                           skip=meta.sentinel).numpy()
    assert (got < INT_INF).any()
    bits_g = np.concatenate([bits, np.zeros((g.parts, 1), np.int32)], 1)
    for p in range(g.parts):
        want = np.concatenate([
            _jax_bfs(blk[p], bits_g[p], unv[p, r0:r0 + rows]) if k else
            np.full(rows, INT_INF, np.int32)
            for r0, rows, k, blk in bucket_views(idx, meta.buckets)])
        np.testing.assert_array_equal(got[p], want)


# a table with every kind of bucket: several narrow widths, rows that are
# no multiple of 32 (a ragged last warp tile), a hub width and an empty
# run
TABLE = ((40, 24), (33, 8), (7, 1024), (65, 16), (9, 0))


@pytest.mark.parametrize("parts", [1, 3])
def test_synthetic_table_equals_jax(parts):
    """Both kernels' plain versions on TABLE against the JAX kernels per
    bucket: bfs exactly, spmv (skip and val forms) within 1e-5."""
    rng = np.random.default_rng(parts)
    n_cols = 3000
    slots = sum(r * k for r, k in TABLE)
    idx = rng.integers(0, n_cols, (parts, slots)).astype(np.int32)
    idx[:, ::5] = n_cols                  # sentinel slots, never read
    x = rng.normal(size=(parts, n_cols)).astype(np.float32)
    val = rng.normal(size=(parts, slots)).astype(np.float32)
    tidx = torch.from_numpy(idx)
    got = spmv_ell_buckets(tidx, None, torch.from_numpy(x), TABLE,
                           skip=n_cols).numpy()
    safe = np.where(idx == n_cols, 0, idx)
    got_val = spmv_ell_buckets(torch.from_numpy(safe), torch.from_numpy(val),
                               torch.from_numpy(x), TABLE).numpy()
    bits = rng.integers(-2 ** 31, 2 ** 31, (parts, n_cols // 32 + 1),
                        dtype=np.int64).astype(np.int32)
    unv = rng.integers(0, 2, (parts, sum(r for r, _ in TABLE))) \
        .astype(np.int32)
    unv[:, 40:72] = 0                     # an all-dead warp tile
    got_bfs = bfs_pull_buckets(tidx, torch.from_numpy(bits),
                               torch.from_numpy(unv), TABLE,
                               skip=n_cols).numpy()
    x_pad = np.concatenate([x, np.zeros((parts, 1), np.float32)], 1)
    for p in range(parts):
        want, want_val, want_bfs = [], [], []
        for r0, rows, k, blk in bucket_views(tidx, TABLE):
            if k == 0:
                want.append(np.zeros(rows, np.float32))
                want_val.append(np.zeros(rows, np.float32))
                want_bfs.append(np.full(rows, INT_INF, np.int32))
                continue
            want.append(_jax_spmv(blk[p], x_pad[p], n_cols))
            s0 = blk.storage_offset() - tidx.storage_offset()
            b_safe = safe[p, s0:s0 + rows * k].reshape(rows, k)
            want_val.append(np.asarray(ref_spmv_ell(
                jnp.asarray(b_safe),
                jnp.asarray(val[p, s0:s0 + rows * k].reshape(rows, k)),
                jnp.asarray(x[p]), row_block=rows, interpret=True)))
            want_bfs.append(_jax_bfs(blk[p], bits[p], unv[p, r0:r0 + rows]))
        np.testing.assert_allclose(got[p], np.concatenate(want),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_val[p], np.concatenate(want_val),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got_bfs[p], np.concatenate(want_bfs))
    assert (got_bfs[:, 40:72] == INT_INF).all()


@pytest.mark.parametrize("k", [1, 8, 24, 40, 1024])
def test_ref_equals_localops_sum_slots(k):
    """spmv_ell_ref adds in localops' order: equal bits in both the skip
    form (localops' ell path) and the val form (its add combine)."""
    rng = np.random.default_rng(k)
    n_cols = 500
    idx = torch.from_numpy(rng.integers(0, n_cols + 1, (2, 70, k))
                           .astype(np.int32))
    x = torch.from_numpy(rng.normal(size=(2, n_cols)).astype(np.float32))
    x_pad = torch.cat([x, torch.zeros((2, 1))], dim=1)
    gathered = torch.gather(x_pad, 1, idx.reshape(2, -1)).reshape(idx.shape)
    want = localops._sum_slots(torch.where(idx != n_cols, gathered, 0.0))
    got = spmv_ell_ref(idx, None, x, skip=n_cols)
    assert torch.equal(_bits_of(got), _bits_of(want))
    val = torch.from_numpy(rng.normal(size=idx.shape).astype(np.float32))
    idx_v = torch.where(idx == n_cols, 0, idx)
    gathered = torch.gather(x, 1, idx_v.reshape(2, -1)).reshape(idx.shape)
    got = spmv_ell_ref(idx_v, val, x)
    assert torch.equal(_bits_of(got),
                       _bits_of(localops._sum_slots(gathered * val)))


def test_unpadded_equals_padded(graph):
    """The kernel route's unpadded x and bitmap give what a padded x (0 at
    the sentinel) and a bitmap with a zero guard word give."""
    g, garr = graph
    rng = np.random.default_rng(2)
    for name in ("ell_in", "ell_dst"):
        meta = g.ell_meta[name]
        idx = garr[f"{name}_idx"]
        x = torch.from_numpy(rng.normal(size=(g.parts, meta.sentinel))
                             .astype(np.float32))
        x_pad = torch.cat([x, torch.zeros((g.parts, 1))], dim=1)
        a = spmv_ell_buckets(idx, None, x, meta.buckets, skip=meta.sentinel)
        b = spmv_ell_buckets(idx, None, x_pad, meta.buckets,
                             skip=meta.sentinel)
        assert torch.equal(_bits_of(a), _bits_of(b))
    meta = g.ell_meta["ell_in"]
    bits = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31,
                                         (g.parts, g.n // 32),
                                         dtype=np.int64).astype(np.int32))
    unv = torch.from_numpy(rng.integers(0, 2, (g.parts, meta.n_rows))
                           .astype(bool))
    bits_g = torch.cat([bits, torch.zeros((g.parts, 1), dtype=torch.int32)],
                       dim=1)
    assert torch.equal(
        bfs_pull_buckets(garr["ell_in_idx"], bits, unv, meta.buckets,
                         skip=meta.sentinel),
        bfs_pull_buckets(garr["ell_in_idx"], bits_g, unv, meta.buckets))


@pytest.fixture
def kernel_route(monkeypatch):
    """Resolve ``auto`` to the kernel route on CPU tensors, where the
    wrappers run their plain versions."""
    real = localops.resolve
    monkeypatch.setattr(localops, "resolve",
                        lambda mode=None, device="cpu": "kernel"
                        if (mode or localops.get_mode()) == "auto"
                        else real(mode, device))


def test_kernel_route_gives_ell_bits(graph, kernel_route):
    """spmv_pull, frontier_pull and scatter_combine(add) through the
    multi-bucket entry points (unpadded inputs, one call each) equal the
    ell path bit for bit."""
    g, garr = graph
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(g.parts, g.n)).astype(np.float32))
    ell_in = g.ell_meta["ell_in"]
    assert torch.equal(
        _bits_of(localops.spmv_pull(garr, ell_in, x, mode="auto")),
        _bits_of(localops.spmv_pull(garr, ell_in, x, mode="ell")))
    bits = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31,
                                         (g.parts, g.n // 32),
                                         dtype=np.int64).astype(np.int32))
    unv = torch.from_numpy(rng.integers(0, 2, (g.parts, g.n_local))
                           .astype(bool))
    assert torch.equal(
        localops.frontier_pull(garr, ell_in, bits, unv, mode="auto"),
        localops.frontier_pull(garr, ell_in, bits, unv, mode="ell"))
    valid = garr["out_dst_global"] < g.n
    vals = torch.where(valid, torch.from_numpy(
        rng.normal(size=valid.shape).astype(np.float32)), 0.0)
    ell_dst = g.ell_meta["ell_dst"]
    assert torch.equal(
        _bits_of(localops.scatter_combine(garr, ell_dst, vals, "add",
                                          identity=0.0, mode="auto")),
        _bits_of(localops.scatter_combine(garr, ell_dst, vals, "add",
                                          identity=0.0, mode="ell")))
    with pytest.raises(ValueError, match="identity 0.0"):
        localops.scatter_combine(garr, ell_dst, vals, "add", identity=1.0,
                                 mode="auto")


def test_wrappers_reject_bad_tables():
    idx = torch.zeros((2, 100), dtype=torch.int32)
    x = torch.zeros((2, 64))
    bits = torch.zeros((2, 3), dtype=torch.int32)
    unv = torch.ones((2, 12), dtype=torch.uint8)
    for table in (((8, 8),), ((12, 8),), ((4, 25), (1, -1)), ()):
        with pytest.raises(ValueError):
            spmv_ell_buckets(idx, None, x, table, skip=0)
        with pytest.raises(ValueError):
            bfs_pull_buckets(idx, bits, unv, table, skip=0)
    good = ((4, 25),)
    assert spmv_ell_buckets(idx, None, x, good, skip=0).shape == (2, 4)
    with pytest.raises(ValueError):
        spmv_ell_buckets(idx, None, x, good)             # no val, no skip
    with pytest.raises(ValueError):
        spmv_ell_buckets(idx, torch.zeros((2, 99)), x, good)   # val shape
    with pytest.raises(ValueError):
        spmv_ell_buckets(idx[:, ::2], None, x, ((2, 25),), skip=0)
    with pytest.raises(ValueError):
        bfs_pull_buckets(idx, bits, unv, good)           # 12 flags, 4 rows
    with pytest.raises(ValueError):
        bfs_pull_buckets(idx, bits, unv[:, :4].float(), good)
    assert bfs_pull_buckets(idx, bits, unv[:, :4], good).shape == (2, 4)


def test_launch_tables_split_long_tables():
    """Up to MAX_BUCKETS buckets go in one launch's table; empty runs
    are left out; row and slot offsets run on across tables."""
    table = tuple((3, 8 * (i % 4)) for i in range(MAX_BUCKETS + 5))
    tables = launch_tables(table)
    assert [nb for _, nb in tables] == [MAX_BUCKETS, 5]
    rows = [tuple(t[4 * i:4 * i + 4]) for t, nb in tables
            for i in range(nb)]
    off = r0 = 0
    want = []
    for r, k in table:
        want.append((r0, off, r, k))
        off += r * k
        r0 += r
    assert rows == want
    assert launch_tables(((0, 8), (4, 8)))[0][1] == 1


def test_bfs_ref_skip_is_a_miss():
    """A slot holding ``skip`` never hits, even where the bitmap word it
    would index has the bit set."""
    nbr = torch.tensor([[[5, 33, 7]]], dtype=torch.int32)
    bits = torch.tensor([[-1, -1]], dtype=torch.int32)
    unv = torch.ones((1, 1), dtype=torch.int32)
    assert int(bfs_pull_ref(nbr, bits, unv)[0, 0]) == 5
    assert int(bfs_pull_ref(nbr, bits, unv, skip=5)[0, 0]) == 7
