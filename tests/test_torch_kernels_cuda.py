"""On a card only: each CUDA kernel against its plain version, at the
shapes of the JAX package's kernel tests and as strided batches.  Imports
nothing of JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest tests/test_torch_kernels_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from repro_torch.core import localops, partition_graph
from repro_torch.graphs import rmat_edges
from repro_torch.kernels._ell import launch_tables
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.frontier.kernel import bfs_pull, bfs_pull_buckets
from repro_torch.kernels.frontier.ref import bfs_pull_buckets_ref, \
    bfs_pull_ref
from repro_torch.kernels.spmv import kernel as spmv_kernel
from repro_torch.kernels.spmv.kernel import spmv_ell, spmv_ell_buckets
from repro_torch.kernels.spmv.ref import spmv_ell_buckets_ref, spmv_ell_ref


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes and bit patterns (float32 compared as int32)."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4])
def test_cuda_kernels_match_plain(batch):
    """On a card: each kernel against its plain version, bit for bit,
    strided batch rows included (a row start off 16-byte alignment takes
    the scalar index loads), widths from 1 to a hub's 1024."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    rng = np.random.default_rng(batch)
    for rows, k, n_cols in [(256, 8, 512), (512, 16, 1024), (128, 1, 128),
                            (384, 24, 999), (128, 200, 5000),
                            (100, 1024, 4096), (77, 3, 300)]:
        flat = torch.from_numpy(rng.integers(
            0, n_cols, (batch, rows * k + 5)).astype(np.int32)).cuda()
        idx = flat[:, 2:2 + rows * k].reshape(batch, rows, k)
        val = torch.randn((batch, rows, k), device="cuda")
        x = torch.randn((batch, n_cols), device="cuda")
        assert _same_bits(spmv_ell(idx, val, x), spmv_ell_ref(idx, val, x))
        assert _same_bits(spmv_ell(idx, None, x, skip=7),
                          spmv_ell_ref(idx, None, x, skip=7))
        bits = torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, (batch, n_cols // 32 + 1)).astype(
                np.int32)).cuda()
        unv = torch.from_numpy(rng.integers(
            0, 2, (batch, rows)).astype(np.int32)).cuda()
        assert torch.equal(bfs_pull(idx, bits, unv),
                           bfs_pull_ref(idx, bits, unv))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [1, 4])
def test_cuda_spmv_ell_on_ell_out_table(parts):
    """On a card: spmv_ell over a real ``ell_out`` table (a row per local
    source vertex, slots holding out-edge positions, the sentinel E never
    read; rmat hubs give wide buckets), as betweenness's backward combine
    calls it: equal to the plain version and, through scatter_combine, to
    the ``ell`` path bit for bit, in one launch per table."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    g = partition_graph(rmat_edges(12, 8 << 12, seed=3), 1 << 12, parts)
    garr = g.device_arrays("ell", "cuda")
    meta = g.ell("ell_out")
    vals = torch.rand((parts, g.e_max), device="cuda")
    assert _same_bits(
        spmv_ell_buckets(garr["ell_out_idx"], None, vals, meta.buckets,
                         skip=meta.sentinel),
        spmv_ell_buckets_ref(garr["ell_out_idx"], None, vals, meta.buckets,
                             skip=meta.sentinel))
    before = spmv_kernel.spmv_ell.launches
    got = localops.scatter_combine(garr, meta, vals, "add", identity=0.0,
                                   mode="kernel")
    assert spmv_kernel.spmv_ell.launches - before \
        == len(launch_tables(meta.buckets))
    assert _same_bits(got, localops.scatter_combine(
        garr, meta, vals, "add", identity=0.0, mode="ell"))
    torch.cuda.synchronize()


# bucket tables: widths 8, 16, 24, 40 and 1024, rows that are no multiple
# of 32, an empty run
BUCKET_TABLES = [((64, 40), (96, 24), (128, 16), (256, 8)),
                 ((7, 1024), (33, 40), (45, 24), (31, 16), (50, 8),
                  (20, 0)),
                 ((1, 8),),
                 # more buckets than one launch's table holds (as a
                 # skewed graph's ELL can have): one launch per 64
                 tuple((5 + i % 3, 8 * (1 + i % 9)) for i in range(70))
                 + ((3, 128), (4, 0))]


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [1, 3, 4])
@pytest.mark.parametrize("table", range(len(BUCKET_TABLES)))
def test_cuda_bucket_kernels_match_plain(table, parts):
    """On a card: each multi-bucket kernel, one launch per 64 buckets,
    equals its plain version bit for bit, over a strided batch of parts: spmv_ell in the
    skip form (x shared by all parts, stride 0, no pad slot) and the val
    form; bfs_pull with uint8 and int32 flags, an all-dead warp tile and
    the sentinel never read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    buckets = BUCKET_TABLES[table]
    rng = np.random.default_rng(10 * table + parts)
    n_cols = 20000
    slots = sum(r * k for r, k in buckets)
    rows = sum(r for r, _ in buckets)
    store = torch.from_numpy(rng.integers(
        0, n_cols, (parts, slots + 16)).astype(np.int32)).cuda()
    store[:, 3::7] = n_cols                      # sentinel slots
    idx = store[:, 8:8 + max(slots, 1)]          # part stride slots + 16
    x = torch.randn((1, n_cols), device="cuda").expand(parts, -1)
    launches = len(launch_tables(buckets))
    before = spmv_ell.launches
    got = spmv_ell_buckets(idx, None, x, buckets, skip=n_cols)
    torch.cuda.synchronize()
    assert spmv_ell.launches == before + launches
    assert _same_bits(got, spmv_ell_buckets_ref(idx, None, x, buckets,
                                                skip=n_cols))
    safe = torch.where(idx == n_cols, 0, idx)
    val = torch.randn(idx.shape, device="cuda")
    assert _same_bits(spmv_ell_buckets(safe, val, x, buckets),
                      spmv_ell_buckets_ref(safe, val, x, buckets))
    bits = torch.from_numpy(rng.integers(
        -2 ** 31, 2 ** 31, (1, n_cols // 32)).astype(np.int32)).cuda() \
        .expand(parts, -1)
    unv = torch.from_numpy(rng.integers(0, 2, (parts, rows))
                           .astype(np.uint8)).cuda()
    unv[:, :32] = 0                              # an all-dead warp tile
    for flags in (unv, unv.to(torch.int32), unv.bool()):
        before = bfs_pull.launches
        got = bfs_pull_buckets(idx, bits, flags, buckets, skip=n_cols)
        torch.cuda.synchronize()
        assert bfs_pull.launches == before + launches
        assert torch.equal(got, bfs_pull_buckets_ref(idx, bits, flags,
                                                     buckets, skip=n_cols))
        assert bool((got[:, :32] == 2 ** 30).all())


# (bh, sq, sk, d, causal, window, softcap): the sweep of
# tests/test_kernels_flash.py, head dims 64/120/256, ragged and cross
# lengths, and Sq > Sk + window (rows with no key in their window); then
# the edges of the bf16 design's tiles (128-row q tiles, k tiles of 128,
# 64 or 32 keys, head dims padded to 64/128/256): several q tiles at S = 1000
# and 1024, Sq != Sk both ways, a window ending inside a tile, Sq > Sk +
# window - 1, head dims on each side of every padded width, softcap
# under causal masking
FLASH_CASES = [
    (bh, s, s, d, causal, window, 0.0)
    for bh, s, d in [(2, 256, 128), (4, 512, 128), (1, 128, 256)]
    for causal, window in [(True, 0), (True, 64), (False, 0)]
] + [
    (2, 128, 512, 128, False, 0, 0.0), (1, 128, 128, 128, True, 0, 20.0),
    (3, 200, 200, 64, True, 0, 0.0), (2, 300, 300, 120, True, 64, 0.0),
    (2, 77, 333, 256, False, 32, 0.0), (2, 512, 128, 64, True, 64, 0.0),
    (2, 128, 512, 64, True, 0, 0.0), (1, 1, 1, 8, True, 0, 0.0),
] + [
    (2, 1000, 1000, 64, True, 0, 0.0), (2, 1024, 1024, 128, True, 0, 0.0),
    (2, 700, 300, 64, True, 0, 0.0), (2, 300, 700, 128, True, 0, 0.0),
    (2, 500, 500, 64, True, 100, 0.0), (2, 600, 200, 64, True, 50, 0.0),
    (2, 400, 400, 128, True, 0, 30.0),
] + [(2, 200, 200, d, True, 0, 0.0) for d in (8, 72, 120, 136, 200, 256)]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_matches_plain(case, dtype, tol):
    """On a card: flash_attention_fwd against ref.py, at the tolerances
    of tests/test_kernels_flash.py (f32 2e-5; bf16 2e-2, one bf16 ulp of
    outputs near 4 is 1.6e-2)."""
    _needs_card()
    bh, sq, sk, d, causal, window, softcap = case
    g = torch.Generator(device="cuda").manual_seed(sq * 1000 + d)
    q, k, v = [torch.randn((bh, n, d), generator=g, device="cuda")
               .to(dtype) for n in (sq, sk, sk)]
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_flash_counts_tensor_core_launches():
    """Each bf16 call on the card adds one to ``launches_tc`` (the
    tensor-core design); an f32 call adds to ``launches`` only."""
    _needs_card()
    x = torch.randn((2, 256, 64), device="cuda")
    for dtype, tc in ((torch.bfloat16, 1), (torch.float32, 0)):
        before = (flash_attention_fwd.launches,
                  flash_attention_fwd.launches_tc)
        t = x.to(dtype)
        flash_attention_fwd(t, t, t, causal=True)
        torch.cuda.synchronize()
        assert (flash_attention_fwd.launches,
                flash_attention_fwd.launches_tc) == (before[0] + 1,
                                                     before[1] + tc)


@pytest.mark.cuda
def test_cuda_flash_ops_head_dim_120():
    """danube3's head dim 120 through ops, (B, S, H, D) in and out."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(120)
    q, k, v = [torch.randn((2, 128, 4, 120), generator=g, device="cuda")
               for _ in range(3)]
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_ref(*(t.transpose(1, 2).reshape(8, 128, 120)
                                 for t in (q, k, v)), causal=True)
    torch.testing.assert_close(
        got, want.reshape(2, 4, 128, 120).transpose(1, 2),
        atol=2e-5, rtol=2e-5)


# lse: the f32 log-sum-exp beside o.  Scores are f32 in both versions
# (products of the inputs exact in f32, summed in another order), the
# kernel's bf16 design takes exponentials and the log in base 2 with the
# approximate units (2 ulp), so the two agree far inside 1e-3.
LSE_TOL = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_lse_matches_plain(case, dtype):
    """On a card: ``return_lse=True`` gives o with the same bits as the
    call without it, and an lse within LSE_TOL of ref.py's."""
    _needs_card()
    bh, sq, sk, d, causal, window, softcap = case
    g = torch.Generator(device="cuda").manual_seed(sq * 1000 + d + 7)
    q, k, v = [torch.randn((bh, n, d), generator=g, device="cuda")
               .to(dtype) for n in (sq, sk, sk)]
    kw = dict(causal=causal, window=window, softcap=softcap)
    o = flash_attention_fwd(q, k, v, **kw)
    o2, lse = flash_attention_fwd(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o.view(torch.int16 if dtype == torch.bfloat16
                              else torch.int32),
                       o2.view(torch.int16 if dtype == torch.bfloat16
                               else torch.int32))
    _, want = flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert lse.shape == (bh, sq) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, atol=LSE_TOL, rtol=LSE_TOL)


@pytest.mark.cuda
def test_cuda_flash_train_grads_match_plain():
    """On a card: the autograd Function through the kernel forward gives
    the gradients of its plain forward (same backward, residuals from the
    kernel), within the bf16 tolerance."""
    _needs_card()
    from repro_torch.models.layers import flash_attention_train
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = [torch.randn((2, 256, 4, 64), generator=g, device="cuda")
               .to(torch.bfloat16).requires_grad_(True) for _ in range(3)]
    do = torch.randn((2, 256, 4, 64), generator=g, device="cuda") \
        .to(torch.bfloat16)
    grads = []
    for plain in (False, True):
        o = flash_attention_train(q, k, v, causal=True, window=0,
                                  softcap=0.0, plain=plain)
        grads.append(torch.autograd.grad(o, (q, k, v), do))
    for a, b in zip(*grads):
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2,
                                   rtol=2e-2)
