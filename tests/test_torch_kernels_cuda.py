"""On a card only: each CUDA kernel against its plain version, at the
shapes of the JAX package's kernel tests and as strided batches.  Imports
nothing of JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest tests/test_torch_kernels_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.frontier.kernel import bfs_pull
from repro_torch.kernels.frontier.ref import bfs_pull_ref
from repro_torch.kernels.spmv.kernel import spmv_ell
from repro_torch.kernels.spmv.ref import spmv_ell_ref


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4])
def test_cuda_kernels_match_plain(batch):
    """On a card: each kernel against its plain version, strided batch
    rows included (how localops hands it ELL buckets)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    rng = np.random.default_rng(batch)
    for rows, k, n_cols in [(256, 8, 512), (512, 16, 1024), (128, 1, 128),
                            (384, 24, 999), (128, 200, 5000)]:
        flat = torch.from_numpy(rng.integers(
            0, n_cols, (batch, rows * k + 5)).astype(np.int32)).cuda()
        idx = flat[:, 2:2 + rows * k].reshape(batch, rows, k)
        val = torch.randn((batch, rows, k), device="cuda")
        x = torch.randn((batch, n_cols), device="cuda")
        torch.testing.assert_close(spmv_ell(idx, val, x),
                                   spmv_ell_ref(idx, val, x),
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(spmv_ell(idx, None, x, skip=7),
                                   spmv_ell_ref(idx, None, x, skip=7),
                                   rtol=1e-5, atol=1e-5)
        bits = torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, (batch, n_cols // 32 + 1)).astype(
                np.int32)).cuda()
        unv = torch.from_numpy(rng.integers(
            0, 2, (batch, rows)).astype(np.int32)).cuda()
        assert torch.equal(bfs_pull(idx, bits, unv),
                           bfs_pull_ref(idx, bits, unv))
    torch.cuda.synchronize()


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
