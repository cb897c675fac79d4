"""On a card only: each CUDA kernel against its plain version, at the
shapes of the JAX package's kernel tests and as strided batches.  Imports
nothing of JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest tests/test_torch_kernels_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

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
