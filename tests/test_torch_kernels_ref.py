"""The kernels' plain versions against the JAX package's Pallas kernels
(interpret mode), case for case with tests/test_kernels_spmv.py and
tests/test_kernels_frontier.py; and the wrappers' input checks.  The
kernels themselves are held against the plain versions on a card by
tests/test_torch_kernels_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.frontier.kernel import bfs_pull as ref_bfs_pull
from repro.kernels.spmv.kernel import spmv_ell as ref_spmv_ell
from repro_torch.kernels.frontier import ops as frontier_ops
from repro_torch.kernels.frontier.kernel import INT_INF, bfs_pull
from repro_torch.kernels.spmv import ops as spmv_ops
from repro_torch.kernels.spmv.kernel import spmv_ell

SPMV_SHAPES = [(256, 8, 512, 128), (512, 16, 1024, 256), (1024, 4, 256, 512),
               (256, 32, 2048, 64), (128, 1, 128, 128)]
FRONTIER_SHAPES = [(256, 8, 512, 128), (512, 16, 1024, 256),
                   (128, 4, 4096, 128), (1024, 2, 128, 512)]


def _spmv_inputs(n_rows, k, n_cols, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_cols, (n_rows, k)).astype(np.int32)
    val = rng.normal(size=(n_rows, k)).astype(np.float32)
    x = rng.normal(size=n_cols).astype(np.float32)
    return idx, val, x


def _frontier_inputs(n_rows, k, n_cols, seed=0):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n_cols, (n_rows, k), dtype=np.int32)
    bits = rng.integers(0, 2 ** 32, n_cols // 32, dtype=np.uint32)
    unv = rng.integers(0, 2, n_rows, dtype=np.int32)
    return nbr, bits, unv


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n_rows,k,n_cols,row_block", SPMV_SHAPES)
def test_spmv_shapes(n_rows, k, n_cols, row_block):
    idx, val, x = _spmv_inputs(n_rows, k, n_cols)
    want = np.asarray(ref_spmv_ell(jnp.asarray(idx), jnp.asarray(val),
                                   jnp.asarray(x), row_block=row_block,
                                   interpret=True))
    got = spmv_ops.spmv(_t(idx), _t(val), _t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmv_dtypes(dtype):
    idx, val, x = _spmv_inputs(256, 8, 512)
    val = jnp.asarray(val).astype(dtype)
    x = jnp.asarray(x).astype(dtype)
    want = np.asarray(ref_spmv_ell(jnp.asarray(idx), val.astype(jnp.float32),
                                   x, row_block=128, interpret=True))
    tx = _t(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dtype))
    tv = _t(np.asarray(val.astype(jnp.float32)))
    got = spmv_ops.spmv(_t(idx), tv, tx)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_spmv_padding_zero_val_ignored():
    idx = np.zeros((128, 4), np.int32)
    val = np.zeros((128, 4), np.float32)
    x = np.random.default_rng(0).normal(size=128).astype(np.float32)
    want = np.asarray(ref_spmv_ell(jnp.asarray(idx), jnp.asarray(val),
                                   jnp.asarray(x), row_block=128,
                                   interpret=True))
    got = spmv_ops.spmv(_t(idx), _t(val), _t(x))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), 0.0)


@pytest.mark.parametrize("batch", [1, 3])
def test_spmv_skip_form_equals_mask_val(batch):
    """``val=None, skip=s`` (the main path's form) is the Pallas kernel
    with ``val = (idx != s)``."""
    rng = np.random.default_rng(batch)
    n_cols, skip = 300, 299
    idx = rng.integers(0, n_cols, (batch, 256, 8)).astype(np.int32)
    idx[:, ::3, 5:] = skip
    x = rng.normal(size=(batch, n_cols)).astype(np.float32)
    got = spmv_ell(_t(idx), None, _t(x), skip=skip)
    for b in range(batch):
        want = np.asarray(ref_spmv_ell(
            jnp.asarray(idx[b]), jnp.asarray((idx[b] != skip)
                                             .astype(np.float32)),
            jnp.asarray(x[b]), row_block=128, interpret=True))
        np.testing.assert_allclose(got[b].numpy(), want, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("n_rows,k,n_cols,rb", FRONTIER_SHAPES)
def test_frontier_sweep(n_rows, k, n_cols, rb):
    nbr, bits, unv = _frontier_inputs(n_rows, k, n_cols)
    want = np.asarray(ref_bfs_pull(jnp.asarray(nbr), jnp.asarray(bits),
                                   jnp.asarray(unv), row_block=rb,
                                   interpret=True))
    got = frontier_ops.frontier_pull(_t(nbr), _t(bits.view(np.int32)),
                                     _t(unv))
    np.testing.assert_array_equal(got.numpy(), want)


def test_frontier_visited_rows_inf():
    nbr, bits, _ = _frontier_inputs(128, 4, 256)
    unv = np.zeros(128, np.int32)
    want = np.asarray(ref_bfs_pull(jnp.asarray(nbr), jnp.asarray(bits),
                                   jnp.asarray(unv), row_block=128,
                                   interpret=True))
    got = frontier_ops.frontier_pull(_t(nbr), _t(bits.view(np.int32)),
                                     _t(unv))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), INT_INF)


def test_frontier_min_parent_selection():
    bits = np.zeros(2, np.uint32)
    for v in (5, 9, 40, 63):
        bits[v // 32] |= np.uint32(1 << (v % 32))
    nbr = np.asarray([[40, 9, 5, 63]] * 128, np.int32)
    unv = np.ones(128, np.int32)
    want = np.asarray(ref_bfs_pull(jnp.asarray(nbr), jnp.asarray(bits),
                                   jnp.asarray(unv), row_block=128,
                                   interpret=True))
    got = frontier_ops.frontier_pull(_t(nbr), _t(bits.view(np.int32)),
                                     _t(unv))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), 5)


def test_wrappers_reject_bad_inputs():
    idx = torch.zeros((1, 128, 8), dtype=torch.int32)
    x = torch.zeros((1, 64))
    with pytest.raises(ValueError):
        spmv_ell(idx.long(), None, x, skip=0)
    with pytest.raises(ValueError):
        spmv_ell(idx, None, x)                       # neither val nor skip
    with pytest.raises(ValueError):
        spmv_ell(idx, torch.zeros((1, 128, 4)), x)   # val shape
    with pytest.raises(ValueError):
        spmv_ell(idx.transpose(1, 2), None, x, skip=0)   # slots strided
    with pytest.raises(ValueError):
        spmv_ell(idx, None, torch.zeros((2, 64)), skip=0)   # batch
    bits = torch.zeros((1, 3), dtype=torch.int32)
    unv = torch.ones((1, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        bfs_pull(idx, bits.float(), unv)
    with pytest.raises(ValueError):
        bfs_pull(idx, bits, unv.float())      # flags: bool, uint8 or int32
    for flags in (unv.bool(), unv.to(torch.uint8)):
        assert torch.equal(bfs_pull(idx, bits, flags),
                           bfs_pull(idx, bits, unv))
    with pytest.raises(ValueError):
        bfs_pull(idx[:, :0], bits, unv[:, :0])


@pytest.mark.parametrize("name", ["spmv_ell", "bfs_pull"])
@pytest.mark.parametrize("version", [None, 1, 3])
def test_bind_rejects_other_c_interfaces(name, version):
    """A library built from another checkout binds only if it reports
    this checkout's C interface; the first design reports none."""
    from types import SimpleNamespace
    from repro_torch.kernels.frontier import kernel as frontier_kernel
    from repro_torch.kernels.spmv import kernel as spmv_kernel
    mod = spmv_kernel if name == "spmv_ell" else frontier_kernel
    lib = SimpleNamespace(_name="parent", **{f"{name}_launch":
                                              SimpleNamespace()})
    if version is not None:
        setattr(lib, f"{name}_interface", lambda: version)
    with pytest.raises(RuntimeError, match="C interface"):
        mod.bind(lib)
    setattr(lib, f"{name}_interface", lambda: mod.INTERFACE)
    assert mod.bind(lib) is lib
    assert getattr(lib, f"{name}_launch").argtypes


@pytest.mark.parametrize("name", ["spmv_ell", "bfs_pull"])
def test_c_interface_version_matches_wrapper(name):
    """The version a kernel's C source reports is the one its wrapper
    binds."""
    import re
    from repro_torch.kernels import _build
    from repro_torch.kernels.frontier import kernel as frontier_kernel
    from repro_torch.kernels.spmv import kernel as spmv_kernel
    mod = spmv_kernel if name == "spmv_ell" else frontier_kernel
    src = _build.SOURCES[name].read_text()
    found = re.findall(rf"int {name}_interface\(\) {{ return (\d+); }}", src)
    assert found == [str(mod.INTERFACE)]
