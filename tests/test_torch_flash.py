"""The port's flash attention on the CPU against the JAX package's, case
for case with tests/test_kernels_flash.py: the port's plain version
(``ref.py``), its kernel adapter (``ops.flash_attention_kernel``, which
runs ``ref.py`` for CPU tensors) and its dispatch (``ops.flash_attention``,
the plain chunked forward for CPU tensors) against the Pallas kernel in
interpret mode, on the same numpy-made inputs.  Tolerances are those of
the reference tests: 2e-5 in f32 (the sums run in other orders), 2e-2
in bf16 (one bf16 ulp of outputs near 4 is 1.6e-2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_fwd as jax_fwd
from repro.kernels.flash_attention.ops import flash_attention as jax_ops
from repro.models.layers import attention_naive as jax_naive
from repro.models.layers import flash_attention_xla

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                      flash_attention_kernel)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models.layers import flash_attention_chunked


def _inputs(seed, shapes, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _port(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _jax(arrays, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _check_port(arrs, want, tol, dtype=torch.float32, **kw):
    """ref.py, and ops' two paths on (B=BH, S, H=1, D), against want."""
    q, k, v = _port(arrs, dtype)
    np.testing.assert_allclose(_f32(flash_attention_ref(q, k, v, **kw)),
                               want, atol=tol, rtol=tol)
    before = flash_attention_fwd.launches
    np.testing.assert_allclose(_f32(flash_attention_fwd(q, k, v, **kw)),
                               want, atol=tol, rtol=tol)
    assert flash_attention_fwd.launches == before     # no kernel on CPU
    q4, k4, v4 = (t[:, :, None, :] for t in (q, k, v))
    for fn in (flash_attention, flash_attention_kernel):
        np.testing.assert_allclose(_f32(fn(q4, k4, v4, **kw)[:, :, 0]),
                                   want, atol=tol, rtol=tol)


@pytest.mark.parametrize("bh,s,d,bq,bk", [
    (2, 256, 128, 128, 128), (4, 512, 128, 256, 128), (1, 128, 256, 64, 64),
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_flash_sweep_matches_pallas(bh, s, d, bq, bk, causal, window):
    arrs = _inputs(s + d, [(bh, s, d)] * 3)
    want = _f32(jax_fwd(*_jax(arrs), causal=causal, window=window,
                        block_q=bq, block_k=bk, interpret=True))
    _check_port(arrs, want, 2e-5, causal=causal, window=window)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_flash_dtypes_match_pallas(dtype, tol):
    arrs = _inputs(7, [(2, 256, 128)] * 3)
    want = _f32(jax_fwd(*_jax(arrs, getattr(jnp, dtype)), causal=True,
                        interpret=True))
    _check_port(arrs, want, tol, getattr(torch, dtype), causal=True)


def test_flash_cross_lengths_match_pallas():
    """Sq != Sk (cross-attention shape)."""
    arrs = _inputs(8, [(2, 128, 128), (2, 512, 128), (2, 512, 128)])
    want = _f32(jax_fwd(*_jax(arrs), causal=False, interpret=True))
    _check_port(arrs, want, 2e-5, causal=False)


def test_flash_softcap_matches_pallas():
    arrs = _inputs(9, [(1, 128, 128)] * 3)
    want = _f32(jax_fwd(*_jax(arrs), causal=True, softcap=20.0,
                        interpret=True))
    _check_port(arrs, want, 2e-5, causal=True, softcap=20.0)


def test_head_dim_120_matches_padded_reference():
    """danube3's head_dim 120: the reference pads to 128 and rescales q;
    the port takes D = 120 as it is and must give the same answer."""
    arrs = _inputs(10, [(2, 128, 4, 120)] * 3)
    want = _f32(jax_ops(*_jax(arrs), causal=True, force_kernel=True,
                        interpret=True))
    naive = _f32(jax_naive(*_jax(arrs), q_pos=jnp.arange(128),
                           k_pos=jnp.arange(128), causal=True, window=0))
    np.testing.assert_allclose(want, naive, atol=5e-5)
    q, k, v = _port(arrs)
    for fn in (flash_attention, flash_attention_kernel):
        np.testing.assert_allclose(_f32(fn(q, k, v, causal=True)), want,
                                   atol=5e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 16, 0.0), (False, 0, 0.0), (True, 0, 20.0)])
def test_chunked_forward_matches_xla(dtype, causal, window, softcap):
    """The plain chunked forward against ``flash_attention_xla`` with
    several q and kv chunks, so the bf16 accumulator (kept in v's dtype
    by both) is exercised: f32 within 2e-5; bf16 within 2e-2."""
    arrs = _inputs(11, [(2, 64, 2, 16)] * 3)
    want = _f32(flash_attention_xla(*_jax(arrs, getattr(jnp, dtype)),
                                    causal, window, softcap, 32, 16))
    got = flash_attention_chunked(*_port(arrs, getattr(torch, dtype)),
                                  causal=causal, window=window,
                                  softcap=softcap, q_chunk=32, kv_chunk=16)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_f32(got), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("d", [120, 136])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_flash_unpadded_head_dims_match_pallas(d, causal, window):
    """S = 200 (not a multiple of the CUDA kernel's 128-row q tile or its
    k tiles) at D = 120 and 136, which the bf16 CUDA kernel pads to 128
    and 256 columns: ref.py and ops against the Pallas kernel, one block
    of 200 rows and keys."""
    arrs = _inputs(d + window, [(2, 200, d)] * 3)
    want = _f32(jax_fwd(*_jax(arrs), causal=causal, window=window,
                        block_q=200, block_k=200, interpret=True))
    _check_port(arrs, want, 2e-5, causal=causal, window=window)


def test_wrapper_counts_both_designs():
    """The wrapper keeps a count of all launches and one of the bf16
    tensor-core design's; CPU tensors launch nothing."""
    assert isinstance(flash_attention_fwd.launches, int)
    assert isinstance(flash_attention_fwd.launches_tc, int)
    before = (flash_attention_fwd.launches, flash_attention_fwd.launches_tc)
    q = torch.zeros((1, 16, 8), dtype=torch.bfloat16)
    flash_attention_fwd(q, q, q)
    assert (flash_attention_fwd.launches,
            flash_attention_fwd.launches_tc) == before


@pytest.mark.parametrize("shapes,dtype,match", [
    ([(2, 16, 12)] * 3, torch.float32, "multiple of 8"),
    ([(2, 16, 264)] * 3, torch.float32, "multiple of 8"),
    ([(2, 16, 16)] * 3, torch.float16, "dtype"),
    ([(2, 16, 16), (3, 16, 16), (3, 16, 16)], torch.float32, "k and v"),
    ([(2, 16, 16), (2, 8, 16), (2, 9, 16)], torch.float32, "k and v"),
    ([(2, 16, 16, 1)] * 3, torch.float32, "BH, S, D"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(shapes, dtype, match):
    q, k, v = (torch.zeros(s, dtype=dtype) for s in shapes)
    with pytest.raises(ValueError, match=match):
        flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((2, 16, 32))[:, :, :16]
        flash_attention_fwd(t, t, t)
