"""The port's layers against the JAX package's on the same numpy-made
inputs and weights.  f32 paths agree within 1e-5 (relative, other
summation orders and libm); bf16 paths within one bf16 ulp of their
largest outputs (2e-2 for values up to 4, 8e-3 for the small attention
outputs), since both round to bf16 at the same points but add in other
orders."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke
from repro.models import layers as JL

from repro_torch.configs.registry import smoke_config
from repro_torch.models import layers as L


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pair(a, dtype="float32"):
    return jnp.asarray(a).astype(getattr(jnp, dtype)), \
        torch.from_numpy(a).to(getattr(torch, dtype))


def _params(tree_spec, rng, scale=0.3):
    """One numpy value per ParamSpec leaf of a (port) spec dict."""
    return {k: (rng.standard_normal(s.shape) * scale + (s.init == "ones"))
            .astype(np.float32) for k, s in tree_spec.items()}


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_norms_match(kind, dtype, tol):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 32)) * 3 + 1).astype(np.float32)
    p = _params(L.norm_spec(kind, 32), rng)
    jx, tx = _pair(x, dtype)
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jx, kind)
    got = L.apply_norm({k: torch.from_numpy(v) for k, v in p.items()}, tx,
                       kind)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("d,theta", [(16, 1e4), (120, 1e6)])
def test_rope_matches(dtype, tol, d, theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 3, d)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32) * 7
    jx, tx = _pair(x, dtype)
    want = JL.apply_rope(jx, jnp.asarray(pos), theta)
    got = L.apply_rope(tx, torch.from_numpy(pos), theta)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(L.rope_freqs(d, theta)),
                               _f32(JL.rope_freqs(d, theta)), rtol=1e-6)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 4), (False, 0),
                                           (False, 5)])
def test_attn_mask_matches(causal, window):
    qp, kp = np.arange(12), np.arange(3, 20)
    want = JL.attn_mask(jnp.asarray(qp), jnp.asarray(kp), causal=causal,
                        window=window)
    got = L.attn_mask(torch.from_numpy(qp), torch.from_numpy(kp),
                      causal=causal, window=window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 16, 0.0), (False, 0, 0.0), (True, 0, 20.0)])
def test_attention_naive_matches(causal, window, softcap):
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
               for _ in range(3))
    pos = np.arange(64)
    want = JL.attention_naive(*(jnp.asarray(a) for a in (q, k, v)),
                              q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos),
                              causal=causal, window=window, softcap=softcap)
    got = L.attention_naive(*(torch.from_numpy(a) for a in (q, k, v)),
                            q_pos=torch.from_numpy(pos),
                            k_pos=torch.from_numpy(pos), causal=causal,
                            window=window, softcap=softcap)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5)


def test_pick_chunk_and_repeat_kv():
    for s, t in [(64, 1024), (1024, 1024), (3000, 1024), (97, 32)]:
        assert L._pick_chunk(s, t) == JL._pick_chunk(s, t)
    k = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    np.testing.assert_array_equal(
        L.repeat_kv(torch.from_numpy(k), 2).numpy(),
        np.asarray(JL.repeat_kv(jnp.asarray(k), 2)))


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "qwen2.5-32b",
                                  "h2o-danube-3-4b", "gemma3-27b"])
@pytest.mark.parametrize("impl", ["chunked", "naive"])
def test_attention_block_matches(name, impl):
    """Projections, bias, RoPE, GQA and the attention core in bf16, as
    the model runs them; k/v come back unrepeated for the cache."""
    cfg = dataclasses.replace(smoke_config(name), attn_logit_softcap=(
        30.0 if name == "gemma3-27b" else 0.0))
    jcfg = dataclasses.replace(jax_smoke(name),
                               attn_logit_softcap=cfg.attn_logit_softcap)
    rng = np.random.default_rng(3)
    p = _params(L.attn_spec(cfg), rng, scale=0.1)
    x = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    window = cfg.sliding_window
    jx, tx = _pair(x, "bfloat16")
    want, (wk, wv) = JL.attention_block(
        {k: jnp.asarray(v) for k, v in p.items()}, jx, jcfg,
        positions=jnp.arange(48), window=window, impl=impl)
    got, (gk, gv) = L.attention_block(
        {k: torch.from_numpy(v) for k, v in p.items()}, tx, cfg,
        positions=torch.arange(48), window=window, impl=impl)
    assert got.dtype == torch.bfloat16 and tuple(gk.shape) == wk.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_f32(gk), _f32(wk), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_f32(gv), _f32(wv), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches(act):
    cfg = dataclasses.replace(smoke_config("tinyllama-1.1b"), act=act)
    jcfg = dataclasses.replace(jax_smoke("tinyllama-1.1b"), act=act)
    rng = np.random.default_rng(4)
    p = _params(L.mlp_spec(cfg), rng, scale=0.2)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, "bfloat16")
    want = JL.apply_mlp({k: jnp.asarray(v) for k, v in p.items()}, jx, jcfg)
    got = L.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()}, tx,
                      cfg)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2, rtol=2e-2)
