"""``repro_torch.distributed.compression`` against the JAX package's
``repro.distributed.compression``: ports of
``tests/test_substrate.py::test_compress_decompress_tree`` and
``::test_error_feedback_unbiased_over_time`` and of
``tests/test_property.py::test_int8_error_feedback_bounded``, and the
payloads, scales and residuals of both bit for bit on seeded trees (an
all-zero leaf, leaves at +-max, bf16 leaves, a carried residual)."""

import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.distributed import compression as ref
from repro_torch import tree
from repro_torch.distributed import compress_tree, decompress_tree, \
    dequantize_int8, init_ef_state, quantize_int8

SETTINGS = dict(max_examples=20, deadline=None)


def _bits(x) -> bytes:
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return a.dtype.str.encode() + a.tobytes()


def test_compress_decompress_tree():
    rng = np.random.default_rng(0)
    grads = {"w": torch.from_numpy(rng.normal(size=64).astype(np.float32)),
             "b": torch.from_numpy(
                 (rng.normal(size=8) * 10).astype(np.float32))}
    ef = init_ef_state(grads)
    assert all(float(e.abs().max()) == 0.0 for e in tree.leaves(ef))
    qs, scales, resid = compress_tree(grads, ef)
    deq = decompress_tree(qs, scales)
    for k in grads:
        assert qs[k].dtype == torch.int8 and scales[k].dtype == torch.float32
        err = float((deq[k] - grads[k]).abs().max())
        assert err <= float(scales[k]) * 0.5 + 1e-6
        assert torch.equal(resid[k], grads[k] - deq[k])


def test_error_feedback_unbiased_over_time():
    """With error feedback the accumulated transmitted signal tracks the
    true sum."""
    rng = np.random.default_rng(0)
    true_sum = torch.zeros(32)
    sent_sum = torch.zeros(32)
    ef = torch.zeros(32)
    for _ in range(50):
        g = torch.from_numpy(rng.normal(size=32).astype(np.float32))
        true_sum = true_sum + g
        q, s, ef = quantize_int8(g, ef)
        sent_sum = sent_sum + dequantize_int8(q, s)
    # the residual never accumulates beyond one quantization step
    gap = float((true_sum - sent_sum).abs().max())
    assert gap < 0.1, gap


@given(st.integers(0, 2 ** 16), st.floats(0.01, 100.0))
@settings(**SETTINGS)
def test_int8_error_feedback_bounded(seed, scale):
    """The quantization residual is bounded by half a step, and the
    dequantized payload plus the residual rebuilds the input."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=256).astype(np.float32)) * scale
    q, s, r = quantize_int8(x, torch.zeros_like(x))
    assert float(r.abs().max()) <= float(s) * 0.5 + 1e-6
    np.testing.assert_allclose((dequantize_int8(q, s) + r).numpy(),
                               x.numpy(), rtol=1e-5, atol=1e-5)


def _seeded_tree(seed: int):
    """A nested tree of float32 leaves across magnitudes,
    with an all-zero leaf and a leaf that holds +-max."""
    rng = np.random.default_rng(seed)

    def leaf(*shape, mag=1.0):
        return (rng.standard_normal(shape) * mag).astype(np.float32)

    peak = leaf(40)
    peak[3], peak[17] = np.float32(3.0e38), np.float32(-3.0e38)
    return {"embed": leaf(16, 24, mag=1e-3),
            "layers": [{"w": leaf(24, 24), "b": leaf(24, mag=30.0)},
                       {"w": leaf(24, 24, mag=1e-6), "b": np.zeros(
                           24, np.float32)}],
            "peak": peak, "norm": (leaf(7, mag=1e4), leaf(1))}


def _torch_tree(t):
    return tree.tree_map(lambda a: torch.from_numpy(a.copy()), t)


def test_bit_equal_to_reference_on_seeded_trees():
    """q, scale and the residual equal the reference's bits, leaf by leaf,
    over two steps (the second with the first step's residual carried),
    and so do the dequantized trees; a bf16 leaf quantizes as its
    float32 value, as the reference casts it."""
    for seed in (0, 1, 2):
        grads = _seeded_tree(seed)
        grads_t = _torch_tree(grads)
        flat, spec = tree.flatten(grads)
        ef_r = ref.init_ef_state(tree.unflatten(
            spec, [jnp.asarray(a) for a in flat]))
        ef_t = init_ef_state(grads_t)
        for step in range(2):
            g_r = tree.unflatten(spec, [jnp.asarray(a) for a in flat])
            q_r, s_r, ef_r = ref.compress_tree(g_r, ef_r)
            q_t, s_t, ef_t = compress_tree(grads_t, ef_t)
            for name, a, b in (("q", q_r, q_t), ("scale", s_r, s_t),
                               ("resid", ef_r, ef_t)):
                la, lb = tree.leaves(a), tree.leaves(b)
                assert len(la) == len(lb) == len(flat)
                for i, (x, y) in enumerate(zip(la, lb)):
                    assert _bits(x) == _bits(y), (seed, step, name, i)
            for x, y in zip(tree.leaves(ref.decompress_tree(q_r, s_r)),
                            tree.leaves(decompress_tree(q_t, s_t))):
                assert _bits(x) == _bits(y), (seed, step, "dequantized")
        assert not q_t["layers"][1]["b"].any()       # the all-zero leaf
        assert set(q_t["peak"][[3, 17]].tolist()) == {127, -127}
    bf = np.random.default_rng(9).standard_normal(50).astype(np.float32)
    bf_t = torch.from_numpy(bf).to(torch.bfloat16)
    bf_r = jnp.asarray(bf).astype(jnp.bfloat16)
    for x, y in zip(ref.quantize_int8(bf_r, jnp.zeros(50, jnp.float32)),
                    quantize_int8(bf_t, torch.zeros(50))):
        assert _bits(x) == _bits(y)
