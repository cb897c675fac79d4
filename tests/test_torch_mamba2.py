"""The port's Mamba2 SSD (``models/mamba2.py``): ports of
``test_mamba2.py``, and ``ssd_chunked``, ``mamba2_block`` and its decode
step against the reference's on the same inputs.

Tolerances.  The ports of ``test_mamba2.py`` keep that file's bounds.
Against the reference in f32: 1e-5 relative to the output's largest
magnitude (both sum the same f32 products in other orders; seen: below
1e-6); in bf16 (the model's dtype) 2^-7, two ulps (seen: equal bits for
mamba2's smoke widths, 2.5e-4 for zamba2's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as ref_smoke
from repro.models import mamba2 as REF
from repro.models.params import init_params as ref_init

from repro_torch.configs.registry import smoke_config
from repro_torch.models import mamba2 as M2
from repro_torch.models.params import init_params


def naive_ssd(x, dt, A, Bc, Cc, D):
    """Reference: literal recurrence h_t = exp(dt A) h_{t-1} + dt B x."""
    Bsz, S, H, P = x.shape
    G, N = Bc.shape[2], Bc.shape[3]
    rep = H // G
    h = np.zeros((Bsz, H, P, N))
    ys = np.zeros((Bsz, S, H, P))
    x, dt, A = (np.asarray(t, np.float64) for t in (x, dt, A))
    Bc, Cc, D = (np.asarray(t, np.float64) for t in (Bc, Cc, D))
    for t in range(S):
        for hh in range(H):
            g = hh // rep
            decay = np.exp(dt[:, t, hh] * A[hh])              # (B,)
            inp = (dt[:, t, hh, None, None]
                   * np.einsum("bn,bp->bpn", Bc[:, t, g], x[:, t, hh]))
            h[:, hh] = decay[:, None, None] * h[:, hh] + inp
            ys[:, t, hh] = np.einsum("bpn,bn->bp", h[:, hh], Cc[:, t, g]) \
                + D[hh] * x[:, t, hh]
    return ys, h


def _rand_inputs(seed, B=2, S=32, H=4, P=8, G=1, N=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0)     # softplus
    A = -np.exp(rng.standard_normal(H) * 0.3)
    Bc = rng.standard_normal((B, S, G, N)) * 0.3
    Cc = rng.standard_normal((B, S, G, N)) * 0.3
    D = np.ones(H)
    return tuple(torch.from_numpy(t.astype(np.float32))
                 for t in (x, dt, A, Bc, Cc, D))


# -- ports of tests/test_mamba2.py -------------------------------------------

def test_ssd_chunked_matches_naive_recurrence():
    x, dt, A, Bc, Cc, D = _rand_inputs(0)
    y, h = M2.ssd_chunked(x, dt, A, Bc, Cc, D, chunk=8)
    y_ref, h_ref = naive_ssd(x, dt, A, Bc, Cc, D)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(h.numpy(), h_ref, rtol=2e-3, atol=2e-3)


def test_ssd_chunk_size_invariance():
    x, dt, A, Bc, Cc, D = _rand_inputs(1)
    y8, h8 = M2.ssd_chunked(x, dt, A, Bc, Cc, D, chunk=8)
    y16, h16 = M2.ssd_chunked(x, dt, A, Bc, Cc, D, chunk=16)
    np.testing.assert_allclose(y8.numpy(), y16.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h8.numpy(), h16.numpy(), rtol=1e-4, atol=1e-4)


def test_ssd_initial_state_continuation():
    """Running [first half] then [second half with h0] == full run."""
    x, dt, A, Bc, Cc, D = _rand_inputs(2, S=32)
    y_full, h_full = M2.ssd_chunked(x, dt, A, Bc, Cc, D, chunk=8)
    y1, h1 = M2.ssd_chunked(x[:, :16], dt[:, :16], A, Bc[:, :16],
                            Cc[:, :16], D, chunk=8)
    y2, h2 = M2.ssd_chunked(x[:, 16:], dt[:, 16:], A, Bc[:, 16:],
                            Cc[:, 16:], D, chunk=8, h0=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), rtol=1e-3,
                               atol=1e-3)


def test_mamba_block_decode_matches_full_forward():
    cfg = smoke_config("mamba2-1.3b")
    p = init_params(M2.mamba2_spec(cfg), torch.Generator().manual_seed(0),
                    "cpu")
    B, S = 2, 16
    x = 0.1 * torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    y_full = M2.mamba2_block(p, x, cfg)
    state = M2.init_ssm_state(cfg, B, device="cpu")
    ys = []
    for t in range(S):
        yt, state = M2.mamba2_decode(p, x[:, t:t + 1], cfg, state)
        ys.append(yt)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), y_full.numpy(),
                               rtol=3e-2, atol=3e-3)


# -- against the reference ----------------------------------------------------

def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               rtol=0)


@pytest.mark.parametrize("chunk,with_h0", [(8, False), (8, True),
                                           (32, False), (32, True)])
def test_ssd_chunked_matches_reference(chunk, with_h0):
    """y and the final state, one chunk or several, from zero or from a
    carried state ``h0`` (a second half continuing the first)."""
    x, dt, A, Bc, Cc, D = _rand_inputs(3, G=2, H=4)
    h0 = None
    if with_h0:
        _, h0 = M2.ssd_chunked(x, dt, A, Bc, Cc, D, chunk=chunk)
    jin = [jnp.asarray(t.numpy()) for t in (x, dt, A, Bc, Cc, D)]
    ry, rh = REF.ssd_chunked(*jin, chunk=chunk,
                             h0=None if h0 is None else jnp.asarray(h0))
    y, h = M2.ssd_chunked(x, dt, A, Bc, Cc, D, chunk=chunk, h0=h0)
    assert h.dtype == torch.float32 and y.dtype == torch.float32
    _close(y, ry, 1e-5)
    _close(h, rh, 1e-5)


def test_ssd_chunked_rejects_a_partial_chunk():
    x, dt, A, Bc, Cc, D = _rand_inputs(4, S=24)
    with pytest.raises(ValueError, match="multiple"):
        M2.ssd_chunked(x, dt, A, Bc, Cc, D, chunk=16)


@pytest.mark.parametrize("name,dtype", [("mamba2-1.3b", "float32"),
                                        ("mamba2-1.3b", "bfloat16"),
                                        ("zamba2-7b", "bfloat16")])
def test_block_and_decode_match_reference(name, dtype):
    """mamba2_block over a two-chunk prompt (with its state), then three
    decode steps carrying (h, conv), against the reference's."""
    cfg, rcfg = smoke_config(name), ref_smoke(name)
    rp = ref_init(REF.mamba2_spec(rcfg), jax.random.key(0))
    p = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    xn = (0.5 * np.random.default_rng(5).standard_normal(
        (2, 2 * cfg.ssm_chunk + 3, cfg.d_model))).astype(np.float32)
    jx = jnp.asarray(xn).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(xn).to(getattr(torch, dtype))
    S = 2 * cfg.ssm_chunk
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    ry, (rh, rc) = REF.mamba2_block(rp, jx[:, :S], rcfg, return_state=True)
    y, (h, c) = M2.mamba2_block(p, tx[:, :S], cfg, return_state=True)
    assert y.dtype == tx.dtype and c.dtype == tx.dtype
    assert h.dtype == torch.float32
    assert tuple(c.shape) == (2, cfg.ssm_conv - 1,
                              cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state)
    _close(y, ry, tol)
    _close(h, rh, tol)
    _close(c, rc, tol)
    for t in range(S, S + 3):
        ry, (rh, rc) = REF.mamba2_decode(rp, jx[:, t:t + 1], rcfg, (rh, rc))
        y, (h, c) = M2.mamba2_decode(p, tx[:, t:t + 1], cfg, (h, c))
        _close(y, ry, tol)
        _close(h, rh, tol)


def test_init_ssm_state_shapes_and_card_default(monkeypatch):
    cfg = smoke_config("zamba2-7b")
    h, c = M2.init_ssm_state(cfg, 3, dtype=torch.bfloat16, device="cpu")
    rh, rc = REF.init_ssm_state(ref_smoke("zamba2-7b"), 3, jnp.bfloat16)
    assert tuple(h.shape) == rh.shape and h.dtype == torch.float32
    assert tuple(c.shape) == rc.shape and c.dtype == torch.bfloat16
    assert not h.any() and not c.any()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M2.init_ssm_state(cfg, 3)


def test_segsum_and_causal_conv_match_reference():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((2, 3, 8)).astype(np.float32)
    np.testing.assert_allclose(M2._segsum(torch.from_numpy(a)).numpy(),
                               np.asarray(REF._segsum(jnp.asarray(a))),
                               rtol=1e-6, atol=1e-6)
    x = rng.standard_normal((2, 10, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    np.testing.assert_allclose(
        M2._causal_conv(*(torch.from_numpy(t) for t in (x, w, b))).numpy(),
        np.asarray(REF._causal_conv(*(jnp.asarray(t) for t in (x, w, b)))),
        rtol=1e-6, atol=1e-6)
