"""The port's MoE layer (``models/moe.py``): ports of ``test_moe.py``,
and ``apply_moe`` against the reference's on the same weights and input.

Tolerances.  In f32 both packages route on the same f32 logits, so the
choices, the capacity drops and the aux's discrete parts are equal; the
outputs differ only in the einsums' summation order: 1e-5 relative to
the output's largest magnitude (seen: 3.6e-7), aux losses 1e-6
relative (seen: 1.2e-7).  In bf16 (the model's dtype) the experts'
products round to bf16: 2^-7 of the largest magnitude, two ulps (seen:
equal bits).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as ref_smoke
from repro.models import moe as REF
from repro.models.params import init_params as ref_init

from repro_torch.configs.registry import smoke_config
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.params import init_params


def _cfg(name="dbrx-132b", **kw):
    return dataclasses.replace(smoke_config(name), **kw)


def _params(cfg, seed=0):
    return init_params(MOE.moe_spec(cfg), torch.Generator().manual_seed(seed),
                       "cpu")


def _x(shape, scale=0.1, seed=1):
    return torch.from_numpy((scale * np.random.default_rng(seed)
                             .standard_normal(shape)).astype(np.float32))


# -- ports of tests/test_moe.py ---------------------------------------------

def test_single_expert_topk1_equals_dense_mlp():
    cfg = _cfg(num_experts=1, num_experts_per_tok=1, capacity_factor=4.0)
    p = _params(cfg)
    x = _x((2, 16, cfg.d_model))
    y, aux = MOE.apply_moe(p, x, cfg)
    dense_p = {"wi": p["wi"][0], "wg": p["wg"][0], "wo": p["wo"][0]}
    y_ref = L.apply_mlp(dense_p, x, cfg)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=1e-5)
    assert float(aux["moe_drop_frac"]) < 1e-6


def test_capacity_drops_overflow_tokens():
    # force capacity 1 with many tokens -> most tokens dropped
    cfg = _cfg(num_experts=2, num_experts_per_tok=1, capacity_factor=1e-6)
    p = _params(cfg)
    x = _x((1, 32, cfg.d_model), scale=1.0)
    y, aux = MOE.apply_moe(p, x, cfg, group_size=32)
    assert float(aux["moe_drop_frac"]) > 0.8


def test_lb_loss_minimal_when_balanced():
    cfg = _cfg(num_experts=4, num_experts_per_tok=1)
    E = cfg.num_experts
    # perfectly balanced probs -> lb_loss == 1.0 (its minimum)
    probs = torch.full((8, E), 1.0 / E)
    me = probs.mean(dim=0)
    ce = torch.full((E,), 1.0 / E)
    lb = E * torch.sum(me * ce)
    assert abs(float(lb) - 1.0) < 1e-6


def test_moe_grads_flow_to_all_parts():
    cfg = _cfg(num_experts=4, num_experts_per_tok=2, capacity_factor=2.0)
    p = {k: v.requires_grad_(True) for k, v in _params(cfg).items()}
    x = _x((2, 16, cfg.d_model))
    y, aux = MOE.apply_moe(p, x, cfg)
    loss = (y ** 2).mean() + 0.01 * aux["moe_lb_loss"]
    grads = torch.autograd.grad(loss, list(p.values()))
    for k, g in zip(p, grads):
        assert float(g.abs().max()) > 0, f"zero grad for {k}"


# -- against the reference ----------------------------------------------------

# (arch, x shape, group_size, capacity_factor, dtype): groups of 256 split
# from the sequence, the S % gs fallback (one group a row), a decode step
# (S = 1: capacity 1), a capacity that drops tokens, and bf16
REF_CASES = (
    ("dbrx-132b", (2, 512, 64), 256, None, "float32"),
    ("phi3.5-moe-42b-a6.6b", (2, 40, 64), 16, None, "float32"),
    ("phi3.5-moe-42b-a6.6b", (4, 1, 64), 256, None, "float32"),
    ("dbrx-132b", (2, 64, 64), 256, 0.5, "float32"),
    ("phi3.5-moe-42b-a6.6b", (2, 64, 64), 256, 0.5, "bfloat16"),
)


@pytest.mark.parametrize("name,shape,gs,cf,dtype", REF_CASES)
def test_apply_moe_matches_reference(name, shape, gs, cf, dtype):
    cfg, rcfg = smoke_config(name), ref_smoke(name)
    rp = ref_init(REF.moe_spec(rcfg), jax.random.key(0))
    p = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    xn = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(xn).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(xn).to(getattr(torch, dtype))
    ry, raux = REF.apply_moe(rp, jx, rcfg, capacity_factor=cf,
                             group_size=gs)
    y, aux = MOE.apply_moe(p, tx, cfg, capacity_factor=cf, group_size=gs)
    assert y.dtype == tx.dtype and tuple(y.shape) == shape
    ry = np.asarray(ry, np.float32)
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(y.float().numpy(), ry,
                               atol=tol * np.abs(ry).max(), rtol=0)
    assert sorted(aux) == sorted(raux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(raux[k]), rtol=1e-6,
                                   atol=1e-7)
    if cf is not None:
        assert float(aux["moe_drop_frac"]) > 0.05, "no token dropped"


def test_route_drops_past_capacity_as_the_reference():
    """Which (token, k) choices fit: the first C of each expert's queue,
    tokens in order and k = 0 before k = 1, the rest dropped; the dropped
    share of aux is one minus the kept share."""
    cfg = _cfg("phi3.5-moe-42b-a6.6b")
    p = _params(cfg)
    x = _x((1, 32, cfg.d_model), scale=1.0)
    E, K, C = cfg.num_experts, cfg.num_experts_per_tok, 3
    r = MOE.route(p["router"], x, E, K, C)
    idx, kept = r["gate_idx"][0], r["kept"][0]
    seen = [0] * E
    for s in range(32):
        for k in range(K):
            e = int(idx[s, k])
            assert float(kept[s, k]) == float(seen[e] < C)
            seen[e] += 1
    assert bool((r["gate_vals"][..., 0] >= r["gate_vals"][..., 1]).all())
    _, aux = MOE.apply_moe(p, x, cfg, capacity_factor=C * E / (32 * K))
    np.testing.assert_allclose(float(aux["moe_drop_frac"]),
                               1 - float(kept.mean()), rtol=1e-6)


def test_one_hot_zero_row_past_n_as_jax():
    """jax.nn.one_hot of a float index at or past n is a row of zeros
    (how capacity overflow drops); torch's one_hot would raise."""
    idx = np.array([[0.0, 2.0, 3.0, 7.0]], np.float32)
    got = MOE._one_hot(torch.from_numpy(idx), 3)
    want = np.asarray(jax.nn.one_hot(jnp.asarray(idx), 3))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32


def test_capacity_as_reference():
    for s, e, k, f in ((256, 16, 2, 1.25), (1, 16, 2, 1.25), (40, 4, 2, 1.25),
                       (32, 2, 1, 1e-6)):
        assert MOE._capacity(s, e, k, f) == REF._capacity(s, e, k, f)


def test_route_replays_given_choices():
    """``choices`` equal to the top-k give the same routing bit for bit;
    other choices take their own probabilities as gates and queue in
    their order."""
    cfg = _cfg("phi3.5-moe-42b-a6.6b")
    p = _params(cfg)
    x = _x((2, 16, cfg.d_model), scale=1.0)
    E, K, C = cfg.num_experts, cfg.num_experts_per_tok, 5
    r = MOE.route(p["router"], x, E, K, C)
    again = MOE.route(p["router"], x, E, K, C, choices=r["gate_idx"])
    for k in r:
        assert torch.equal(r[k], again[k]), k
    flipped = r["gate_idx"].flip(-1)
    f = MOE.route(p["router"], x, E, K, C, choices=flipped)
    assert torch.equal(f["gate_idx"], flipped)
    want = torch.gather(r["probs"], -1, flipped)
    torch.testing.assert_close(f["gate_vals"],
                               want / want.sum(-1, keepdim=True))
