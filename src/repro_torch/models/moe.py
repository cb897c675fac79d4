"""Mixture-of-Experts layer: top-k routing with GShard einsum dispatch.

Tokens are grouped (``group_size`` a group, or one group a batch row
when the sequence does not divide); per-group capacity bounds the
dispatch tensors, and a token past its expert's capacity is dropped.
The one-hot dispatch / combine einsums run in the reference's order,
with its grouping and its aux dict (Switch Transformer's load-balance
and router z-losses, and the dropped share).  The experts run as
batched GEMMs over the expert axis; no kernel is hand-written for them,
as the reference has no ``pallas_call`` here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import silu
from repro_torch.models.params import spec


def moe_spec(cfg):
    """Router (d, E), expert weights (E, d, f) and (E, f, d), plus the
    gate projection under swiglu."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": spec((d, e), ("embed", "experts"), scale=0.02),
        "wi": spec((e, d, f), ("experts", None, "moe_ffn")),
        "wo": spec((e, f, d), ("experts", "moe_ffn", None),
                   scale=0.02 / max(1, cfg.num_layers) ** 0.5),
    }
    if cfg.act == "swiglu":
        p["wg"] = spec((e, d, f), ("experts", None, "moe_ffn"))
    return p


def _capacity(tokens_per_group: int, num_experts: int, k: int,
              factor: float) -> int:
    c = int(tokens_per_group * k * factor / num_experts)
    return max(c, 1)


def _one_hot(idx, n: int):
    """``jax.nn.one_hot``: an f32 row with a 1 where ``idx`` equals the
    column, so an index at or past ``n`` (a float one too) gives a row
    of zeros.  ``torch.nn.functional.one_hot`` raises there instead; the
    zero row is how a token over capacity drops."""
    return (idx[..., None] == torch.arange(n, device=idx.device,
                                           dtype=idx.dtype)).float()


def group_tokens(x, group_size: int = 256):
    """(B, S, d) -> (G, gs, d): ``group_size`` tokens a group, or the
    input as it is (one group a batch row) when S does not divide."""
    B0, S0, d = x.shape
    gs = min(group_size, S0)
    if S0 % gs == 0:
        x = x.reshape(B0 * (S0 // gs), gs, d)
    return x


def route(router, x, E: int, K: int, C: int, choices=None) -> dict:
    """The router on grouped tokens x (G, S, d): f32 logits and
    probabilities, the top-``K`` gates (descending, as ``lax.top_k``)
    renormalised, the one-hot choices (G, S, K, E), which (token, k)
    choices fit under capacity ``C`` (``kept``, (G, S, K)) and the 0/1
    dispatch tensor (G, S, E, C).  ``choices`` (G, S, K), if given, are
    taken for the top-k experts, with their own probabilities as gates:
    a check replays one run's routing in another with it."""
    B, S, _ = x.shape
    logits = torch.einsum("bsd,de->bse", x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)                        # (B,S,E)
    if choices is None:
        gate_vals, gate_idx = torch.topk(probs, K, dim=-1, sorted=True)
    else:
        gate_idx = choices.long()
        gate_vals = torch.gather(probs, -1, gate_idx)
    # renormalize selected gates (mixtral/dbrx convention)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True),
                                        min=1e-9)
    onehot = F.one_hot(gate_idx, E).float()                      # (B,S,K,E)
    # priority: earlier tokens first, k=0 before k=1 (flatten S,K)
    flat = onehot.reshape(B, S * K, E)
    pos_in_expert = torch.cumsum(flat, dim=1) - flat             # (B,S*K,E)
    flat = flat * (pos_in_expert < C)
    slot = torch.einsum("bte,btec->btec", flat, _one_hot(pos_in_expert, C))
    dispatch = slot.reshape(B, S, K, E, C).sum(dim=2)            # (B,S,E,C)
    return {"logits": logits, "probs": probs, "gate_vals": gate_vals,
            "gate_idx": gate_idx, "onehot": onehot, "dispatch": dispatch,
            "kept": flat.reshape(B, S, K, E).sum(dim=-1)}


def apply_moe(p, x, cfg, *, capacity_factor=None, group_size=256):
    """x: (B, S, d) -> (B, S, d), aux dict.

    Top-k gating with per-expert capacity over groups of
    ``group_size`` tokens; overflow tokens drop (GShard semantics).  At
    decode (S = 1) each token is its own group and the capacity is 1."""
    B0, S0, d = x.shape
    x = group_tokens(x, group_size)
    B, S, _ = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    C = _capacity(S, E, K, capacity_factor or cfg.capacity_factor)
    r = route(p["router"], x, E, K, C)
    dispatch = r["dispatch"]

    # --- aux losses (fp32), before the experts: a layer's remat
    # recompute then ends at the combine einsum's saved inputs and skips
    # its product, which the backward does not need (JAX's remat drops
    # it too) ---
    # load-balance: E * sum_e mean_prob_e * frac_tokens_e (Switch eq. 4)
    me = r["probs"].mean(dim=(0, 1))                              # (E,)
    ce = r["onehot"].sum(dim=2).mean(dim=(0, 1))                  # (E,)
    lb_loss = E * torch.sum(me * ce / K)
    z_loss = torch.mean(torch.logsumexp(r["logits"], dim=-1) ** 2)
    dropped = 1.0 - dispatch.sum(dim=(2, 3)).mean() / K
    aux = {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss,
           "moe_drop_frac": dropped}

    gate_w = torch.einsum("bske,bsk->bse", r["onehot"], r["gate_vals"])
    combine = dispatch * gate_w[..., None]                        # (B,S,E,C)

    xin = torch.einsum("bsec,bsd->ebcd", dispatch.to(x.dtype), x)  # (E,B,C,d)
    h = torch.einsum("ebcd,edf->ebcf", xin, p["wi"].to(x.dtype))
    if "wg" in p:
        g = torch.einsum("ebcd,edf->ebcf", xin, p["wg"].to(x.dtype))
        h = silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    out_e = torch.einsum("ebcf,efd->ebcd", h, p["wo"].to(x.dtype))
    y = torch.einsum("ebcd,bsec->bsd", out_e, combine.to(x.dtype))
    return y.reshape(B0, S0, d), aux
