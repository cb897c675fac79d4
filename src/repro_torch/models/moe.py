"""Mixture-of-Experts layer: top-k routing with GShard einsum dispatch.

Tokens are grouped (``group_size`` a group, or one group a batch row
when the sequence does not divide); per-group capacity bounds the
dispatch tensors, and a token past its expert's capacity is dropped.
The one-hot dispatch / combine einsums run in the reference's order,
with its grouping and its aux dict (Switch Transformer's load-balance
and router z-losses, and the dropped share).  The experts run as
batched GEMMs over the expert axis; no kernel is hand-written for them,
as the reference has no ``pallas_call`` here.

On DTensors (a sharded step) each rank groups and routes its own tokens
(a group never crosses a shard boundary: where it would, the sequence
is made whole first), and the aux dict's means are summed over every
rank's groups.  The expert weights stay as they rest, experts over
"model" and their ffn dim over "data" (``moe_spec``): the dispatched
tokens move to them instead, and the experts' partial sums over their
ffn shards are reduced on the way back, so no expert weight is ever
all-gathered (the reference's layout, ``src/repro/models/moe.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import actctx as A
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


# a MoE block's expert weights: never all-gathered (see the module
# docstring)
EXPERT_LEAVES = ("wi", "wg", "wo")


def _experts(p, xin):
    """The expert FFN on dispatched tokens xin (E, G, C, d), batched over
    the expert axis: (E, G, C, d)."""
    h = torch.einsum("ebcd,edf->ebcf", xin, p["wi"].to(xin.dtype))
    if "wg" in p:
        g = torch.einsum("ebcd,edf->ebcf", xin, p["wg"].to(xin.dtype))
        h = silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return torch.einsum("ebcf,efd->ebcd", h, p["wo"].to(xin.dtype))


def apply_moe(p, x, cfg, *, capacity_factor=None, group_size=256):
    """x: (B, S, d) -> (B, S, d), aux dict.

    Top-k gating with per-expert capacity over groups of
    ``group_size`` tokens; overflow tokens drop (GShard semantics).  At
    decode (S = 1) each token is its own group and the capacity is 1.
    On a DTensor ``x`` see :func:`_apply_moe_sharded`."""
    if A.is_dtensor(x):
        return _apply_moe_sharded(p, x, cfg, capacity_factor, group_size)
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
    out_e = _experts(p, xin)
    y = torch.einsum("ebcd,bsec->bsd", out_e, combine.to(x.dtype))
    return y.reshape(B0, S0, d), aux


def _apply_moe_sharded(p, x, cfg, capacity_factor, group_size):
    """:func:`apply_moe` on a DTensor ``x``: each rank groups its own
    tokens (the batch and sequence shards it holds; the sequence made
    whole where a group would cross a shard boundary) into the groups
    the one-device run forms (``group_size`` tokens of one row, or a
    whole row when the sequence does not divide), ranks that hold the
    same tokens share their groups out (``actctx.spread``), and each
    routes its groups with the router whole.  The aux dict's sums run
    over every rank's groups.  The experts run where their weights rest
    (:func:`_sharded_experts`), and the combined outputs go back to the
    ranks that hold their tokens.  Returns y laid out as x's tokens and
    the aux dict as replicated DTensors."""
    from torch.distributed.tensor import Shard
    B0, S0, d = x.shape
    gs = min(group_size, S0)
    if S0 % gs:
        gs = S0                                   # one group a batch row
    mesh = x.device_mesh
    layout = A.token_layout(x, dims=(0, 1))
    if (S0 // A.splits(layout, mesh, 1)) % gs:
        layout = A.token_layout(x, dims=(0,))
    xl = A.local_tokens(x, layout)                                 # (b,s,d)
    b, s, _ = xl.shape
    held = tuple(Shard(0) if q.is_shard() else q for q in layout)
    grouped = A.spread(held, mesh, b * (s // gs))
    xg = A.local_tokens(A.from_tokens(xl.reshape(b * (s // gs), gs, d), x,
                                      held), grouped)
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    C = _capacity(gs, E, K, capacity_factor or cfg.capacity_factor)
    r = route(A.whole(p["router"], grouped), xg, E, K, C)
    dispatch = r["dispatch"]

    # the aux dict's means: this rank's sums, summed over every rank's
    sums = torch.cat([
        r["probs"].sum(dim=(0, 1)), r["onehot"].sum(dim=2).sum(dim=(0, 1)),
        (torch.logsumexp(r["logits"], dim=-1) ** 2).sum()[None],
        dispatch.sum()[None]])
    tot = A.token_sum(sums, x, grouped) / (B0 * S0)
    me, ce = tot[:E], tot[E:2 * E]
    aux = {"moe_lb_loss": E * torch.sum(me * ce / K),
           "moe_z_loss": tot[2 * E], "moe_drop_frac": 1.0 - tot[2 * E + 1] / K}

    gate_w = torch.einsum("bske,bsk->bse", r["onehot"], r["gate_vals"])
    combine = dispatch * gate_w[..., None]
    xin = torch.einsum("bsec,bsd->ebcd", dispatch.to(xg.dtype), xg)
    out_e = _sharded_experts(p, xin, x, grouped)
    y = torch.einsum("ebcd,bsec->bsd", out_e, combine.to(xg.dtype))
    y = A.local_tokens(A.from_tokens(y, x, grouped), held)
    return A.from_tokens(y.reshape(b, s, d), x, layout), aux


def _sharded_experts(p, xin, like, layout):
    """The experts on this rank's dispatched tokens ``xin`` (E, g, C,
    d), its groups split over the ranks as ``layout`` splits dim 0,
    with the expert weights as they rest.  On each mesh dim the tokens
    meet the weights' shards: where the experts are split, each group's
    tokens go to their expert's rank and its outputs come back (an
    all-to-all each way, ``actctx.relayout``); where the
    experts' ffn dim is split, every rank takes every token (an
    all-gather) and its ffn shard's partial sums are reduce-scattered
    back; where the weights are whole, each rank keeps its own groups.
    Returns the experts' outputs for this rank's groups."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = like.device_mesh
    groups = [Shard(1) if q.is_shard() else Replicate() for q in layout]
    wpl = p["wi"].placements
    tin = [Shard(0) if w.is_shard(0) else Replicate() if w.is_shard(2)
           else g for w, g in zip(wpl, groups)]
    tout = [Partial() if w.is_shard(2) else t for w, t in zip(wpl, tin)]
    # where the ffn dim is split, each rank's gradient of its tokens is
    # its ffn shard's share
    xd = A.local_tokens(A.from_tokens(xin, like, groups), tin, tout)

    def local(w):
        # a weight's gradient: its own shard's where split, else a
        # partial sum over the ranks whose groups differ
        return w.to_local(grad_placements=[
            q if q.is_shard() else Partial() if g.is_shard() else Replicate()
            for q, g in zip(w.placements, tin)])

    out = _experts({k: local(p[k]) for k in EXPERT_LEAVES if k in p}, xd)
    return A.local_tokens(A.from_tokens(out, like, tout), groups)
