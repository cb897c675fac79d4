"""Core neural layers: norms, RoPE, GQA attention (full / sliding-window /
local-global), and MLPs.

Attention has three implementations:
  * ``naive``   -- materializes (Sq, Sk) scores; oracle for tests.
  * ``chunked`` -- ``kernels.flash_attention.ops.flash_attention``: the
                   Hopper kernel on CUDA tensors, the plain chunked
                   online-softmax forward below on CPU tensors.  When
                   q, k or v needs a gradient it goes through
                   :class:`FlashAttention` (the same forward, plus the
                   reference's blockwise backward).
  * ``plain``   -- the chunked forward in plain torch on any device,
                   with the same backward: what training through the
                   kernel is held against on the card.

Parameters are dicts of tensors (an ``nn.ParameterDict`` in the model).
Every function keeps the reference's layouts and its cast points.

Under a sharding policy (``distributed/actctx.py``) the tensors are
DTensors: ``constrain`` pins q, k, v and the attention output to the
"heads" layout and the MLP's hidden activations to "ffn", at the
reference's sites, and attention runs on each rank's own (batch, heads)
slice (``actctx.per_shard``), which needs no collective: on a card each
rank launches the kernel on its ``(B/d * H/m, S, D)`` slice.  Where the
reference lets GSPMD reshard, the port says so: a block's input is
pinned to the "batch" layout (the sequence whole) before its
projections.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import actctx as A
from repro_torch.kernels.flash_attention.ops import flash_attention, \
    flash_attention_kernel
from repro_torch.models.params import spec

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm_spec(d):
    return {"scale": spec((d,), (None,), init="ones")}


def layernorm_spec(d):
    return {"scale": spec((d,), (None,), init="ones"),
            "bias": spec((d,), (None,), init="zeros")}


def norm_spec(kind, d):
    return rmsnorm_spec(d) if kind == "rmsnorm" else layernorm_spec(d)


def apply_norm(p, x, kind="rmsnorm", eps=1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"]
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x (B, S, H..., D), D even; positions (S,) or (B, S)."""
    d = x.shape[-1]
    d2 = d // 2
    freqs = rope_freqs(d, theta, x.device)                  # (d2,)
    ang = positions[..., None].float() * freqs              # (..., S, d2)
    # broadcast angles over any head dims between S and D
    for _ in range(x.dim() - ang.dim() - 1):
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :d2], x[..., d2:2 * d2]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    return torch.cat([xr1, xr2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Masking
# ---------------------------------------------------------------------------
def attn_mask(q_pos, k_pos, *, causal: bool, window: int):
    """Boolean (..., Sq, Sk) mask; True = attend."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                   dtype=torch.bool, device=qp.device)
    if causal:
        m &= kp <= qp
    if window > 0:
        m &= kp > qp - window
    return m


# ---------------------------------------------------------------------------
# Attention implementations
# ---------------------------------------------------------------------------
def _scores_softcap(s, softcap):
    if softcap and softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    return s


def attention_naive(q, k, v, *, q_pos, k_pos, causal, window, softcap=0.0):
    """q/k/v: (B, S, H, D), kv heads pre-repeated -> (B, Sq, H, D)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = _scores_softcap(s, softcap)
    mask = attn_mask(q_pos, k_pos, causal=causal, window=window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _pick_chunk(s: int, target: int) -> int:
    """Largest divisor of s that is <= target (falls back to s)."""
    if s <= target:
        return s
    for c in range(target, 0, -1):
        if s % c == 0:
            return c
    return s


def _flash_fwd_impl(q, k, v, *, causal, window, softcap, q_chunk=1024,
                    kv_chunk=1024):
    """Plain chunked online-softmax forward, the reference's
    ``_flash_fwd_impl``: q/k/v (B, S, H, D) -> out (B, Sq, H, D) and the
    f32 log-sum-exp (B, H, Sq) that the backward keeps.  As there, the
    accumulator is kept in v's dtype (bf16 in the model).  The CUDA
    kernel keeps it in f32 and adds each tile's p @ v to it unrounded;
    the Pallas kernel keeps an f32 accumulator too, but rounds each
    tile's bf16 p @ v to bf16 before adding it."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    qc = _pick_chunk(Sq, q_chunk)
    kc = _pick_chunk(Sk, kv_chunk)
    scale = D ** -0.5
    outs, lses = [], []
    for qi in range(Sq // qc):
        qcb = q[:, qi * qc:(qi + 1) * qc]
        qp = qi * qc + torch.arange(qc, device=q.device)
        m = torch.full((B, H, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, qc, D), dtype=v.dtype, device=q.device)
        for ki in range(Sk // kc):
            kcb = k[:, ki * kc:(ki + 1) * kc]
            vcb = v[:, ki * kc:(ki + 1) * kc]
            s = torch.einsum("bqhd,bkhd->bhqk", qcb.float(),
                             kcb.float()) * scale
            s = _scores_softcap(s, softcap)
            kp = ki * kc + torch.arange(kc, device=q.device)
            s = torch.where(attn_mask(qp, kp, causal=causal, window=window),
                            s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhqk,bkhd->bhqd", p.to(vcb.dtype), vcb)
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m = m_new
        lmax = torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
        outs.append((acc / lmax).transpose(1, 2))
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def flash_attention_chunked(q, k, v, *, causal, window, softcap,
                            q_chunk=1024, kv_chunk=1024):
    """The plain chunked forward's output alone (the serving path's CPU
    route).  q/k/v (B, S, H, D) -> (B, Sq, H, D)."""
    return _flash_fwd_impl(q, k, v, causal=causal, window=window,
                           softcap=softcap, q_chunk=q_chunk,
                           kv_chunk=kv_chunk)[0]


def _flash_bwd_impl(q, k, v, out, lse, do, *, causal, window, softcap,
                    q_chunk=1024, kv_chunk=1024):
    """The reference's ``_flash_bwd_impl`` in plain torch: probabilities
    recomputed block by block from ``lse``, dq by q block (kv blocks
    inside), then dk and dv by kv block (q blocks inside), in f32.
    Returns dq, dk, dv in the dtypes of q, k, v."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    qc = _pick_chunk(Sq, q_chunk)
    kc = _pick_chunk(Sk, kv_chunk)
    nq, nk = Sq // qc, Sk // kc
    scale = D ** -0.5
    f32 = torch.float32
    dev = q.device

    delta = torch.einsum("bshd,bshd->bhs", do.to(f32), out.to(f32))

    def q_blk(i):
        sl = slice(i * qc, (i + 1) * qc)
        return q[:, sl], do[:, sl], lse[:, :, sl], delta[:, :, sl]

    def kv_blk(j):
        sl = slice(j * kc, (j + 1) * kc)
        return k[:, sl], v[:, sl]

    def p_ds(qcb, kcb, vcb, docb, lseb, delb, qidx, kidx):
        """Recompute p and ds for one (q block, kv block) pair."""
        s_raw = torch.einsum("bqhd,bkhd->bhqk", qcb.to(f32),
                             kcb.to(f32)) * scale
        if softcap and softcap > 0:
            t = torch.tanh(s_raw / softcap)
            s = t * softcap
            dcap = 1.0 - t * t
        else:
            s, dcap = s_raw, 1.0
        qp = qidx * qc + torch.arange(qc, device=dev)
        kp = kidx * kc + torch.arange(kc, device=dev)
        mask = attn_mask(qp, kp, causal=causal, window=window)
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - lseb[..., None])                  # (B, H, q, k)
        dp = torch.einsum("bqhd,bkhd->bhqk", docb.to(f32), vcb.to(f32))
        ds = p * (dp - delb[..., None]) * scale * dcap
        ds = torch.where(mask, ds, 0.0)
        return p, ds

    # pass 1: dq by q block
    dqs = []
    for i in range(nq):
        qcb, docb, lseb, delb = q_blk(i)
        dq = torch.zeros((B, qc, H, D), dtype=f32, device=dev)
        for j in range(nk):
            kcb, vcb = kv_blk(j)
            _, ds = p_ds(qcb, kcb, vcb, docb, lseb, delb, i, j)
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kcb.to(f32))
        dqs.append(dq)
    # pass 2: dk and dv by kv block
    dks, dvs = [], []
    for j in range(nk):
        kcb, vcb = kv_blk(j)
        dk = torch.zeros((B, kc, H, D), dtype=f32, device=dev)
        dv = torch.zeros((B, kc, H, D), dtype=f32, device=dev)
        for i in range(nq):
            qcb, docb, lseb, delb = q_blk(i)
            p, ds = p_ds(qcb, kcb, vcb, docb, lseb, delb, i, j)
            dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, docb.to(f32))
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qcb.to(f32))
        dks.append(dk)
        dvs.append(dv)
    return (torch.cat(dqs, dim=1).to(q.dtype),
            torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """Flash attention with the reference's hand-written VJP
    (``flash_attention_xla``): the forward keeps only ``(q, k, v, out,
    lse)``, the backward recomputes probabilities block by block
    (:func:`_flash_bwd_impl`).

    The forward launches the Hopper kernel on CUDA tensors (its ``lse``
    output is the residual) and runs :func:`_flash_fwd_impl` on CPU
    tensors, or on any device with ``plain=True`` (what the kernel is
    held against).  A failed kernel build or launch raises; nothing
    falls back.  The backward is plain torch: the reference has no
    backward kernel either."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_chunk, kv_chunk,
                plain):
        if q.is_cuda and not plain:
            out, lse = flash_attention_kernel(q, k, v, causal=causal,
                                              window=window, softcap=softcap,
                                              return_lse=True)
        else:
            out, lse = _flash_fwd_impl(q, k, v, causal=causal, window=window,
                                       softcap=softcap, q_chunk=q_chunk,
                                       kv_chunk=kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        q_chunk=q_chunk, kv_chunk=kv_chunk)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, out, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_train(q, k, v, *, causal, window, softcap,
                          q_chunk=1024, kv_chunk=1024, plain=False):
    """q/k/v (B, S, H, D), kv heads pre-repeated -> (B, Sq, H, D), with
    :class:`FlashAttention`'s backward."""
    return FlashAttention.apply(q, k, v, causal, window, softcap, q_chunk,
                                kv_chunk, plain)


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------
def contract(eq: str, a, b):
    """``torch.einsum(eq, a, b)`` for the model's projections, written as
    a ``matmul`` of explicit reshapes, each merging dims with the split
    one outermost (torch 2.11's DTensor refuses the views einsum makes
    when it orders a split dim inner).  Raises on any other equation."""
    if eq == "bsd,dhe->bshe":
        d, h, e = b.shape
        return torch.matmul(a, b.reshape(d, h * e)).reshape(
            *a.shape[:2], h, e)
    if eq == "bshe,hed->bsd":
        h, e, d = b.shape
        return torch.matmul(a.reshape(*a.shape[:2], h * e),
                            b.reshape(h * e, d))
    if eq in ("bsd,df->bsf", "bsf,fd->bsd", "bsd,dv->bsv"):
        return torch.matmul(a, b)
    if eq == "bsd,vd->bsv":
        return torch.matmul(a, b.t())
    raise ValueError(f"contract: no product for {eq!r}")


# ---------------------------------------------------------------------------
# GQA attention block (projections + rope + core)
# ---------------------------------------------------------------------------
def attn_spec(cfg):
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": spec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": spec((d, kh, hd), ("embed", "kv_heads", "head_dim")),
        "wv": spec((d, kh, hd), ("embed", "kv_heads", "head_dim")),
        "wo": spec((h, hd, d), ("heads", "head_dim", "embed"),
                   scale=0.02 / max(1, cfg.num_layers) ** 0.5),
    }
    if cfg.attn_bias:
        p["bq"] = spec((h, hd), ("heads", "head_dim"), init="zeros")
        p["bk"] = spec((kh, hd), ("kv_heads", "head_dim"), init="zeros")
        p["bv"] = spec((kh, hd), ("kv_heads", "head_dim"), init="zeros")
    return p


def attn_qkv(p, x, cfg, positions):
    """Project and rope. Returns q (B,S,H,D), k/v (B,S,KH,D) (unrepeated)."""
    q = contract("bsd,dhe->bshe", x, p["wq"].to(x.dtype))
    k = contract("bsd,dhe->bshe", x, p["wk"].to(x.dtype))
    v = contract("bsd,dhe->bshe", x, p["wv"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def repeat_kv(k, groups: int):
    """(B, S, KH, D) -> (B, S, KH*G, D).  On a DTensor each rank repeats
    its own heads (an even split of KH is an even split of KH*G, in the
    same order); an uneven split is gathered first."""
    if groups == 1:
        return k
    if A.is_dtensor(k):
        n = math.prod(k.device_mesh.size(i)
                      for i, p in enumerate(k.placements) if p.is_shard(2))
        if k.shape[2] % n:
            k = A.unsplit(k, 2)
    return A.per_shard(lambda t: torch.repeat_interleave(t, groups, dim=2),
                       k)


def attn_out(p, o, x_dtype):
    """o: (B, S, H, D) -> (B, S, d_model)."""
    return contract("bshe,hed->bsd", o, p["wo"].to(x_dtype))


def attention_block(p, x, cfg, *, positions, causal=True, window=0,
                    impl="chunked", kv=None, kv_positions=None):
    """Full attention sub-block (no norm/residual).  ``kv`` given: cross-
    attention, keys and values projected from the memory ``kv`` (B, Sk,
    d) without RoPE, unmasked (``causal=False, window=0``), so the
    kernel runs with Sq != Sk.

    Returns (out, (k, v)) with k/v in UNREPEATED (B, S, KH, D) form for
    the decode cache.
    """
    g = cfg.num_heads // cfg.num_kv_heads
    # the sequence whole on each rank before the projections (Megatron
    # sequence parallelism's all-gather; DTensor does not do it itself)
    x = A.constrain(x, "batch")
    if kv is None:
        q, k, v = attn_qkv(p, x, cfg, positions)
        k_pos = positions
    else:
        kv = A.constrain(kv, "batch")         # the memory whole, as x
        q = contract("bsd,dhe->bshe", x, p["wq"].to(x.dtype))
        k = contract("bsd,dhe->bshe", kv, p["wk"].to(kv.dtype))
        v = contract("bsd,dhe->bshe", kv, p["wv"].to(kv.dtype))
        k_pos = (kv_positions if kv_positions is not None
                 else torch.arange(kv.shape[1], device=kv.device))
        causal, window = False, 0
    train = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)

    def route(q, k, v):
        # positions are arange in every full-sequence path
        if impl == "plain" or (impl == "chunked" and train):
            # the chunk sizes attention_block gives the reference's VJP
            return flash_attention_train(q, k, v, causal=causal,
                                         window=window,
                                         softcap=cfg.attn_logit_softcap,
                                         plain=impl == "plain")
        if impl == "chunked":
            return flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=cfg.attn_logit_softcap)
        return attention_naive(q, k, v, q_pos=positions, k_pos=k_pos,
                               causal=causal, window=window,
                               softcap=cfg.attn_logit_softcap)

    # pin the head-parallel layout: (B,S,H,D) with H over "model"
    qf = A.constrain(q, "heads")
    kf = A.constrain(repeat_kv(k, g), "heads")
    vf = A.constrain(repeat_kv(v, g), "heads")
    o = A.constrain(A.per_shard(route, qf, kf, vf), "heads")
    return attn_out(p, o, x.dtype), (k, v)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def silu(g):
    """``jax.nn.silu``: g * sigmoid(g), with the sigmoid as XLA expands
    it, 1 / (1 + exp(-g)), each step rounded to g's dtype."""
    return g * (1 / (1 + torch.exp(-g)))


def mlp_spec(cfg):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "wi": spec((d, f), ("embed", "ffn")),
            "wg": spec((d, f), ("embed", "ffn")),
            "wo": spec((f, d), ("ffn", "embed"),
                       scale=0.02 / max(1, cfg.num_layers) ** 0.5),
        }
    return {
        "wi": spec((d, f), ("embed", "ffn")),
        "wo": spec((f, d), ("ffn", "embed"),
                   scale=0.02 / max(1, cfg.num_layers) ** 0.5),
    }


def apply_mlp(p, x, cfg):
    x = A.constrain(x, "batch")     # as in attention_block
    h = A.constrain(contract("bsd,df->bsf", x, p["wi"].to(x.dtype)),
                    "ffn")
    if cfg.act == "swiglu":
        g = A.constrain(contract("bsd,df->bsf", x,
                                     p["wg"].to(x.dtype)), "ffn")
        h = silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return contract("bsf,fd->bsd", h, p["wo"].to(x.dtype))
