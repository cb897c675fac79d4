"""Model assembly for the dense family.

A config is compiled into a *layer plan*: an ordered list of homogeneous
segments.  The model is a ``Transformer`` whose segments are
``nn.ModuleList``s of per-layer ``Block``s, run by a Python loop (the
reference scans stacked parameters).  The dense family has one segment
kind:

  attn        -- GQA attention + MLP block (window per segment; gemma3's
                 local:global pattern becomes runs of equal window)

The other families (moe, ssm, hybrid, audio, vlm) raise
``NotImplementedError`` naming the ROADMAP item that ports them.

Two entry points (used by the serving driver):
  forward_prefill full-sequence forward that also builds the KV cache
  forward_decode  single-token step against the cache
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.params import spec, tree_map_specs

# the families the port does not run yet, and where ROADMAP.md queues them
_LATER = {
    "moe": "MoE (ROADMAP.md, LM queue item L2)",
    "ssm": "Mamba2 (ROADMAP.md, LM queue item L3)",
    "hybrid": "Mamba2 and hybrid (ROADMAP.md, LM queue item L3)",
    "audio": "the audio encoder-decoder (ROADMAP.md, LM queue item L4)",
    "vlm": "the VLM (ROADMAP.md, LM queue item L5)",
}


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; see "
            f"{_LATER[cfg.family]}")
    if cfg.family != "dense":
        raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# Layer plan
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Segment:
    kind: str
    count: int
    window: int = 0          # 0 = full attention
    causal: bool = True


def build_plan(cfg: ModelConfig) -> list[Segment]:
    _dense_only(cfg)
    if cfg.global_every > 0:
        # gemma3-style local:global pattern -> runs of equal window
        segs: list[Segment] = []
        run_w, run_n = None, 0
        for i in range(cfg.num_layers):
            w = 0 if (i + 1) % cfg.global_every == 0 else cfg.sliding_window
            if w == run_w:
                run_n += 1
            else:
                if run_n:
                    segs.append(Segment("attn", run_n, window=run_w))
                run_w, run_n = w, 1
        if run_n:
            segs.append(Segment("attn", run_n, window=run_w))
        return segs
    return [Segment("attn", cfg.num_layers, window=cfg.sliding_window)]


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------
def _block_spec(cfg: ModelConfig):
    return {"ln1": L.norm_spec(cfg.norm, cfg.d_model),
            "attn": L.attn_spec(cfg),
            "ln2": L.norm_spec(cfg.norm, cfg.d_model),
            "mlp": L.mlp_spec(cfg)}


def _stack_spec(tree, n: int):
    return tree_map_specs(
        lambda s: dataclasses.replace(s, shape=(n,) + s.shape,
                                      axes=(None,) + s.axes), tree)


def param_spec(cfg: ModelConfig):
    """Full parameter spec tree, segments stacked as in the reference."""
    d = cfg.d_model
    p: dict[str, Any] = {
        "embed": spec((cfg.vocab_size, d), ("vocab", "embed"), scale=0.02),
        "final_norm": L.norm_spec(cfg.norm, d),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = spec((d, cfg.vocab_size), ("embed", "vocab"))
    p["segments"] = [_stack_spec(_block_spec(cfg), s.count)
                     for s in build_plan(cfg)]
    return p


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------
def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One layer: ``ln1``, ``attn`` (wq/wk/wv/wo [+ biases]), ``ln2`` and
    ``mlp``, each an ``nn.ParameterDict``."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, sub in tree.items():
            setattr(self, name, nn.ParameterDict(
                {k: _param(t) for k, t in sub.items()}))


class Transformer(nn.Module):
    """The dense-family model.  ``tree`` is a parameter tree with the
    layers of each segment stacked on axis 0 (``param_spec``'s layout);
    each Block holds views of its layer."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.plan = build_plan(cfg)
        self.embed = _param(tree["embed"])
        self.final_norm = nn.ParameterDict(
            {k: _param(t) for k, t in tree["final_norm"].items()})
        if "lm_head" in tree:
            self.lm_head = _param(tree["lm_head"])
        self.segments = nn.ModuleList(
            nn.ModuleList(
                Block({name: {k: t[i] for k, t in sub.items()}
                       for name, sub in seg_tree.items()})
                for i in range(seg.count))
            for seg, seg_tree in zip(self.plan, tree["segments"]))


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------
def _attn_body(bp, x, cfg, seg: Segment, positions, impl):
    h = L.apply_norm(bp.ln1, x, cfg.norm)
    a, kv = L.attention_block(bp.attn, h, cfg, positions=positions,
                              causal=seg.causal, window=seg.window, impl=impl)
    x = x + a
    h = L.apply_norm(bp.ln2, x, cfg.norm)
    return x + L.apply_mlp(bp.mlp, h, cfg), {"k": kv[0], "v": kv[1]}


def _clip_cache(extras, seg: Segment):
    """Keep only the window-relevant tail of k/v for SWA segments."""
    if seg.window <= 0:
        return extras
    return {name: t[:, -seg.window:] for name, t in extras.items()}


def _run_segments(params: Transformer, cfg, x, positions, *, impl):
    """Run the layer plan over full-sequence x.  Returns x and, per
    segment, the k/v of its layers stacked on axis 0."""
    caches = []
    for seg, blocks in zip(params.plan, params.segments):
        per_layer = []
        for bp in blocks:
            x, extras = _attn_body(bp, x, cfg, seg, positions, impl)
            per_layer.append(_clip_cache(extras, seg))
        caches.append({name: torch.stack([e[name] for e in per_layer])
                       for name in ("k", "v")})
    return x, caches


def _embed(params: Transformer, cfg, tokens):
    x = params.embed[tokens].to(torch.bfloat16)
    if cfg.global_every > 0:  # gemma-style embed scaling
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _logits(params: Transformer, cfg, x):
    x = L.apply_norm(params.final_norm, x, cfg.norm)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params.embed.to(x.dtype))
    return torch.einsum("bsd,dv->bsv", x, params.lm_head.to(x.dtype))


def forward_prefill(params: Transformer, cfg: ModelConfig, batch, *,
                    impl="chunked"):
    """Full-sequence forward building the decode cache.

    Returns (last-position logits, cache).  Cache layout mirrors the plan:
    one entry per segment (see init_cache for shapes).
    """
    tokens = batch["tokens"]
    x = _embed(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    x, caches = _run_segments(params, cfg, x, positions, impl=impl)
    logits = _logits(params, cfg, x[:, -1:, :])
    return logits, {"segments": caches, "pos": tokens.shape[1]}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, ctx_len: int,
               device: torch.device | str | None = None):
    """Zero-initialized bf16 decode cache, on the card unless ``device``
    says otherwise (without a card it raises; pass ``device="cpu"``).

    Full-attention segments get (L, B, ctx, KH, D) buffers written at
    ``pos``; SWA segments get (L, B, window, KH, D) shift buffers.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_cache puts the cache on CUDA and no CUDA device is "
                "available; pass device='cpu' to keep it on the CPU")
        device = "cuda"
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    segs = []
    for seg in build_plan(cfg):
        wlen = min(seg.window if seg.window > 0 else ctx_len, ctx_len)
        shape = (seg.count, batch, wlen, kh, hd)
        segs.append({name: torch.zeros(shape, dtype=torch.bfloat16,
                                       device=device) for name in ("k", "v")})
    return {"segments": segs, "pos": 0}


def _decode_attn(bp, x, cfg, seg: Segment, pos: int, ck, cv):
    """One decode step of an attention block against its cache.  Writes
    the new k/v into the layer's buffers ``ck``/``cv`` in place."""
    kh = cfg.num_kv_heads
    g = cfg.num_heads // kh
    B = x.shape[0]
    h = L.apply_norm(bp.ln1, x, cfg.norm)
    q, k, v = L.attn_qkv(bp.attn, h, cfg,
                         torch.full((1,), pos, dtype=torch.int32,
                                    device=x.device))
    q = q.reshape(B, 1, kh, g, cfg.head_dim)
    W = ck.shape[1]
    if seg.window > 0 and W == seg.window:
        # SWA shift buffer: slot j holds absolute position pos-W+1+j
        ck.copy_(torch.cat([ck[:, 1:], k.to(ck.dtype)], dim=1))
        cv.copy_(torch.cat([cv[:, 1:], v.to(cv.dtype)], dim=1))
        k_pos = pos - W + 1 + torch.arange(W, device=x.device)
    else:
        if pos >= W:
            raise ValueError(f"decode position {pos} past the cache's "
                             f"{W} slots")
        ck[:, pos] = k[:, 0].to(ck.dtype)
        cv[:, pos] = v[:, 0].to(cv.dtype)
        k_pos = torch.arange(W, device=x.device)
    valid = (k_pos >= 0) & (k_pos <= pos)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), ck.float()) \
        * (cfg.head_dim ** -0.5)
    if cfg.attn_logit_softcap:
        s = torch.tanh(s / cfg.attn_logit_softcap) * cfg.attn_logit_softcap
    s = torch.where(valid, s, L.NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(cv.dtype), cv)
    o = o.reshape(B, 1, cfg.num_heads, cfg.head_dim)
    return x + L.attn_out(bp.attn, o, x.dtype)


def forward_decode(params: Transformer, cfg: ModelConfig, tokens, cache):
    """One decode step at ``cache["pos"]``. tokens: (B, 1) -> logits
    (B, 1, V), and the cache with ``pos + 1``; its buffers are updated in
    place."""
    pos = cache["pos"]
    x = _embed(params, cfg, tokens)
    for seg, blocks, c in zip(params.plan, params.segments,
                              cache["segments"]):
        for li, bp in enumerate(blocks):
            x = _decode_attn(bp, x, cfg, seg, pos, c["k"][li], c["v"][li])
            h = L.apply_norm(bp.ln2, x, cfg.norm)
            x = x + L.apply_mlp(bp.mlp, h, cfg)
    logits = _logits(params, cfg, x)
    return logits, {"segments": cache["segments"], "pos": pos + 1}
