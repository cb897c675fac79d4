"""Model assembly for every architecture family.

A config is compiled into a *layer plan*: an ordered list of homogeneous
segments.  The model is a ``Transformer`` whose segments are
``nn.ModuleList``s of per-layer ``Block``s, run by a Python loop (the
reference scans stacked parameters).  Segment kinds:

  attn        -- GQA attention + MLP block   (dense / vlm; window per
                 segment; gemma3's local:global pattern becomes runs of
                 equal window)
  moe         -- GQA attention + MoE block
  mamba       -- Mamba2 (SSD) block
  shared_attn -- zamba2's parameter-shared attention+MLP block
                 (``Transformer.shared``; the segment holds no block)
  enc_attn    -- bidirectional encoder block (whisper,
                 ``Transformer.encoder``)
  xattn       -- decoder block with self + cross attention (whisper)

Three entry points:
  forward_train   causal-LM loss over a parameter TREE (the stacked
                  leaves ``init_params`` returns, which autograd and the
                  optimizer see), blocks rematerialised; every family
  forward_prefill full-sequence forward that also builds the KV/SSM cache
  forward_decode  single-token step against the cache

On DTensor parameters (a sharded step, ``launch/steps.py``) each layer
gathers its weights' data-axis shards at its use (``actctx.gather``:
inside the remat boundary, so the recompute gathers again), the
residual stream is pinned to the policy's "resid" layout around every
layer (outside the remat boundary, as the reference), and a decode step
writes its new key and value on the rank whose cache shard holds
``pos``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import actctx as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models.params import spec, tree_map_specs

# ---------------------------------------------------------------------------
# Layer plan
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Segment:
    kind: str
    count: int
    window: int = 0          # 0 = full attention
    causal: bool = True
    shared_index: int = -1   # invocation index for shared_attn


def build_plan(cfg: ModelConfig) -> list[Segment]:
    fam = cfg.family
    if fam in ("dense", "vlm"):
        if cfg.global_every > 0:
            # gemma3-style local:global pattern -> runs of equal window
            segs: list[Segment] = []
            run_w, run_n = None, 0
            for i in range(cfg.num_layers):
                w = 0 if (i + 1) % cfg.global_every == 0 \
                    else cfg.sliding_window
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
    if fam == "moe":
        return [Segment("moe", cfg.num_layers, window=cfg.sliding_window)]
    if fam == "ssm":
        return [Segment("mamba", cfg.num_layers)]
    if fam == "hybrid":
        segs = []
        remaining, idx = cfg.num_layers, 0
        while remaining > 0:
            segs.append(Segment("shared_attn", 1, shared_index=idx))
            idx += 1
            n = min(cfg.hybrid_attn_every, remaining)
            segs.append(Segment("mamba", n))
            remaining -= n
        return segs
    if fam == "audio":
        return [Segment("xattn", cfg.num_layers)]
    raise ValueError(fam)


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------
def _block_spec(cfg: ModelConfig, kind: str):
    if kind in ("attn", "enc_attn"):
        return {"ln1": L.norm_spec(cfg.norm, cfg.d_model),
                "attn": L.attn_spec(cfg),
                "ln2": L.norm_spec(cfg.norm, cfg.d_model),
                "mlp": L.mlp_spec(cfg)}
    if kind == "moe":
        return {"ln1": L.norm_spec(cfg.norm, cfg.d_model),
                "attn": L.attn_spec(cfg),
                "ln2": L.norm_spec(cfg.norm, cfg.d_model),
                "moe": MOE.moe_spec(cfg)}
    if kind == "mamba":
        return {"ln": L.norm_spec("rmsnorm", cfg.d_model),
                "mixer": M2.mamba2_spec(cfg)}
    if kind == "xattn":
        return {"ln1": L.norm_spec(cfg.norm, cfg.d_model),
                "attn": L.attn_spec(cfg),
                "lnx": L.norm_spec(cfg.norm, cfg.d_model),
                "xattn": L.attn_spec(cfg),
                "ln2": L.norm_spec(cfg.norm, cfg.d_model),
                "mlp": L.mlp_spec(cfg)}
    raise ValueError(kind)


def _stack_spec(tree, n: int):
    return tree_map_specs(
        lambda s: dataclasses.replace(s, shape=(n,) + s.shape,
                                      axes=(None,) + s.axes), tree)


def param_spec(cfg: ModelConfig):
    """Full parameter spec tree, segments stacked as in the reference: a
    shared-attention segment is ``{}`` (its block is ``"shared"``), and
    the audio family's encoder is ``"encoder"``."""
    d = cfg.d_model
    p: dict[str, Any] = {
        "embed": spec((cfg.vocab_size, d), ("vocab", "embed"), scale=0.02),
        "final_norm": L.norm_spec(cfg.norm, d),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = spec((d, cfg.vocab_size), ("embed", "vocab"))
    p["segments"] = [{} if s.kind == "shared_attn"
                     else _stack_spec(_block_spec(cfg, s.kind), s.count)
                     for s in build_plan(cfg)]
    if cfg.family == "hybrid":
        p["shared"] = _block_spec(cfg, "attn")
    if cfg.family == "audio":
        p["encoder"] = {
            "segments": [_stack_spec(_block_spec(cfg, "enc_attn"),
                                     cfg.encoder_layers)],
            "final_norm": L.norm_spec(cfg.norm, d),
        }
    return p


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------
def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _params(sub: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: _param(t) for k, t in sub.items()})


class Block(nn.Module):
    """One layer: an ``nn.ParameterDict`` for each entry of its spec
    (``ln1``, ``attn``, ``ln2``, ``mlp`` or ``moe``; ``lnx`` and
    ``xattn`` for a decoder block; ``ln`` and ``mixer`` for mamba)."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, sub in tree.items():
            setattr(self, name, _params(sub))


def _blocks(seg_tree: dict) -> nn.ModuleList:
    """The per-layer Blocks of a stacked segment tree, each holding views
    of its layer; empty for ``{}`` (a shared-attention segment)."""
    if not seg_tree:
        return nn.ModuleList()
    count = next(iter(next(iter(seg_tree.values())).values())).shape[0]
    return nn.ModuleList(
        Block({name: {k: t[i] for k, t in sub.items()}
               for name, sub in seg_tree.items()})
        for i in range(count))


class Encoder(nn.Module):
    """The audio family's encoder: ``segments`` and ``final_norm``, as
    the reference's ``params["encoder"]``."""

    def __init__(self, tree: dict):
        super().__init__()
        self.segments = nn.ModuleList(_blocks(t) for t in tree["segments"])
        self.final_norm = _params(tree["final_norm"])


class Transformer(nn.Module):
    """The model.  ``tree`` is a parameter tree with the layers of each
    segment stacked on axis 0 (``param_spec``'s layout); each Block
    holds views of its layer.  ``shared`` (hybrid) and ``encoder``
    (audio) hold the trees of the reference's keys of those names."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.plan = build_plan(cfg)
        self.embed = _param(tree["embed"])
        self.final_norm = _params(tree["final_norm"])
        if "lm_head" in tree:
            self.lm_head = _param(tree["lm_head"])
        self.segments = nn.ModuleList(_blocks(t) for t in tree["segments"])
        if "shared" in tree:
            self.shared = Block(tree["shared"])
        if "encoder" in tree:
            self.encoder = Encoder(tree["encoder"])


# ---------------------------------------------------------------------------
# Block bodies (full-sequence mode)
# ---------------------------------------------------------------------------
def _attn_body(bp, x, cfg, seg: Segment, positions, impl, memory=None):
    # each sub-block's output pinned to the residual's layout before the
    # add (on DTensors: its partial sums reduce-scattered there)
    h = L.apply_norm(bp.ln1, x, cfg.norm)
    a, kv = L.attention_block(bp.attn, h, cfg, positions=positions,
                              causal=seg.causal, window=seg.window, impl=impl)
    x = x + A.constrain(a, "resid")
    extras = {"k": kv[0], "v": kv[1]}
    if seg.kind == "xattn":
        h = L.apply_norm(bp.lnx, x, cfg.norm)
        a, xkv = L.attention_block(bp.xattn, h, cfg, positions=positions,
                                   impl=impl, kv=memory)
        x = x + A.constrain(a, "resid")
        extras.update({"xk": xkv[0], "xv": xkv[1]})
    h = L.apply_norm(bp.ln2, x, cfg.norm)
    aux = {}
    if seg.kind == "moe":
        m, aux = MOE.apply_moe(bp.moe, h, cfg)
    else:
        m = L.apply_mlp(bp.mlp, h, cfg)
    return x + A.constrain(m, "resid"), extras, aux


def _gathered(bp):
    """A block's parameters at their use: ``bp`` itself on plain
    tensors; on DTensors a namespace of its dicts with each weight's
    data-axis shards gathered (``actctx.gather``), but for a MoE block's
    expert weights."""
    if isinstance(bp, SimpleNamespace):
        tree = vars(bp)
        first = next(iter(next(iter(tree.values())).values()))
    else:
        first = next(bp.parameters())
    if not A.is_dtensor(first):
        return bp
    if not isinstance(bp, SimpleNamespace):
        tree = {name: dict(sub.items()) for name, sub in bp.named_children()}
    # a MoE block's experts stay as they rest (models/moe.py)
    return SimpleNamespace(**A.gather_tree(
        tree, keep={"moe": MOE.EXPERT_LEAVES}))


def _mamba_body(bp, x, cfg, return_state=True):
    # the block's output pinned to the residual's layout before the add,
    # as _attn_body's
    h = L.apply_norm(bp.ln, x, "rmsnorm")
    if not return_state:
        return x + A.constrain(M2.mamba2_block(bp.mixer, h, cfg), "resid")
    out, (h_last, conv) = M2.mamba2_block(bp.mixer, h, cfg,
                                          return_state=True)
    return x + A.constrain(out, "resid"), {"h": h_last, "conv": conv}


def _clip_cache(extras, seg: Segment):
    """Keep only the window-relevant tail of k/v for SWA segments."""
    if seg.window <= 0 or seg.kind == "xattn":
        return extras
    return {name: t[:, -seg.window:] if name in ("k", "v") else t
            for name, t in extras.items()}


def _run_segments(params: Transformer, cfg, x, positions, *, impl,
                  memory=None):
    """Run the layer plan over full-sequence x.  Returns x and, per
    segment, its cache entries: those of its layers stacked on axis 0,
    a shared-attention segment's without that axis."""
    caches = []
    for seg, blocks in zip(params.plan, params.segments):
        if seg.kind == "shared_attn":
            x = A.constrain(x, "resid")
            x, extras, _ = _attn_body(_gathered(params.shared), x, cfg, seg,
                                      positions, impl)
            caches.append(extras)
            continue
        per_layer = []
        for bp in blocks:
            x = A.constrain(x, "resid")
            if seg.kind == "mamba":
                x, extras = _mamba_body(_gathered(bp), x, cfg)
            else:
                x, extras, _ = _attn_body(_gathered(bp), x, cfg, seg,
                                          positions, impl, memory=memory)
            x = A.constrain(x, "resid")
            per_layer.append(_clip_cache(extras, seg))
        caches.append({name: torch.stack([e[name] for e in per_layer])
                       for name in per_layer[0]})
    return x, caches


def _lookup(w, tokens):
    """Rows ``tokens`` of the table ``w``: an embedding lookup, which on a
    DTensor table (its vocab split over "model") each rank does on its
    own rows and sums, where indexing would gather the whole table."""
    return torch.nn.functional.embedding(tokens.long(), w)


def _prepend_vision(vis, x):
    """The vision tokens ``vis`` (B, V, d) before the token embeddings
    ``x`` (B, S, d), in x's dtype.  On DTensors x, a DTensor table's
    masked partial sum, is reduced first (a partial sum cannot meet the
    plain values of ``vis``, and torch 2.11 reduces a masked one only
    once)."""
    return torch.cat([vis.to(x.dtype), A.reduce_partial(x)], dim=1)


def _embed(params: Transformer, cfg, tokens, extras=None):
    x = _lookup(A.gather(params.embed), tokens).to(torch.bfloat16)
    if cfg.family == "dense" and cfg.global_every > 0:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)  # gemma
    if cfg.family == "vlm" and extras is not None and "vis_embeds" in extras:
        x = _prepend_vision(extras["vis_embeds"], x)
    return x


def _encode_audio(params: Transformer, cfg, enc_embeds, impl):
    """The encoder over the frame embeddings: bidirectional blocks, then
    its final norm.  Returns the decoder's cross-attention memory."""
    x = enc_embeds.to(torch.bfloat16)
    pos = torch.arange(x.shape[1], device=x.device)
    seg = Segment("enc_attn", cfg.encoder_layers, causal=False)
    for blocks in params.encoder.segments:
        for bp in blocks:
            x = _attn_body(_gathered(bp), x, cfg, seg, pos, impl)[0]
    return L.apply_norm(params.encoder.final_norm, x, cfg.norm)


def _logits(params: Transformer, cfg, x):
    x = L.apply_norm(params.final_norm, x, cfg.norm)
    if cfg.tie_embeddings:
        return L.contract("bsd,vd->bsv", x,
                          A.gather(params.embed).to(x.dtype))
    return L.contract("bsd,dv->bsv", x,
                      A.gather(params.lm_head).to(x.dtype))


# ---------------------------------------------------------------------------
# Training forward (loss)
# ---------------------------------------------------------------------------
def _layer_view(seg_tree: dict, i: int) -> SimpleNamespace:
    """Layer ``i`` of a segment's stacked parameters, as views (autograd
    carries their gradients into the stacked leaves)."""
    return SimpleNamespace(**{name: {k: t[i] for k, t in sub.items()}
                              for name, sub in seg_tree.items()})


def _train_block(x, lp, cfg, seg: Segment, positions, impl, memory):
    """One layer of the training forward: its new residual and its aux
    dict (the MoE's losses, else empty).  The layer's weights are
    gathered here, inside the remat boundary."""
    lp = _gathered(lp)
    if seg.kind == "mamba":
        return _mamba_body(lp, x, cfg, return_state=False), {}
    x, _, aux = _attn_body(lp, x, cfg, seg, positions, impl, memory=memory)
    return x, aux


def _run_layer(remat: bool, *args):
    """:func:`_train_block` on ``args``, recomputed in the backward when
    ``remat`` (``torch.utils.checkpoint``, the role of
    ``jax.checkpoint``)."""
    if remat:
        return checkpoint(_train_block, *args, use_reentrant=False)
    return _train_block(*args)


def _zero_aux(cfg, device):
    if cfg.family == "moe":
        return {k: torch.zeros((), dtype=torch.float32, device=device)
                for k in ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")}
    return {}


def _train_segments(params: dict, cfg, x, positions, *, impl, remat,
                    memory=None):
    """The reference's ``_run_segments(..., want_cache=False)`` over the
    parameter tree: each layer of a stacked segment from its views
    (:func:`_layer_view`), recomputed in the backward when ``remat``; a
    shared-attention segment runs ``params["shared"]`` without remat,
    so its gradient sums over every call.  Returns x and the aux dict
    summed over the layers."""
    aux_tot = _zero_aux(cfg, x.device)
    shared = SimpleNamespace(**params["shared"]) if "shared" in params \
        else None
    for seg, seg_tree in zip(build_plan(cfg), params["segments"]):
        if seg.kind == "shared_attn":
            x = A.constrain(x, "resid")
            x = _attn_body(_gathered(shared), x, cfg, seg, positions,
                           impl)[0]
            continue
        for i in range(seg.count):
            # constraints outside the remat boundary, as the reference's
            x = A.constrain(x, "resid")
            x, aux = _run_layer(remat, x, _layer_view(seg_tree, i), cfg, seg,
                                positions, impl, memory)
            x = A.constrain(x, "resid")
            aux_tot = {k: v + aux.get(k, 0.0) for k, v in aux_tot.items()}
    return x, aux_tot


def _encode_audio_train(params: dict, cfg, enc_embeds, impl, remat):
    """The encoder over the frame embeddings from ``params["encoder"]``,
    each layer recomputed in the backward when ``remat``."""
    x = enc_embeds.to(torch.bfloat16)
    pos = torch.arange(x.shape[1], device=x.device)
    enc = params["encoder"]
    seg = Segment("enc_attn", cfg.encoder_layers, causal=False)
    for i in range(cfg.encoder_layers):
        x = _run_layer(remat, x, _layer_view(enc["segments"][0], i), cfg,
                       seg, pos, impl, None)[0]
    return L.apply_norm(enc["final_norm"], x, cfg.norm)


def _ce_chunk(xx, tt, ww, w, tied: bool):
    """One chunk's summed next-token CE: bf16 logits, f32 log-softmax
    (on DTensors over the whole vocab: its shards are gathered first)."""
    if tied:
        lg = L.contract("bsd,vd->bsv", xx, w.to(xx.dtype)).float()
    else:
        lg = L.contract("bsd,dv->bsv", xx, w.to(xx.dtype)).float()
    lg = A.unsplit(lg, 2)
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, tt[..., None].long())[..., 0]
    return ((logz - gold) * ww).sum()


def _chunked_ce(params: dict, cfg, x, tokens, vis: int, chunk: int = 512):
    """Next-token CE with the vocab projection run over seq chunks.

    As the reference's ``_chunked_ce``: targets rolled by one, the last
    position masked, and each chunk's body recomputed in the backward
    (``torch.utils.checkpoint``, the role of ``jax.checkpoint``) so the
    (B, S, V) f32 logits are never held whole."""
    x = A.constrain(L.apply_norm(params["final_norm"], x, cfg.norm), "batch")
    xt = x[:, vis:, :]
    # last is garbage; a DTensor's rows roll on their own rank
    tgt = A.per_shard(lambda t: torch.roll(t, -1, dims=1), tokens)
    B, S, _ = xt.shape
    c = L._pick_chunk(S, chunk)
    wc = (torch.arange(S, device=x.device) < S - 1).float()
    tied = cfg.tie_embeddings
    w = A.gather(params["embed"] if tied else params["lm_head"])
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        tot = tot + checkpoint(_ce_chunk, xt[:, sl], tgt[:, sl], wc[sl], w,
                               tied, use_reentrant=False)
    return tot / (B * (S - 1))


def forward_train(params: dict, cfg: ModelConfig, batch, *, impl="chunked",
                  remat=True):
    """Causal-LM loss of the parameter tree ``params`` on ``batch``:
    ``tokens`` (B, S) int, plus ``enc_embeds`` (B, encoder_seq, d) for
    the audio family and ``vis_embeds`` (B, vision_tokens, d), prepended
    to the token embeddings and skipped by the loss, for the vlm.
    Returns ``(loss, metrics)``: ``{"ce": ...}``, and for the MoE its
    aux losses and dropped share summed over the layers, with ``loss =
    ce + 0.01 moe_lb_loss + 1e-3 moe_z_loss`` as the reference's.

    ``impl="chunked"`` runs attention through the flash kernel on CUDA
    tensors (:class:`~repro_torch.models.layers.FlashAttention`),
    ``"plain"`` through its plain-torch forward, ``"naive"`` through
    materialized scores.  ``remat`` recomputes each stacked layer (and
    each encoder layer) in the backward.  The embedding is cast to bf16
    before the lookup, as the reference's is."""
    tokens = batch["tokens"]
    memory = None
    if cfg.family == "audio":
        memory = _encode_audio_train(params, cfg, batch["enc_embeds"], impl,
                                     remat)
    x = _lookup(A.gather(params["embed"]).to(torch.bfloat16), tokens.long())
    if cfg.family == "dense" and cfg.global_every > 0:  # gemma scaling
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    vis = 0
    if cfg.family == "vlm":
        x = _prepend_vision(batch["vis_embeds"], x)
        vis = cfg.vision_tokens
    x = A.constrain(x, "resid")
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _train_segments(params, cfg, x, positions, impl=impl,
                             remat=remat, memory=memory)
    ce = _chunked_ce(params, cfg, x, tokens, vis)
    loss = ce
    if cfg.family == "moe":
        loss = loss + 0.01 * aux["moe_lb_loss"] + 1e-3 * aux["moe_z_loss"]
    return loss, {"ce": ce, **aux}


def forward_prefill(params: Transformer, cfg: ModelConfig, batch, *,
                    impl="chunked"):
    """Full-sequence forward building the decode cache.  ``batch``:
    ``tokens`` (B, S), plus ``enc_embeds`` (B, encoder_seq, d) for the
    audio family and ``vis_embeds`` (B, vision_tokens, d), prepended to
    the token embeddings, for the vlm.

    Returns (last-position logits, cache).  Cache layout mirrors the plan:
    one entry per segment (see init_cache for shapes).  ``pos`` counts
    every position the cache holds, the vision tokens included (the
    reference's counts the text tokens alone, so its vlm decode writes
    over the prompt's last keys and ropes at the wrong position).
    """
    tokens = batch["tokens"]
    memory = None
    if cfg.family == "audio":
        memory = _encode_audio(params, cfg, batch["enc_embeds"], impl)
    x = _embed(params, cfg, tokens, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, caches = _run_segments(params, cfg, x, positions, impl=impl,
                              memory=memory)
    logits = _logits(params, cfg, x[:, -1:, :])
    return logits, {"segments": caches, "pos": x.shape[1]}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, ctx_len: int,
               device: torch.device | str | None = None):
    """Zero-initialized decode cache, on the card unless ``device`` says
    otherwise (without a card it raises; pass ``device="cpu"``).

    Full-attention segments get bf16 (L, B, ctx, KH, D) buffers written at
    ``pos``; SWA segments get (L, B, window, KH, D) shift buffers; the
    shared-attention segments the same without the layer axis; decoder
    blocks also the encoder's k/v, ``xk``/``xv`` (L, B, encoder_seq, KH,
    D); mamba segments their O(1) state, ``h`` f32 (L, B, H, P, N) and
    ``conv`` bf16 (L, B, ssm_conv - 1, conv_dim).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_cache puts the cache on CUDA and no CUDA device is "
                "available; pass device='cpu' to keep it on the CPU")
        device = "cuda"
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    bf16 = torch.bfloat16

    def zeros(shape, dtype=bf16):
        return torch.zeros(shape, dtype=dtype, device=device)

    segs = []
    for seg in build_plan(cfg):
        if seg.kind == "mamba":
            conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            segs.append({
                "h": zeros((seg.count, batch, cfg.ssm_nheads,
                            cfg.ssm_head_dim, cfg.ssm_state), torch.float32),
                "conv": zeros((seg.count, batch, cfg.ssm_conv - 1,
                               conv_dim))})
            continue
        wlen = min(seg.window if seg.window > 0 else ctx_len, ctx_len)
        lead = () if seg.kind == "shared_attn" else (seg.count,)
        c = {name: zeros(lead + (batch, wlen, kh, hd)) for name in ("k", "v")}
        if seg.kind == "xattn":
            c.update({name: zeros(lead + (batch, cfg.encoder_seq, kh, hd))
                      for name in ("xk", "xv")})
        segs.append(c)
    return {"segments": segs, "pos": 0}


def _row_layout(buf, new):
    """``new`` (B, 1, KH, D) laid out as the rows of the cache buffer
    ``buf`` (B, W, KH, D) are, its slot axis unsplit."""
    return new.to(buf.dtype).redistribute(
        buf.device_mesh, A.unsplit(buf, 1).placements)


def _cache_write(buf, new, pos: int):
    """Write ``new`` (B, 1, KH, D) into slot ``pos`` of ``buf``.  On a
    DTensor buffer (its slots split over mesh axes) the rank whose shard
    holds ``pos`` writes its rows into its own shard."""
    if not A.is_dtensor(buf):
        buf[:, pos] = new[:, 0].to(buf.dtype)
        return
    local, rows = buf.to_local(), _row_layout(buf, new).to_local()
    start = 0
    for i, p in enumerate(buf.placements):
        if p.is_shard(1):
            start = start * buf.device_mesh.size(i) \
                + buf.device_mesh.get_local_rank(i)
    start *= local.shape[1]
    if start <= pos < start + local.shape[1]:
        local[:, pos - start] = rows[:, 0]


def _cache_shift(buf, new):
    """Shift the window buffer ``buf`` one slot left and put ``new`` in
    its last slot; a DTensor buffer is shifted whole and each rank keeps
    its own shard of the result."""
    if not A.is_dtensor(buf):
        buf.copy_(torch.cat([buf[:, 1:], new.to(buf.dtype)], dim=1))
        return
    full = A.unsplit(buf, 1)
    out = torch.cat([full[:, 1:], _row_layout(buf, new)], dim=1)
    buf.to_local().copy_(
        out.redistribute(buf.device_mesh, buf.placements).to_local())


def _state_write(buf, li: int, new):
    """Layer ``li`` of the stacked state ``buf`` set to ``new``; on a
    DTensor buffer each rank writes its own shard of ``new`` laid out
    as the buffer's layer is."""
    if not A.is_dtensor(buf):
        buf[li] = new
        return
    from torch.distributed.tensor import Shard
    pl = [Shard(p.dim - 1) if p.is_shard() else p for p in buf.placements]
    buf.to_local()[li].copy_(A.relayout(new, pl).to_local())


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
    # a DTensor's heads whole on each rank: its cache splits the slots
    q = A.unsplit(q, 2).reshape(B, 1, kh, g, cfg.head_dim)
    W = ck.shape[1]
    if seg.window > 0 and W == seg.window:
        # SWA shift buffer: slot j holds absolute position pos-W+1+j
        _cache_shift(ck, k)
        _cache_shift(cv, v)
        k_pos = pos - W + 1 + torch.arange(W, device=x.device)
    else:
        if pos >= W:
            raise ValueError(f"decode position {pos} past the cache's "
                             f"{W} slots")
        _cache_write(ck, k, pos)
        _cache_write(cv, v, pos)
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


def _decode_xattn(bp, x, cfg, xk, xv):
    """One decode step of a decoder block's cross-attention against the
    encoder's cached k/v (no mask, no RoPE)."""
    kh = cfg.num_kv_heads
    g = cfg.num_heads // kh
    B = x.shape[0]
    h = L.apply_norm(bp.lnx, x, cfg.norm)
    q = L.contract("bsd,dhe->bshe", h, bp.xattn["wq"].to(h.dtype))
    # heads whole on each rank, as in _decode_attn
    q = A.unsplit(q, 2).reshape(B, 1, kh, g, cfg.head_dim)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), xk.float()) \
        * (cfg.head_dim ** -0.5)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(xv.dtype), xv)
    o = o.reshape(B, 1, cfg.num_heads, cfg.head_dim)
    return x + L.attn_out(bp.xattn, o, x.dtype)


def _decode_mlp(bp, x, cfg, seg: Segment):
    h = L.apply_norm(bp.ln2, x, cfg.norm)
    if seg.kind == "moe":
        return x + MOE.apply_moe(bp.moe, h, cfg)[0]
    return x + L.apply_mlp(bp.mlp, h, cfg)


def forward_decode(params: Transformer, cfg: ModelConfig, tokens, cache):
    """One decode step at ``cache["pos"]``. tokens: (B, 1) -> logits
    (B, 1, V), and the cache with ``pos + 1``; its buffers are updated in
    place.  On DTensor parameters the tokens are a DTensor laid out as
    prefill's (``batch_shardings``)."""
    pos = cache["pos"]
    # a DTensor table's lookup is a masked partial sum, which torch 2.11
    # can reduce only once: reduced here, onto the batch
    x = A.scatter_partial(_embed(params, cfg, tokens), 0)
    for seg, blocks, c in zip(params.plan, params.segments,
                              cache["segments"]):
        if seg.kind == "shared_attn":
            shared = _gathered(params.shared)
            x = _decode_attn(shared, x, cfg, seg, pos, c["k"], c["v"])
            x = _decode_mlp(shared, x, cfg, seg)
            continue
        for li, bp in enumerate(blocks):
            bp = _gathered(bp)
            if seg.kind == "mamba":
                h = L.apply_norm(bp.ln, x, "rmsnorm")
                out, (h_new, conv_new) = M2.mamba2_decode(
                    bp.mixer, h, cfg, (c["h"][li], c["conv"][li]))
                _state_write(c["h"], li, h_new)
                _state_write(c["conv"], li, conv_new)
                x = x + out
                continue
            x = _decode_attn(bp, x, cfg, seg, pos, c["k"][li], c["v"][li])
            if seg.kind == "xattn":
                x = _decode_xattn(bp, x, cfg, c["xk"][li], c["xv"][li])
            x = _decode_mlp(bp, x, cfg, seg)
    logits = _logits(params, cfg, x)
    return logits, {"segments": cache["segments"], "pos": pos + 1}
