"""LLM token-serving driver: batched prefill + greedy decode with the
segment cache, for every architecture of the registry (the audio
family's frame embeddings and the vlm's patch embeddings are drawn, as
the reference's frontend stubs).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
      --smoke --device cpu

Runs on CUDA (prefill attention through the Hopper flash kernel) and
raises without a card unless ``--device cpu`` is given.  Not to be
confused with the graph query server of the JAX package.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_arch, smoke_config
from repro_torch.data import batch_at
from repro_torch.models import (
    Transformer,
    build_plan,
    forward_decode,
    forward_prefill,
    init_cache,
    init_params,
    param_spec,
)


def _device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "serve runs on CUDA and no CUDA device is available; pass "
            "device='cpu' (--device cpu) to run on the CPU")
    return torch.device("cuda")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pad_cache_for_decode(cfg, cache, ctx_len: int, batch: int):
    """Align a prefill cache (lengths = prompt) to decode buffers
    (lengths = ctx or window), preserving position semantics: a full
    buffer holds the history at [0, hlen), an SWA shift buffer (window
    <= ctx) holds its last entries right-aligned.  The sequence axis is
    1 for a shared-attention segment's buffers (no layer axis), else 2;
    an entry already of its decode shape (the mamba state, the encoder's
    k/v) is taken as it is.  An SWA segment whose window exceeds ctx
    decodes into a full buffer (``_decode_attn``), so its history goes
    to [0, hlen) too; the reference right-aligns it there, which
    misplaces the prompt's keys."""
    first = next(iter(cache["segments"][0].values()))
    target = init_cache(cfg, batch, ctx_len, device=first.device)
    for seg, have, want in zip(build_plan(cfg), cache["segments"],
                               target["segments"]):
        for name, buf in want.items():
            t = have[name]
            if t.shape == buf.shape:
                want[name] = t.to(buf.dtype)
                continue
            ax = 1 if t.dim() == 4 else 2
            wlen, hlen = buf.shape[ax], t.shape[ax]
            if seg.window > 0 and wlen == seg.window:
                m = min(wlen, hlen)
                buf.narrow(ax, wlen - m, m).copy_(t.narrow(ax, hlen - m, m))
            else:
                buf.narrow(ax, 0, hlen).copy_(t)
    return {"segments": target["segments"], "pos": cache["pos"]}


def frontend_embeds(cfg, batch: int, device, seed: int = 2) -> dict:
    """The stub frontends' inputs, drawn in f32 from a ``torch.Generator``
    seeded ``seed`` on ``device`` and held in bf16 (the dtype of the
    dry-run's ``input_specs``; the model casts them to bf16 first, so
    nothing of the f32 draw is lost): frame embeddings (batch,
    encoder_seq, d) at scale 0.1 for the audio family, patch embeddings
    (batch, vision_tokens, d) at 0.02 for the vlm (the reference's
    scales); none for the other families."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if cfg.family == "audio":
        return {"enc_embeds": (0.1 * torch.randn(
            (batch, cfg.encoder_seq, cfg.d_model), generator=gen,
            device=device)).to(torch.bfloat16)}
    if cfg.family == "vlm":
        return {"vis_embeds": (0.02 * torch.randn(
            (batch, cfg.vision_tokens, cfg.d_model), generator=gen,
            device=device)).to(torch.bfloat16)}
    return {}


@torch.inference_mode()
def serve(cfg, *, batch: int, prompt_len: int, gen: int, device=None,
          params: Transformer | None = None, extras: dict | None = None):
    """Prefill ``batch`` prompts of ``batch_at(0)`` and greedily decode
    ``gen`` tokens.  ``params`` defaults to weights drawn from a
    ``torch.Generator`` seeded 0 on the device, ``extras`` (the audio and
    vlm inputs) to :func:`frontend_embeds`.  Returns the generated
    tokens (batch, gen) and the times, each read after a synchronize."""
    device = _device(device)
    if params is None:
        gen_ = torch.Generator(device=device).manual_seed(0)
        params = Transformer(cfg, init_params(param_spec(cfg), gen_, device))
    if extras is None:
        extras = frontend_embeds(cfg, batch, device)
    toks = batch_at(0, global_batch=batch, seq_len=prompt_len,
                    vocab_size=cfg.vocab_size).to(device)
    ctx = prompt_len + gen + (cfg.vision_tokens if cfg.family == "vlm"
                              else 0)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = forward_prefill(params, cfg, {"tokens": toks, **extras})
    cache = pad_cache_for_decode(cfg, cache, ctx, batch)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out = []
    tok = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
    t0 = time.perf_counter()
    for _ in range(gen):
        out.append(tok)
        logits, cache = forward_decode(params, cfg, tok, cache)
        tok = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return torch.cat(out, dim=1), {
        "prefill_s": t_prefill, "decode_s": t_decode,
        "tok_per_s": batch * gen / max(t_decode, 1e-9)}


def main():
    ap = argparse.ArgumentParser(
        description="LLM token serving: batched prefill + decode.")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    toks, stats = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                        gen=args.gen, device=args.device)
    print(f"[serve] generated {tuple(toks.shape)} tokens; "
          f"prefill {stats['prefill_s']:.2f}s, "
          f"decode {stats['decode_s']:.2f}s "
          f"({stats['tok_per_s']:.1f} tok/s)")
    print("[serve] sample:", toks[0, :16].tolist())


if __name__ == "__main__":
    main()
