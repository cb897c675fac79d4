"""The port's model families beyond the dense one (moe, ssm, hybrid,
audio, vlm) and its serving driver against the JAX package, on the same
weights (carried across by ``params_from_arrays`` from JAX
``init_params(param_spec(cfg), key(0))``), the same tokens and the same
frontend embeddings (the reference serve's ``key(2)`` draws).

Tolerances.  Both packages run in bf16 with f32 softmax, norms, router
and SSD state; XLA fuses bf16 chains under jit without rounding between
their steps, where torch rounds every op, so a bf16 value may differ by
an ulp and the difference grows with depth.  The smoke models' logits
stay below 1 in magnitude (one bf16 ulp 3.9e-3):

  * moe, audio, vlm (two decoder blocks; whisper's two encoder blocks
    before them): LOGIT_TOL 5e-3, one ulp, as the dense family's test;
  * ssm (two mamba blocks): 1e-2; the SSD's f32 state sums bf16
    projections, so an ulp of its inputs moves it by more (seen:
    5.0e-3);
  * hybrid (six mamba blocks and two shared-attention calls): 2e-2
    (seen: 1.2e-2).

Neither package differs from the other on one block: eagerly, the JAX
block and the port's give the same bits on the same bf16 input.

Cached k/v, the conv state and the encoder's k/v stay below 1 (one ulp
3.9e-3, seen: up to 3.9e-3 apart; the hybrid's 1.0e-2): CACHE_TOL
1.6e-2, the dense family's bound, admits four ulps, the hybrid's 3e-2
eight.  The f32 SSM state ``h`` is held within H_RTOL = 5% of its
largest magnitude: it integrates bf16 inputs over the prompt (seen:
1.0% for mamba2, 2.7% for the hybrid).

Served tokens must be equal.  Each serve case was chosen so that every
greedy step's top-2 logit margin in the JAX run exceeds 2 x the arch's
tolerance, which the test asserts: the port's logits are within the
tolerance of the reference's entry by entry, so two entries cannot swap.

The reference's ``serve`` decodes the vlm from ``pos`` = the text
length, while its cache holds the vision tokens too: decode then writes
over the prompt's last keys and ropes at the wrong position.  The port
counts the vision tokens; its vlm is held against the reference's
``forward_prefill``/``forward_decode`` with the cache's ``pos`` set to
vision + text tokens, and against its own prefill of the longer prompt
(``test_vlm_decode_continues_after_vision_tokens``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as REF_ARCHS
from repro.configs.registry import smoke_config as jax_smoke
from repro.launch.serve import pad_cache_for_decode as jax_pad
from repro.launch.serve import serve as jax_serve
from repro.models import forward_decode as jax_decode
from repro.models import forward_prefill as jax_prefill
from repro.models import init_params as jax_init
from repro.models import param_count as jax_param_count
from repro.models import param_spec as jax_spec
from repro.models import layers as JL
from repro.models.model import build_plan as jax_plan

from repro_torch.configs.registry import ARCHS, smoke_config
from repro_torch.data import batch_at
from repro_torch.launch import train as train_mod
from repro_torch.launch.serve import (frontend_embeds, pad_cache_for_decode,
                                      serve)
from repro_torch.configs.base import TrainConfig
from repro_torch.models import (
    Transformer,
    build_plan,
    forward_decode,
    forward_prefill,
    init_cache,
    init_params,
    param_count,
    param_spec,
    params_from_arrays,
    params_to_arrays,
)
from repro_torch.models import layers as L

LOGIT_TOL = {"moe": 5e-3, "audio": 5e-3, "vlm": 5e-3, "ssm": 1e-2,
             "hybrid": 2e-2}
CACHE_TOL = {"hybrid": 3e-2}
CACHE_TOL_DEFAULT = 1.6e-2
H_RTOL = 5e-2

# arch -> (batch, prompt_len, gen) of the serve comparison; ssm prompts
# are multiples of the smoke ssm_chunk (32), so prefill runs two chunks
CASES = {
    "phi3.5-moe-42b-a6.6b": (2, 16, 4),
    "dbrx-132b": (2, 44, 4),
    "mamba2-1.3b": (2, 64, 4),
    "zamba2-7b": (1, 64, 4),
    "whisper-small": (2, 32, 4),
    "internvl2-1b": (2, 24, 4),
}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _ref_extras(cfg, batch):
    """The reference serve's frontend draws."""
    if cfg.family == "audio":
        return {"enc_embeds": 0.1 * jax.random.normal(
            jax.random.key(2), (batch, cfg.encoder_seq, cfg.d_model))}
    if cfg.family == "vlm":
        return {"vis_embeds": 0.02 * jax.random.normal(
            jax.random.key(2), (batch, cfg.vision_tokens, cfg.d_model))}
    return {}


def _torch_extras(extras):
    return {k: torch.from_numpy(np.array(v)) for k, v in extras.items()}


def _vis(cfg):
    return cfg.vision_tokens if cfg.family == "vlm" else 0


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    """One arch: the JAX serve run, its prefill and its decode steps
    teacher-forced along the served tokens, and the port's model."""
    name = request.param
    batch, prompt_len, gen = CASES[name]
    jcfg, cfg = jax_smoke(name), smoke_config(name)
    jparams = jax_init(jax_spec(jcfg), jax.random.key(0))
    model = params_from_arrays(cfg, jax.tree.map(np.asarray, jparams))
    extras = _ref_extras(jcfg, batch)
    toks = batch_at(0, global_batch=batch, seq_len=prompt_len,
                    vocab_size=cfg.vocab_size).numpy()
    logits, cache = jax.jit(lambda p, b: jax_prefill(p, jcfg, b))(
        jparams, {"tokens": jnp.asarray(toks), **extras})
    dec = jax.jit(lambda p, t, c: jax_decode(p, jcfg, t, c))
    vis = _vis(cfg)
    c = jax_pad(jcfg, cache, prompt_len + gen + vis, batch)
    c["pos"] = jnp.int32(prompt_len + vis)     # the vlm's fix; else equal
    steps = [_f32(logits)]
    if cfg.family == "vlm":
        # greedy along the reference's functions at the right position
        served = []
        lg = logits
        for _ in range(gen):
            served.append(np.asarray(jnp.argmax(lg[:, -1:], -1), np.int32))
            lg, c = dec(jparams, jnp.asarray(served[-1]), c)
            steps.append(_f32(lg))
        served = np.concatenate(served, axis=1)
    else:
        served, _ = jax_serve(jcfg, batch=batch, prompt_len=prompt_len,
                              gen=gen)
        served = np.array(served)
        for t in range(gen):
            lg, c = dec(jparams, jnp.asarray(served[:, t:t + 1]), c)
            steps.append(_f32(lg))
    return {"name": name, "cfg": cfg, "jcfg": jcfg, "model": model,
            "toks": toks, "extras": extras, "served": served,
            "cache": cache, "steps": steps, "batch": batch,
            "prompt_len": prompt_len, "gen": gen,
            "tol": LOGIT_TOL[cfg.family]}


def _prefill(run):
    return forward_prefill(run["model"], run["cfg"], {
        "tokens": torch.from_numpy(run["toks"]),
        **_torch_extras(run["extras"])})


def test_plan_and_param_count_match(run):
    cfg, jcfg = run["cfg"], run["jcfg"]
    assert [(s.kind, s.count, s.window, s.causal, s.shared_index)
            for s in build_plan(cfg)] == \
        [(s.kind, s.count, s.window, s.causal, s.shared_index)
         for s in jax_plan(jcfg)]
    assert param_count(param_spec(cfg)) == jax_param_count(jax_spec(jcfg))


@torch.inference_mode()
def test_prefill_logits_and_cache_match(run):
    cfg = run["cfg"]
    logits, cache = _prefill(run)
    np.testing.assert_allclose(_f32(logits), run["steps"][0],
                               atol=run["tol"], rtol=0)
    assert cache["pos"] == run["prompt_len"] + _vis(cfg)
    ctol = CACHE_TOL.get(cfg.family, CACHE_TOL_DEFAULT)
    assert len(cache["segments"]) == len(run["cache"]["segments"])
    for got, want in zip(cache["segments"], run["cache"]["segments"]):
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            g = got[name]
            assert tuple(g.shape) == tuple(w.shape), name
            if name == "h":
                assert g.dtype == torch.float32
                scale = float(np.abs(_f32(w)).max())
                np.testing.assert_allclose(_f32(g), _f32(w),
                                           atol=H_RTOL * scale, rtol=0)
            else:
                assert g.dtype == torch.bfloat16, name
                np.testing.assert_allclose(_f32(g), _f32(w), atol=ctol,
                                           rtol=0)


@torch.inference_mode()
def test_decode_steps_match_teacher_forced(run):
    cfg = run["cfg"]
    batch, prompt_len, gen = run["batch"], run["prompt_len"], run["gen"]
    _, cache = _prefill(run)
    cache = pad_cache_for_decode(cfg, cache, prompt_len + gen + _vis(cfg),
                                 batch)
    for t in range(gen):
        lg, cache = forward_decode(
            run["model"], cfg, torch.from_numpy(run["served"][:, t:t + 1]),
            cache)
        np.testing.assert_allclose(_f32(lg), run["steps"][t + 1],
                                   atol=run["tol"], rtol=0)
    assert cache["pos"] == prompt_len + gen + _vis(cfg)


def test_served_tokens_equal_reference(run):
    for lg in run["steps"][:run["gen"]]:
        top2 = np.sort(lg[:, -1], axis=-1)[:, -2:]
        margin = float((top2[:, 1] - top2[:, 0]).min())
        assert margin > 2 * run["tol"], (run["name"], margin)
    toks, stats = serve(run["cfg"], batch=run["batch"],
                        prompt_len=run["prompt_len"], gen=run["gen"],
                        device="cpu", params=run["model"],
                        extras=_torch_extras(run["extras"]))
    assert toks.dtype == torch.int32
    np.testing.assert_array_equal(toks.numpy(), run["served"])
    assert stats["prefill_s"] > 0 and stats["tok_per_s"] > 0


# (arch, prompt prefilled before decoding; 0 = decode from init_cache as
# the reference's test does).  The encoder memory and the vision tokens
# enter through prefill, so audio and vlm prefill a prefix first.
EQUIV = (("mamba2-1.3b", 0), ("zamba2-7b", 0), ("phi3.5-moe-42b-a6.6b", 0),
         ("dbrx-132b", 0), ("whisper-small", 8), ("internvl2-1b", 8))


@pytest.mark.parametrize("name,p0", EQUIV)
@torch.inference_mode()
def test_prefill_decode_equivalence(name, p0):
    """Decode step by step reproduces prefill logits at the last position
    (the port of the reference's test, same tolerance).  The MoE runs
    at a capacity factor of E / K, which fits every token: at decode each
    token is its own group, so a prefill that dropped a token over
    capacity computes another function."""
    cfg = smoke_config(name)
    if cfg.family == "moe":
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    model = Transformer(cfg, init_params(param_spec(cfg),
                                         torch.Generator().manual_seed(0),
                                         "cpu"))
    S = 16
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32))
    extras = frontend_embeds(cfg, 2, "cpu")
    lg_p, _ = forward_prefill(model, cfg, {"tokens": toks, **extras})
    if p0:
        _, cache = forward_prefill(model, cfg,
                                   {"tokens": toks[:, :p0], **extras})
        cache = pad_cache_for_decode(cfg, cache, S + _vis(cfg), 2)
    else:
        cache = init_cache(cfg, 2, S, device="cpu")
    for t in range(p0, S):
        lg_d, cache = forward_decode(model, cfg, toks[:, t:t + 1], cache)
    np.testing.assert_allclose(_f32(lg_p), _f32(lg_d), atol=0.05, rtol=0.05)


@torch.inference_mode()
def test_vlm_decode_continues_after_vision_tokens():
    """After a prefill over vision + text tokens, each decode step equals
    a prefill over the longer prompt: the cache's ``pos`` counts the
    vision tokens (the reference's does not)."""
    cfg = smoke_config("internvl2-1b")
    model = Transformer(cfg, init_params(param_spec(cfg),
                                         torch.Generator().manual_seed(0),
                                         "cpu"))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32))
    extras = frontend_embeds(cfg, 2, "cpu")
    _, cache = forward_prefill(model, cfg, {"tokens": toks[:, :16],
                                            **extras})
    assert cache["pos"] == cfg.vision_tokens + 16
    cache = pad_cache_for_decode(cfg, cache, cfg.vision_tokens + 24, 2)
    for t in range(16, 24):
        lg_d, cache = forward_decode(model, cfg, toks[:, t:t + 1], cache)
        lg_p, _ = forward_prefill(model, cfg, {"tokens": toks[:, :t + 1],
                                               **extras})
        np.testing.assert_allclose(_f32(lg_d), _f32(lg_p), atol=0.05,
                                   rtol=0.05)


@pytest.mark.parametrize("name", list(ARCHS))
def test_weights_round_trip_byte_for_byte(name):
    """params_to_arrays(params_from_arrays(tree)) is the reference's
    init_params tree, leaf for leaf and byte for byte, every family's
    blocks, shared block and encoder included."""
    jcfg, cfg = jax_smoke(name), smoke_config(name)
    tree = jax.tree.map(np.asarray,
                        jax_init(jax_spec(jcfg), jax.random.key(0)))
    back = params_to_arrays(cfg, params_from_arrays(cfg, tree))
    want, want_def = jax.tree.flatten_with_path(tree)
    got, got_def = jax.tree.flatten_with_path(back)
    assert got_def == want_def
    for (gp, g), (wp, w) in zip(got, want):
        assert gp == wp
        assert g.dtype == np.float32 and g.shape == w.shape, gp
        assert g.tobytes() == np.asarray(w, np.float32).tobytes(), gp


def test_registry_covers_every_arch():
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    assert {c.family for c in ARCHS.values()} == {
        "dense", "moe", "ssm", "hybrid", "audio", "vlm"}


def test_arange_neg_init_matches_reference():
    """mamba's A_log: log(1 .. H), the reference's ``arange_neg``."""
    cfg = smoke_config("mamba2-1.3b")
    tree = init_params(param_spec(cfg), torch.Generator().manual_seed(0),
                       "cpu")
    ref = jax_init(jax_spec(jax_smoke("mamba2-1.3b")), jax.random.key(0))
    a = tree["segments"][0]["mixer"]["A_log"]
    assert tuple(a.shape) == (cfg.num_layers, cfg.ssm_nheads)
    np.testing.assert_allclose(
        a.numpy(), np.asarray(ref["segments"][0]["mixer"]["A_log"]),
        rtol=1e-7, atol=0)


@pytest.mark.parametrize("impl", ["chunked", "naive"])
@torch.inference_mode()
def test_cross_attention_block_matches_reference(impl):
    """attention_block with ``kv=``: q from x, k/v from the memory
    without RoPE, unmasked, Sq != Sk."""
    jcfg, cfg = jax_smoke("whisper-small"), smoke_config("whisper-small")
    rng = np.random.default_rng(3)
    p = {k: (0.2 * rng.standard_normal(s.shape)).astype(np.float32)
         for k, s in L.attn_spec(cfg).items()}
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    want, (wk, wv) = JL.attention_block(
        {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(x, jnp.bfloat16), jcfg, positions=jnp.arange(12),
        impl=impl, kv=jnp.asarray(mem, jnp.bfloat16))
    got, (gk, gv) = L.attention_block(
        {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(x).to(torch.bfloat16), cfg,
        positions=torch.arange(12), impl=impl,
        kv=torch.from_numpy(mem).to(torch.bfloat16))
    assert tuple(gk.shape) == (2, 24, cfg.num_kv_heads, cfg.head_dim)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        scale = float(np.abs(_f32(w)).max())
        np.testing.assert_allclose(_f32(g), _f32(w), atol=2 ** -7 * scale,
                                   rtol=0)


@pytest.mark.parametrize("name", ["whisper-small", "internvl2-1b"])
def test_serve_draws_frontend_inputs(name):
    """Without ``extras`` serve draws the stub frontend's embeddings from
    a seeded generator on the device, at the reference's scales, held in
    bf16 (the model's first cast)."""
    cfg = smoke_config(name)
    ex = frontend_embeds(cfg, 2, "cpu")
    (key, t), = ex.items()
    scale = 0.1 if cfg.family == "audio" else 0.02
    n = cfg.encoder_seq if cfg.family == "audio" else cfg.vision_tokens
    assert tuple(t.shape) == (2, n, cfg.d_model) and t.dtype == torch.bfloat16
    assert abs(float(t.float().std()) - scale) < 0.2 * scale
    assert torch.equal(t, frontend_embeds(cfg, 2, "cpu")[key])
    toks, _ = serve(cfg, batch=2, prompt_len=8, gen=3, device="cpu")
    assert tuple(toks.shape) == (2, 3)
    assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())


@pytest.mark.parametrize("name", [n for n, c in ARCHS.items()
                                  if c.family != "dense"])
def test_train_refuses_other_families(name, tmp_path):
    """The training launcher no longer refuses the other families: each
    trains a step from weights it draws (the audio and vlm families with
    the stub frontends' embeddings it draws), to a finite loss.  Their
    parity with the reference is in test_torch_train_families.py."""
    tc = TrainConfig(total_steps=2, warmup_steps=1, checkpoint_every=0,
                     checkpoint_dir=str(tmp_path))
    _, _, losses = train_mod.train(smoke_config(name), tc, batch=1, seq=32,
                                   steps=1, log_every=1, device="cpu")
    assert [s for s, _ in losses] == [0]
    assert np.isfinite(losses[0][1]) and 1.0 < losses[0][1] < 20.0
