"""The port's dense-family model and serving driver against the JAX
package (the other families: ``test_torch_families.py``), on the same weights (carried across by ``params_from_arrays``
from JAX ``init_params(param_spec(cfg), key(0))``) and the same tokens.

Tolerances.  Both run in bf16 with f32 softmax and norms; they add in
other orders, so a bf16 value may differ by one ulp.  The smoke models'
logits stay below 1 in magnitude, where one bf16 ulp is 3.9e-3:
LOGIT_TOL = 5e-3 admits one ulp and not two.  Cached k/v reach about 2
(one ulp 7.8e-3): CACHE_TOL = 1.6e-2 admits two.  Served tokens must be
equal, and each serve case below was chosen so that every greedy step's
top-2 logit margin in the JAX run exceeds 4 x LOGIT_TOL, which the test
asserts: equal tokens are then not luck.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke
from repro.launch.serve import pad_cache_for_decode as jax_pad
from repro.launch.serve import serve as jax_serve
from repro.models import forward_decode as jax_decode
from repro.models import forward_prefill as jax_prefill
from repro.models import init_params as jax_init
from repro.models import param_count as jax_param_count
from repro.models import param_spec as jax_spec
from repro.models.model import build_plan as jax_plan

from repro_torch.configs.registry import ARCHS, smoke_config
from repro_torch.data import batch_at
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.serve import pad_cache_for_decode, serve
from repro_torch.models import (
    Transformer,
    build_plan,
    forward_decode,
    forward_prefill,
    forward_train,
    init_cache,
    init_params,
    param_count,
    param_spec,
    params_from_arrays,
)

LOGIT_TOL = 5e-3
CACHE_TOL = 1.6e-2

# arch -> (batch, prompt_len, gen) of the serve comparison; prompts are
# longer than the SWA smoke windows (danube3 32, gemma3 16)
CASES = {
    "tinyllama-1.1b": (2, 49, 5),
    "qwen2.5-32b": (2, 49, 5),
    "h2o-danube-3-4b": (2, 79, 4),
    "gemma3-27b": (1, 38, 7),
}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    """One arch: the JAX serve run, its prefill and its decode steps
    teacher-forced along the served tokens, and the port's model."""
    name = request.param
    batch, prompt_len, gen = CASES[name]
    jcfg, cfg = jax_smoke(name), smoke_config(name)
    jparams = jax_init(jax_spec(jcfg), jax.random.key(0))
    model = params_from_arrays(cfg, jax.tree.map(np.asarray, jparams))
    served, _ = jax_serve(jcfg, batch=batch, prompt_len=prompt_len, gen=gen)
    served = np.array(served)
    toks = batch_at(0, global_batch=batch, seq_len=prompt_len,
                    vocab_size=cfg.vocab_size).numpy()
    logits, cache = jax.jit(lambda p, b: jax_prefill(p, jcfg, b))(
        jparams, {"tokens": jnp.asarray(toks)})
    steps = [_f32(logits)]
    dec = jax.jit(lambda p, t, c: jax_decode(p, jcfg, t, c))
    c = jax_pad(jcfg, cache, prompt_len + gen, batch)
    for t in range(gen):
        lg, c = dec(jparams, jnp.asarray(served[:, t:t + 1]), c)
        steps.append(_f32(lg))
    return {"name": name, "cfg": cfg, "jcfg": jcfg, "model": model,
            "toks": toks, "served": served, "cache": cache, "steps": steps,
            "batch": batch, "prompt_len": prompt_len, "gen": gen}


def test_plan_and_param_count_match(run):
    cfg, jcfg = run["cfg"], run["jcfg"]
    assert [(s.kind, s.count, s.window, s.causal) for s in build_plan(cfg)] \
        == [(s.kind, s.count, s.window, s.causal) for s in jax_plan(jcfg)]
    assert param_count(param_spec(cfg)) == jax_param_count(jax_spec(jcfg))


@torch.inference_mode()
def test_prefill_logits_and_cache_match(run):
    cfg, model = run["cfg"], run["model"]
    logits, cache = forward_prefill(model, cfg,
                                    {"tokens": torch.from_numpy(run["toks"])})
    np.testing.assert_allclose(_f32(logits), run["steps"][0],
                               atol=LOGIT_TOL, rtol=0)
    assert cache["pos"] == int(run["cache"]["pos"])
    for got, want in zip(cache["segments"], run["cache"]["segments"]):
        for name in ("k", "v"):
            assert got[name].dtype == torch.bfloat16
            np.testing.assert_allclose(_f32(got[name]), _f32(want[name]),
                                       atol=CACHE_TOL, rtol=0)


@torch.inference_mode()
def test_decode_steps_match_teacher_forced(run):
    cfg, model = run["cfg"], run["model"]
    batch, prompt_len, gen = run["batch"], run["prompt_len"], run["gen"]
    _, cache = forward_prefill(model, cfg,
                               {"tokens": torch.from_numpy(run["toks"])})
    cache = pad_cache_for_decode(cfg, cache, prompt_len + gen, batch)
    for t in range(gen):
        lg, cache = forward_decode(
            model, cfg, torch.from_numpy(run["served"][:, t:t + 1]), cache)
        np.testing.assert_allclose(_f32(lg), run["steps"][t + 1],
                                   atol=LOGIT_TOL, rtol=0)
    assert cache["pos"] == prompt_len + gen


def test_served_tokens_equal_reference(run):
    # the tokens are decided by steps 0 .. gen-1 (the last step's argmax
    # is not served)
    for lg in run["steps"][:run["gen"]]:
        top2 = np.sort(lg[:, -1], axis=-1)[:, -2:]
        margin = float((top2[:, 1] - top2[:, 0]).min())
        assert margin > 4 * LOGIT_TOL, (run["name"], margin)
    toks, stats = serve(run["cfg"], batch=run["batch"],
                        prompt_len=run["prompt_len"], gen=run["gen"],
                        device="cpu", params=run["model"])
    assert toks.dtype == torch.int32
    np.testing.assert_array_equal(toks.numpy(), run["served"])
    assert stats["prefill_s"] > 0 and stats["tok_per_s"] > 0


@pytest.mark.parametrize("name", list(CASES))
@torch.inference_mode()
def test_prefill_decode_equivalence(name):
    """Decode step by step reproduces prefill logits at the last position
    (the port of the reference's test, same tolerance)."""
    cfg = smoke_config(name)
    gen = torch.Generator().manual_seed(0)
    model = Transformer(cfg, init_params(param_spec(cfg), gen, "cpu"))
    S = 16
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32))
    lg_p, _ = forward_prefill(model, cfg, {"tokens": toks})
    cache = init_cache(cfg, 2, S, device="cpu")
    for t in range(S):
        lg_d, cache = forward_decode(model, cfg, toks[:, t:t + 1], cache)
    np.testing.assert_allclose(_f32(lg_p), _f32(lg_d), atol=0.05, rtol=0.05)


@torch.inference_mode()
def test_swa_window_longer_than_context_decodes_right():
    """danube3's smoke window (32) exceeds ctx (16 + 8): decode runs on a
    full buffer, so the prompt's keys must sit at [0, 16).  Each decode
    step then equals a prefill over the longer sequence (the reference
    right-aligns them there and does not)."""
    cfg = smoke_config("h2o-danube-3-4b")
    model = Transformer(cfg, init_params(param_spec(cfg),
                                         torch.Generator().manual_seed(0),
                                         "cpu"))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32))
    _, cache = forward_prefill(model, cfg, {"tokens": toks[:, :16]})
    cache = pad_cache_for_decode(cfg, cache, 24, 2)
    assert cache["segments"][0]["k"].shape[2] == 24
    for t in range(16, 24):
        lg_d, cache = forward_decode(model, cfg, toks[:, t:t + 1], cache)
        lg_p, _ = forward_prefill(model, cfg, {"tokens": toks[:, :t + 1]})
        np.testing.assert_allclose(_f32(lg_d), _f32(lg_p), atol=0.05,
                                   rtol=0.05)


@pytest.mark.parametrize("name", [n for n, c in ARCHS.items()
                                  if c.family != "dense"])
def test_other_families_raise(name):
    """forward_train runs the other families now (their parity with the
    reference is in tests/test_torch_train_families.py): a finite loss,
    the same with and without remat; the audio and vlm families raise a
    KeyError naming the frontend stub a batch of tokens alone lacks."""
    cfg = smoke_config(name)
    tree = init_params(param_spec(cfg), torch.Generator().manual_seed(0),
                       "cpu")
    batch = {"tokens": torch.zeros((1, 32), dtype=torch.int32)}
    stub = {"audio": ("enc_embeds", cfg.encoder_seq),
            "vlm": ("vis_embeds", cfg.vision_tokens)}.get(cfg.family)
    if stub is not None:
        with pytest.raises(KeyError, match=stub[0]):
            forward_train(tree, cfg, batch)
        batch[stub[0]] = torch.zeros((1, stub[1], cfg.d_model))
    loss, metrics = forward_train(tree, cfg, batch)
    assert torch.isfinite(loss) and float(metrics["ce"]) > 0
    assert torch.equal(forward_train(tree, cfg, batch, remat=False)[0], loss)


def test_serve_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(serve_mod.torch.cuda, "is_available", lambda: False)
    cfg = smoke_config("tinyllama-1.1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(cfg, batch=1, prompt_len=4, gen=1)
    toks, _ = serve(cfg, batch=1, prompt_len=4, gen=2, device="cpu")
    assert tuple(toks.shape) == (1, 2)
    assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())


def test_init_cache_needs_a_card_unless_told_cpu(monkeypatch):
    """init_cache defaults to the card, like every other entry point:
    without one it raises, naming device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config("tinyllama-1.1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 2, 8)
    cache = init_cache(cfg, 2, 8, device="cpu")
    k = cache["segments"][0]["k"]
    assert k.device.type == "cpu" and k.dtype == torch.bfloat16
    assert k.shape[1:3] == (2, 8) and cache["pos"] == 0
