"""Training of the families beyond the dense one (moe, ssm, hybrid,
audio, vlm) against the JAX package's, on the CPU.  The four dense archs
are held to the same checks in ``test_torch_train.py``
(``test_forward_train_loss_and_grads_match_reference``,
``test_train_step_smoke``), so all ten archs are.

Weights come from the reference's ``init_params(param_spec(cfg),
key(0))`` and are carried across as numpy arrays; tokens and the audio
and vlm frontend stubs are drawn from one numpy generator and given to
both packages.

Tolerances.  The smoke models run in bf16 with f32 norms, softmax, CE,
router and SSD state, so the f32 defaults (rtol 1e-4 / atol 1e-5) hold
only where a value is an f32 sum of bf16 terms that both packages
round alike:

  * the loss and ``ce`` within LOSS_TOL = 1e-4 absolute (seen: up to
    8.6e-5 for the MoE, 4e-5 for the rest), and 3e-4 for the ssm and
    hybrid families (seen: 1.7e-4 for both; the SSD's f32 state sums
    bf16 projections, so an ulp of its inputs moves the loss by more);
  * the MoE's aux losses within rtol 1e-4 (seen: 3.5e-5 on the z-loss,
    the mean square of an f32 logsumexp of bf16-fed router logits) and
    its dropped share exactly (routing is the same);
  * each gradient leaf within GRAD_TOL = 3e-2 of the reference's in
    relative norm (seen: 1.8e-2 at most): the dense family's bound in
    ``test_torch_train.py``, the bf16 noise of the gradient itself; the
    hybrid's within 6e-2 (seen: 4.6e-2, on the second mamba segment's
    A_log).  On the hybrid the reference disagrees with itself as much:
    its jitted and its eager gradients differ by up to 5.0e-2 in
    relative norm (the same leaf), as XLA fuses bf16 chains without
    rounding between their steps.
  * a train step's new parameters within 2 x lr of the reference's
    (Adam moves an element by about lr a step; where a gradient is near
    zero its sign can differ), as the dense test.

The reference's launcher cannot train the audio and vlm families (its
token stream yields no frontend stubs: ROADMAP.md section 3); the port's
draws them, and a resumed run of each is bit-identical to an
uninterrupted one.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import SRC
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.configs.registry import ARCHS as REF_ARCHS
from repro.configs.registry import smoke_config as ref_smoke
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import forward_train as ref_forward_train
from repro.models import init_params as ref_init
from repro.models import param_spec as ref_spec
from repro.models.layers import _flash_bwd_impl as ref_flash_bwd
from repro.models.layers import _flash_fwd_impl as ref_flash_fwd
from repro.optim import init_opt_state as ref_init_opt

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import ARCHS, smoke_config
from repro_torch.data import TokenStream
from repro_torch.kernels.flash_attention.ops import flash_attention_kernel
from repro_torch.launch import train as train_mod
from repro_torch.launch.steps import make_train_step, value_and_grad
from repro_torch.models import moe as MOE
from repro_torch.models import layers as L
from repro_torch.optim import init_opt_state
from repro_torch.tree import leaves, tree_map

LOSS_TOL = {"ssm": 3e-4, "hybrid": 3e-4}
LOSS_TOL_DEFAULT = 1e-4
AUX_RTOL = 1e-4
GRAD_TOL = {"hybrid": 6e-2}
GRAD_TOL_DEFAULT = 3e-2
FLASH_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread a worker keeps the test
    workers, which share the cores, from oversubscribing them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _batch(cfg, b=2, s=64, seed=1):
    """Tokens and the family's frontend stubs (f32, the reference's
    scales), as numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.family == "audio":
        out["enc_embeds"] = (0.1 * rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    if cfg.family == "vlm":
        out["vis_embeds"] = (0.02 * rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model))).astype(np.float32)
    return out


def _norm_rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


NON_DENSE = [n for n, c in ARCHS.items() if c.family != "dense"]


@pytest.fixture(scope="module", params=NON_DENSE)
def case(request):
    """One smoke arch: the reference's loss, metrics and gradients, and
    its train step, in one compiled call on its init weights; the
    port's on the carried weights."""
    name = request.param
    cfg, rcfg = smoke_config(name), ref_smoke(name)
    rp = ref_init(ref_spec(rcfg), jax.random.key(0))
    batch = _batch(cfg)
    tc = TrainConfig(total_steps=10, warmup_steps=2)
    rtc = RefTrainConfig(total_steps=10, warmup_steps=2)
    step = ref_make_train_step(rcfg, rtc)

    def both(p, opt, b):
        vg = jax.value_and_grad(
            lambda q: ref_forward_train(q, rcfg, b), has_aux=True)(p)
        return vg, step(p, opt, b)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ((rl, rm), rg), (rp2, _, rsm) = jax.jit(both)(rp, ref_init_opt(rp), jb)
    tree = _torch(_np(rp))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = value_and_grad(cfg, tree, tb)
    p2, opt2, m = make_train_step(cfg, tc)(tree, init_opt_state(tree), tb)
    return {"name": name, "cfg": cfg, "tree": tree, "ref": (rl, rm, rg),
            "got": got, "ref_step": (rp2, rsm), "step": (p2, opt2, m)}


def test_forward_train_matches_reference(case):
    """Loss, metrics (the MoE's aux included) and every gradient leaf of
    ``forward_train`` against the reference's ``jax.value_and_grad``."""
    cfg = case["cfg"]
    rl, rm, rg = case["ref"]
    loss, metrics, grads = case["got"]
    tol = LOSS_TOL.get(cfg.family, LOSS_TOL_DEFAULT)
    assert abs(float(loss) - float(rl)) < tol, (float(loss), float(rl))
    assert set(metrics) == set(rm)
    assert abs(float(metrics["ce"]) - float(rm["ce"])) < tol
    if cfg.family == "moe":
        for k in ("moe_lb_loss", "moe_z_loss"):
            assert float(metrics[k]) == pytest.approx(float(rm[k]),
                                                      rel=AUX_RTOL), k
        assert float(metrics["moe_drop_frac"]) == float(rm["moe_drop_frac"])
        assert float(metrics["moe_drop_frac"]) > 0.0   # drops are exercised
        want = (metrics["ce"] + 0.01 * metrics["moe_lb_loss"]
                + 1e-3 * metrics["moe_z_loss"])
        assert float(loss) == pytest.approx(float(want), rel=1e-6)
    else:
        assert float(metrics["ce"]) == float(loss)
    gtol = GRAD_TOL.get(cfg.family, GRAD_TOL_DEFAULT)
    assert len(leaves(grads)) == len(jax.tree.leaves(rg))
    for a, b in zip(leaves(grads), jax.tree.leaves(rg)):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert torch.isfinite(a).all()
        assert _norm_rel(a.numpy(), b) < gtol, case["name"]


def test_train_step_smoke(case):
    """Port of test_models_smoke.py::test_train_step_smoke for the
    non-dense archs: one step, finite loss in (1, 20), parameters changed and
    finite; and the step's loss, metrics and new parameters against the
    reference's step on the same weights and batch."""
    cfg = case["cfg"]
    p2, opt2, m = case["step"]
    rp2, rm = case["ref_step"]
    loss = float(m["loss"])
    assert np.isfinite(loss) and 1.0 < loss < 20.0, loss
    assert not torch.equal(leaves(case["tree"])[0], leaves(p2)[0])
    assert all(torch.isfinite(leaf).all() for leaf in leaves(p2))
    assert int(opt2.step) == 1
    assert set(m) == set(rm)
    tol = LOSS_TOL.get(cfg.family, LOSS_TOL_DEFAULT)
    assert abs(loss - float(rm["loss"])) < tol
    gtol = GRAD_TOL.get(cfg.family, GRAD_TOL_DEFAULT)
    assert abs(float(m["grad_norm"]) - float(rm["grad_norm"])) \
        < gtol * float(rm["grad_norm"])
    lr = float(rm["lr"])
    for a, b in zip(leaves(p2), jax.tree.leaves(rp2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2 * lr)


def test_grad_accum_splits_frontend_stubs():
    """grad_accum 2 against 1 on one global batch of the vlm (the stubs
    split with the tokens along the batch axis), as
    test_models_smoke.py::test_grad_accum_equivalence does for tokens."""
    cfg = smoke_config("internvl2-1b")
    tree = _torch(_np(ref_init(ref_spec(ref_smoke("internvl2-1b")),
                               jax.random.key(0))))
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, 4, 32, 3).items()}
    outs = {}
    for accum in (1, 2):
        tc = TrainConfig(total_steps=10, warmup_steps=2, grad_accum=accum)
        p2, _, m = make_train_step(cfg, tc)(tree, init_opt_state(tree), b)
        outs[accum] = (p2, float(m["loss"]))
    assert abs(outs[1][1] - outs[2][1]) < 1e-3
    for a, b_ in zip(leaves(outs[1][0]), leaves(outs[2][0])):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=2e-4,
                                   rtol=2e-3)


def test_moe_routing_replays_under_autograd():
    """``route(choices=)`` in training: one run's top-k choices, recorded
    from its forward (and remat recompute) and replayed into another run
    on the same weights, give that run's loss and gradients bit for bit;
    and a capacity drop (the one-hot's zero row) carries no gradient."""
    cfg = smoke_config("phi3.5-moe-42b-a6.6b")
    tree = _torch(_np(ref_init(ref_spec(ref_smoke(cfg.name)),
                               jax.random.key(0))))
    b = {"tokens": torch.from_numpy(_batch(cfg)["tokens"])}
    orig, seen = MOE.route, []

    def record(router, x, E, K, C, choices=None):
        r = orig(router, x, E, K, C, choices)
        seen.append(r["gate_idx"].detach().clone())
        return r

    MOE.route = record
    try:
        l1, m1, g1 = value_and_grad(cfg, tree, b)
    finally:
        MOE.route = orig
    assert len(seen) == 2 * cfg.num_layers    # forward and recompute
    it = iter(seen)
    MOE.route = lambda router, x, E, K, C, choices=None: orig(
        router, x, E, K, C, choices=next(it))
    try:
        l2, m2, g2 = value_and_grad(cfg, tree, b)
    finally:
        MOE.route = orig
    assert torch.equal(l1, l2) and float(m1["moe_drop_frac"]) > 0
    for a, c in zip(leaves(g1), leaves(g2)):
        assert torch.equal(a, c)
    x = torch.randn((1, 16, cfg.d_model), requires_grad=True)
    r = MOE.route(tree["segments"][0]["moe"]["router"][0], x,
                  cfg.num_experts, cfg.num_experts_per_tok, 1)
    assert not r["dispatch"].requires_grad
    assert float(r["kept"].sum()) < 16 * cfg.num_experts_per_tok


# (B, Sq, Sk, H, D, causal): whisper's encoder (non-causal, square) and
# cross attention (Sq != Sk), zamba2's head dim 112, phi3.5-moe's 128
FLASH_SHAPES = [(1, 48, 48, 2, 16, False), (2, 32, 80, 2, 16, False),
                (1, 40, 40, 2, 112, True), (1, 64, 64, 4, 128, True)]


@pytest.mark.parametrize("b,sq,sk,h,d,causal", FLASH_SHAPES)
def test_flash_lse_and_backward_at_family_shapes(b, sq, sk, h, d, causal):
    """The training forward's lse (the kernel wrapper's route, ref.py on
    the CPU) and ``_flash_bwd_impl`` at the families' attention kinds,
    against the reference's ``_flash_fwd_impl``/``_flash_bwd_impl``, over
    several q and kv blocks."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, h, d)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    kw = dict(causal=causal, window=0, softcap=0.0, q_chunk=16, kv_chunk=32)
    r_out, r_lse = ref_flash_fwd(q, k, v, **kw)
    o, lse = flash_attention_kernel(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal, return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(r_out), atol=FLASH_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(r_lse),
                               atol=FLASH_TOL)
    want = ref_flash_bwd(q, k, v, r_out, r_lse, do, **kw)
    got = L._flash_bwd_impl(*map(torch.from_numpy, (
        q, k, v, np.array(r_out), np.array(r_lse), do)), **kw)
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=FLASH_TOL)


# ---------------- the launcher ----------------
def _tc(d, every=2):
    return TrainConfig(learning_rate=1e-3, total_steps=6, warmup_steps=2,
                       checkpoint_dir=str(d), checkpoint_every=every)


@pytest.mark.parametrize("name", ["whisper-small", "internvl2-1b"])
def test_train_resume_bitexact(name, tmp_path):
    """The launcher trains the audio and vlm families with stubs drawn
    from ``(seed, step)``: interrupted at step 3 and resumed from the
    step-2 checkpoint, the state equals the uninterrupted run's bit for
    bit, and so does a run that drops its state at step 3 and replays."""
    cfg = smoke_config(name)
    kw = dict(batch=2, seq=32, log_every=100, device="cpu")
    p_full, o_full, _ = train_mod.train(cfg, _tc(tmp_path / "a"), steps=4,
                                        resume=False, **kw)
    train_mod.train(cfg, _tc(tmp_path / "b"), steps=3, resume=False, **kw)
    p_res, o_res, _ = train_mod.train(cfg, _tc(tmp_path / "b"), steps=4,
                                      resume=True, **kw)
    p_sim, _, _ = train_mod.train(cfg, _tc(tmp_path / "c"), steps=4,
                                  resume=False, simulate_failure=3, **kw)
    for a, b, c in zip(leaves(p_full), leaves(p_res), leaves(p_sim)):
        assert torch.equal(a, b) and torch.equal(a, c)
    for a, b in zip(leaves(o_full), leaves(o_res)):
        assert torch.equal(a, b)


def test_next_batch_draws_stubs_from_seed_and_step():
    cfg = smoke_config("whisper-small")
    tc = TrainConfig(seed=3)
    s1 = TokenStream(global_batch=2, seq_len=8, vocab_size=cfg.vocab_size)
    s2 = TokenStream(global_batch=2, seq_len=8, vocab_size=cfg.vocab_size)
    a0, a1 = (train_mod.next_batch(s1, cfg, tc, "cpu") for _ in range(2))
    s2.restore(1)
    b1 = train_mod.next_batch(s2, cfg, tc, "cpu")
    assert a0["enc_embeds"].dtype == torch.bfloat16
    assert tuple(a0["enc_embeds"].shape) == (2, cfg.encoder_seq,
                                              cfg.d_model)
    assert torch.equal(a1["enc_embeds"], b1["enc_embeds"])
    assert torch.equal(a1["tokens"], b1["tokens"])
    assert not torch.equal(a0["enc_embeds"], a1["enc_embeds"])
    assert set(train_mod.next_batch(s1, smoke_config("mamba2-1.3b"), tc,
                                    "cpu")) == {"tokens"}


_REF_LAUNCHER = r"""
from repro.configs.base import TrainConfig
from repro.configs.registry import smoke_config
from repro.launch.train import train
for name in ("whisper-small", "internvl2-1b"):
    tc = TrainConfig(total_steps=2, warmup_steps=1, checkpoint_every=0,
                     checkpoint_dir={ckpt!r} + name)
    try:
        train(smoke_config(name), tc, batch=2, seq=64, steps=1,
              resume=False)
        print("TRAINED", name)
    except Exception as e:
        print("FAILED", name, type(e).__name__, str(e)[:120])
"""


def test_reference_launcher_fails_where_port_trains(tmp_path):
    """The reference's ``launch/train.py`` fails on the audio and vlm
    smoke configs (KeyError 'enc_embeds'; a reshape of the text-only
    positions to the vision + text length), in a subprocess; the port's
    launcher trains both, with finite losses."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF_LAUNCHER.format(
        ckpt=str(tmp_path / "ref_"))], env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "FAILED whisper-small KeyError 'enc_embeds'" in r.stdout, r.stdout
    assert "FAILED internvl2-1b TypeError" in r.stdout \
        and "reshape" in r.stdout, r.stdout
    for name in ("whisper-small", "internvl2-1b"):
        tc = TrainConfig(total_steps=2, warmup_steps=1, checkpoint_every=0,
                         checkpoint_dir=str(tmp_path / name))
        _, _, losses = train_mod.train(smoke_config(name), tc, batch=2,
                                       seq=64, steps=2, resume=False,
                                       log_every=1, device="cpu")
        assert [s for s, _ in losses] == [0, 1]
        assert all(np.isfinite(x) and 1.0 < x < 20.0 for _, x in losses)


def test_registry_lists_the_ten_archs():
    assert list(ARCHS) == list(REF_ARCHS)
    assert len(NON_DENSE) == 6
