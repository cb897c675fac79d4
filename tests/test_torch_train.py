"""The port's training slice against the JAX package's, on the CPU.

Weights, tokens and optimizer trees are carried across as numpy arrays
(``params_to_arrays`` / ``params_from_arrays``, the checkpoint files), so
both packages run on the same values.

Tolerances, and why:

  * flash attention in f32 (forward, lse, backward): 2e-5 absolute, the
    reference's flash-vs-naive bound (sums run in other orders); the
    gradients against naive attention 5e-5, as ``test_layers.py``.
  * bf16 models: the loss within 1e-4 of the reference's (both reduce
    an f32 cross-entropy; seen: 4e-5); each gradient leaf within 3e-2 of
    the reference's in relative norm.  The gradients are bf16 products
    and sums: bias gradients sum 128 bf16 terms and differ by up to 1.9%
    between the two packages, and by as much between the port's naive
    and chunked attention on the same weights, so 3e-2 is the bf16 noise
    of the gradient itself (one bf16 ulp is 0.39%).
  * AdamW on f32 trees: 1e-6 (the same f32 arithmetic; XLA's and
    torch's pow and cos may differ in the last bit).
  * 20 training steps of the smoke model: every logged loss within 1e-3
    of the reference's, every parameter within 20 x lr (Adam moves an
    element at most about lr a step; where a gradient is near zero its
    sign, so the step, can differ between the two).
  * resume on the CPU: bit-exact, in the port as in the reference test.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import REPO, SRC
from repro import checkpoint as ref_ckpt
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.configs.registry import smoke_config as ref_smoke
from repro.distributed import fault_tolerance as ref_ft
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.launch.train import train as ref_train
from repro.models import forward_train as ref_forward_train
from repro.models import init_params as ref_init
from repro.models import param_spec as ref_spec
from repro.models.layers import _flash_bwd_impl as ref_flash_bwd
from repro.models.layers import _flash_fwd_impl as ref_flash_fwd
from repro.models.layers import flash_attention_xla
from repro.optim import adamw_update as ref_adamw
from repro.optim import init_opt_state as ref_init_opt
from repro.optim import lr_schedule as ref_lr

from repro_torch import checkpoint as ckpt
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.data import TokenStream
from repro_torch.distributed.fault_tolerance import StepWatchdog, plan_remesh
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.launch.steps import (default_train_config, make_train_step,
                                      value_and_grad)
from repro_torch.launch.train import build_state, train
from repro_torch.models import (init_params, param_spec, params_from_arrays,
                                params_to_arrays)
from repro_torch.models import layers as L
from repro_torch.optim import (adamw_update, clip_by_global_norm,
                               init_opt_state, lr_schedule)
from repro_torch.tree import leaves, tree_map

DENSE = ["tinyllama-1.1b", "qwen2.5-32b", "h2o-danube-3-4b", "gemma3-27b"]
FLASH_TOL = 2e-5
LOSS_TOL = 1e-4
GRAD_TOL = 3e-2
ADAM_TOL = 1e-6


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


def _ref_params(name):
    return ref_init(ref_spec(ref_smoke(name)), jax.random.key(0))


def _tokens(cfg, b=2, s=64, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _norm_rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------- flash attention: forward, lse, backward ----------------
FLASH_CASES = [(True, 0, 0.0), (True, 16, 0.0), (False, 0, 0.0),
               (True, 0, 20.0)]


def _qkv(seed, shape=(2, 64, 2, 16)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("causal,window,softcap", FLASH_CASES)
def test_flash_fwd_impl_and_lse_match_reference(causal, window, softcap):
    """``_flash_fwd_impl`` over several q and kv blocks: out and lse
    against the reference's on the same inputs, and the kernel wrapper's
    CPU route (ref.py) gives the same lse as (BH, Sq)."""
    q, k, v, _ = _qkv(3)
    kw = dict(causal=causal, window=window, softcap=softcap, q_chunk=16,
              kv_chunk=32)
    out, lse = L._flash_fwd_impl(*map(torch.from_numpy, (q, k, v)), **kw)
    r_out, r_lse = ref_flash_fwd(q, k, v, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out),
                               atol=FLASH_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(r_lse),
                               atol=FLASH_TOL)
    bh = [torch.from_numpy(t).transpose(1, 2).reshape(4, 64, 16)
          .contiguous() for t in (q, k, v)]
    o2, lse2 = flash_attention_fwd(*bh, causal=causal, window=window,
                                   softcap=softcap, return_lse=True)
    np.testing.assert_allclose(lse2.reshape(2, 2, 64).numpy(),
                               np.asarray(r_lse), atol=FLASH_TOL)
    np.testing.assert_allclose(
        o2.reshape(2, 2, 64, 16).transpose(1, 2).numpy(), np.asarray(r_out),
        atol=FLASH_TOL)


@pytest.mark.parametrize("causal,window,softcap", FLASH_CASES)
def test_flash_bwd_impl_matches_reference(causal, window, softcap):
    q, k, v, do = _qkv(5)
    kw = dict(causal=causal, window=window, softcap=softcap, q_chunk=16,
              kv_chunk=32)
    r_out, r_lse = ref_flash_fwd(q, k, v, **kw)
    want = ref_flash_bwd(q, k, v, r_out, r_lse, do, **kw)
    got = L._flash_bwd_impl(
        *map(torch.from_numpy, (q, k, v, np.array(r_out),
                                np.array(r_lse), do)), **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FLASH_TOL)


@pytest.mark.parametrize("causal,window,softcap", FLASH_CASES)
def test_flash_train_grads_match_naive_and_jax_grad(causal, window,
                                                    softcap):
    """Port of test_layers.py::test_flash_xla_grads_match_naive, with the
    reference's ``jax.grad`` of ``flash_attention_xla`` beside it."""
    q, k, v, do = _qkv(7, (1, 32, 2, 8))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True)
                  for t in (q, k, v))
    o = L.flash_attention_train(tq, tk, tv, causal=causal, window=window,
                                softcap=softcap, q_chunk=16, kv_chunk=16)
    g1 = torch.autograd.grad((o * torch.from_numpy(do)).sum(), (tq, tk, tv))
    pos = torch.arange(32)
    on = L.attention_naive(tq, tk, tv, q_pos=pos, k_pos=pos, causal=causal,
                           window=window, softcap=softcap)
    g2 = torch.autograd.grad((on * torch.from_numpy(do)).sum(),
                             (tq, tk, tv))
    g3 = jax.grad(lambda a, b, c: (flash_attention_xla(
        a, b, c, causal, window, softcap, 16, 16) * do).sum(),
        argnums=(0, 1, 2))(q, k, v)
    for a, b, c in zip(g1, g2, g3):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=FLASH_TOL)


def test_attention_block_routes_training_through_flash_function():
    """With a gradient wanted, attention_block runs FlashAttention (its
    forward bits are the serving path's); without, the serving path."""
    cfg = smoke_config("tinyllama-1.1b")
    tree = init_params(param_spec(cfg), torch.Generator().manual_seed(0),
                       "cpu")
    p = {k: t[0] for k, t in tree["segments"][0]["attn"].items()}
    x = torch.randn((2, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)) \
        .to(torch.bfloat16)
    pos = torch.arange(32)
    with torch.no_grad():
        serve, _ = L.attention_block(p, x, cfg, positions=pos)
    xg = x.clone().requires_grad_(True)
    train_out, _ = L.attention_block(p, xg, cfg, positions=pos)
    assert train_out.grad_fn is not None
    assert torch.equal(serve, train_out.detach())


# ---------------- the model: loss and gradients ----------------
@pytest.fixture(scope="module", params=DENSE)
def model_case(request):
    """One dense smoke arch: the reference's loss and gradients at its
    init weights, and the port's on the carried weights."""
    name = request.param
    cfg, rcfg = smoke_config(name), ref_smoke(name)
    rp = _ref_params(name)
    toks = _tokens(cfg)
    (rl, _), rg = jax.value_and_grad(
        lambda p: ref_forward_train(p, rcfg, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(rp)
    tree = _torch(_np(rp))
    loss, metrics, grads = value_and_grad(cfg, tree,
                                          {"tokens": torch.from_numpy(toks)})
    return name, cfg, rp, tree, toks, (float(rl), rg), (loss, metrics, grads)


def test_forward_train_loss_and_grads_match_reference(model_case):
    name, cfg, _, tree, _, (rl, rg), (loss, metrics, grads) = model_case
    assert abs(float(loss) - rl) < LOSS_TOL, (name, float(loss), rl)
    assert float(metrics["ce"]) == float(loss)
    assert len(leaves(grads)) == len(jax.tree.leaves(rg))
    for a, b in zip(leaves(grads), jax.tree.leaves(rg)):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert _norm_rel(a.numpy(), b) < GRAD_TOL, name


def test_remat_and_impls_agree(model_case):
    """remat=False gives the remat run's loss and gradients bit for bit;
    ``impl="plain"`` (the forward training is held against on the card)
    is the chunked forward on the CPU."""
    name, cfg, _, tree, toks, _, (loss, _, grads) = model_case
    batch = {"tokens": torch.from_numpy(toks)}
    for kw in ({"remat": False}, {"impl": "plain"}):
        l2, _, g2 = value_and_grad(cfg, tree, batch, **kw)
        assert torch.equal(l2, loss), (name, kw)
        for a, b in zip(leaves(g2), leaves(grads)):
            assert torch.equal(a, b), (name, kw)


@pytest.mark.parametrize("name", DENSE)
def test_train_step_smoke(name):
    """Port of test_models_smoke.py::test_train_step_smoke (the dense
    family): one step, finite loss in (1, 20), parameters changed and
    finite; and the step's new parameters against the reference's step
    on the same weights and tokens."""
    cfg, rcfg = smoke_config(name), ref_smoke(name)
    rp = _ref_params(name)
    toks = _tokens(cfg, 2, 64, seed=2)
    tc = TrainConfig(total_steps=10, warmup_steps=2)
    rtc = RefTrainConfig(total_steps=10, warmup_steps=2)
    tree = _torch(_np(rp))
    p2, opt2, m = make_train_step(cfg, tc)(tree, init_opt_state(tree),
                                           {"tokens": torch.from_numpy(toks)})
    loss = float(m["loss"])
    assert np.isfinite(loss) and 1.0 < loss < 20.0, (name, loss)
    assert not torch.equal(leaves(tree)[0], leaves(p2)[0])
    for leaf in leaves(p2):
        assert torch.isfinite(leaf).all(), name
    assert int(opt2.step) == 1
    rp2, _, rm = jax.jit(ref_make_train_step(rcfg, rtc))(
        rp, ref_init_opt(rp), {"tokens": jnp.asarray(toks)})
    assert abs(loss - float(rm["loss"])) < LOSS_TOL
    assert abs(float(m["grad_norm"]) - float(rm["grad_norm"])) \
        < GRAD_TOL * float(rm["grad_norm"])
    lr = float(rm["lr"])
    for a, b in zip(leaves(p2), jax.tree.leaves(rp2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2 * lr)


def test_grad_accum_equivalence():
    """Port of test_models_smoke.py::test_grad_accum_equivalence: accum=2
    matches accum=1 on the same global batch."""
    cfg = smoke_config("tinyllama-1.1b")
    tree = _torch(_np(_ref_params("tinyllama-1.1b")))
    b = {"tokens": torch.from_numpy(_tokens(cfg, 4, 32, seed=3))}
    outs = {}
    for accum in (1, 2):
        tc = TrainConfig(total_steps=10, warmup_steps=2, grad_accum=accum)
        p2, _, m = make_train_step(cfg, tc)(tree, init_opt_state(tree), b)
        outs[accum] = (p2, float(m["loss"]))
    assert abs(outs[1][1] - outs[2][1]) < 1e-3
    for a, b_ in zip(leaves(outs[1][0]), leaves(outs[2][0])):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=2e-4,
                                   rtol=2e-3)


def test_loss_decreases_over_steps():
    """Port of test_models_smoke.py::test_loss_decreases_over_steps."""
    cfg = smoke_config("tinyllama-1.1b")
    tc = TrainConfig(learning_rate=3e-3, total_steps=60, warmup_steps=5)
    params, opt = build_state(cfg, tc, "cpu")
    step = make_train_step(cfg, tc)
    stream = TokenStream(global_batch=4, seq_len=64,
                         vocab_size=cfg.vocab_size)
    losses = []
    for _ in range(60):
        params, opt, m = step(params, opt, stream.next())
        losses.append(float(m["loss"]))
    first = sum(losses[:8]) / 8
    last = sum(losses[-8:]) / 8
    assert last < first - 0.1, (first, last)


def test_default_train_config_matches_reference():
    from repro.configs.registry import get_arch as ref_get_arch
    from repro.launch.steps import default_train_config as ref_default
    from repro_torch.configs.registry import ARCHS, get_arch
    for name in ARCHS:
        assert default_train_config(get_arch(name)).grad_accum \
            == ref_default(ref_get_arch(name)).grad_accum, name
    assert TrainConfig(checkpoint_dir="x") == TrainConfig(
        **{**RefTrainConfig(checkpoint_dir="x").__dict__})


# ---------------- optimizer ----------------
def _t(x):
    return torch.tensor(x, dtype=torch.float32)


def test_adamw_reduces_quadratic():
    tc = TrainConfig(learning_rate=0.1, weight_decay=0.0, warmup_steps=1,
                     total_steps=200, grad_clip=1e9)
    params = {"w": _t([5.0, -3.0, 2.0])}
    opt = init_opt_state(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, opt, _ = adamw_update(params, grads, opt, tc)
    assert float(params["w"].abs().max()) < 0.1


def test_weight_decay_only_on_matrices():
    tc = TrainConfig(learning_rate=0.1, weight_decay=0.5, warmup_steps=1,
                     total_steps=10)
    params = {"m": torch.ones((2, 2)), "b": torch.ones((2,))}
    grads = tree_map(torch.zeros_like, params)
    p2, _, _ = adamw_update(params, grads, init_opt_state(params), tc)
    assert float(p2["m"][0, 0]) < 1.0       # decayed
    assert float(p2["b"][0]) == 1.0         # not decayed


def test_grad_clip():
    g = {"a": torch.full((10,), 100.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert abs(float(torch.sqrt((clipped["a"] ** 2).sum())) - 1.0) < 1e-5
    assert float(norm) > 100


def test_lr_schedule_warmup_and_decay():
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=100, total_steps=1000)
    rtc = RefTrainConfig(learning_rate=1e-3, warmup_steps=100,
                         total_steps=1000)
    lr = {s: float(lr_schedule(torch.tensor(s, dtype=torch.int32), tc))
          for s in (0, 50, 100, 400, 999, 1500)}
    assert lr[0] < lr[100]
    assert abs(lr[100] - 1e-3) < 2e-5
    assert lr[999] < 0.2 * lr[100]
    for s, v in lr.items():
        assert v == pytest.approx(float(ref_lr(jnp.int32(s), rtc)),
                                  rel=ADAM_TOL), s


def test_adamw_update_matches_reference():
    """Three AdamW steps on the same tree, gradients and config: params,
    m, v, the step, grad norm and lr within 1e-6 of the reference's
    (clipping active on the first step)."""
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "seg": [{"b": rng.standard_normal((16,)).astype(np.float32),
                     "k": rng.standard_normal((2, 4, 4)).astype(np.float32)}],
            "a": rng.standard_normal((5,)).astype(np.float32)}
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10)
    rtc = RefTrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10)
    p, rp = _torch(tree), jax.tree.map(jnp.asarray, tree)
    opt, ropt = init_opt_state(p), ref_init_opt(rp)
    for i in range(3):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32) * (5.0 if i == 0 else 0.1), tree)
        p, opt, m = adamw_update(p, _torch(g), opt, tc)
        rp, ropt, rm = ref_adamw(rp, jax.tree.map(jnp.asarray, g), ropt,
                                 rtc)
        for a, b in zip(leaves(p) + leaves(opt.m) + leaves(opt.v),
                        jax.tree.leaves(rp) + jax.tree.leaves(ropt.m)
                        + jax.tree.leaves(ropt.v)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=ADAM_TOL, atol=ADAM_TOL)
        assert int(opt.step) == int(ropt.step) == i + 1
        for k in ("grad_norm", "lr"):
            assert float(m[k]) == pytest.approx(float(rm[k]), rel=ADAM_TOL)


# ---------------- checkpoint ----------------
def test_checkpoint_roundtrip_and_retention(tmp_path):
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 3))}}
    for step in (10, 20, 30, 40):
        ckpt.save(tmp_path, step, tree, keep=2)
    assert ckpt.latest_step(tmp_path) == 40
    steps = sorted(int(p.name.split("_")[1])
                   for p in tmp_path.glob("step_*"))
    assert steps == [30, 40]
    restored = ckpt.restore(tmp_path, 40, tree)
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])


def test_checkpoint_atomicity(tmp_path):
    ckpt.save(tmp_path, 1, {"a": torch.zeros(4)})
    # a stale tmp dir from a crashed writer must not break LATEST
    (tmp_path / ".tmp_step_2").mkdir()
    assert ckpt.latest_step(tmp_path) == 1


def _same_files(a, b, n):
    for i in range(n):
        x, y = np.load(a / f"arr_{i}.npy"), np.load(b / f"arr_{i}.npy")
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert x.tobytes() == y.tobytes(), i


def test_checkpoints_cross_restore_byte_equal(tmp_path):
    """The smoke model's parameter tree and optimizer state: the
    reference's checkpoint restores into the port's trees and the port's
    into the reference's, every array byte-equal, the leaf files equal."""
    cfg = smoke_config("gemma3-27b")
    rp = _ref_params("gemma3-27b")
    ropt = ref_init_opt(rp)
    ropt = ropt._replace(m=jax.tree.map(lambda a: a + 0.5, rp),
                         step=jnp.int32(7))
    ref_ckpt.save(tmp_path / "ref", 3, rp)
    ref_ckpt.save(tmp_path / "ref" / "opt", 3, ropt)
    params, opt = build_state(cfg, TrainConfig(), "cpu")
    got = ckpt.restore(tmp_path / "ref", 3, params)
    got_opt = ckpt.restore(tmp_path / "ref" / "opt", 3, opt)
    for a, b in zip(leaves(got) + leaves(got_opt),
                    jax.tree.leaves(rp) + jax.tree.leaves(ropt)):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    assert int(got_opt.step) == 7 and got_opt.step.dtype == torch.int32
    ckpt.save(tmp_path / "port", 3, got)
    ckpt.save(tmp_path / "port" / "opt", 3, got_opt)
    n = len(jax.tree.leaves(rp))
    _same_files(tmp_path / "ref" / "step_3", tmp_path / "port" / "step_3", n)
    _same_files(tmp_path / "ref" / "opt" / "step_3",
                tmp_path / "port" / "opt" / "step_3", 2 * n + 1)
    back = ref_ckpt.restore(tmp_path / "port", 3, rp)
    back_opt = ref_ckpt.restore(tmp_path / "port" / "opt", 3, ropt)
    for a, b in zip(jax.tree.leaves(back) + jax.tree.leaves(back_opt),
                    jax.tree.leaves(rp) + jax.tree.leaves(ropt)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    # the module's reverse carry gives the same tree as the checkpoint
    model = params_from_arrays(cfg, _np(rp))
    for a, b in zip(jax.tree.leaves(params_to_arrays(cfg, model)),
                    jax.tree.leaves(rp)):
        assert a.tobytes() == np.asarray(b).tobytes()


# ---------------- fault tolerance ----------------
def test_plan_remesh_matches_reference():
    for total, failed, mp in ((512, 256, 16), (512, 0, 16), (256, 256, 16),
                              (64, 3, 8)):
        got, want = plan_remesh(total, failed, mp), ref_ft.plan_remesh(
            total, failed, mp)
        assert got.__dict__ == want.__dict__
    plan = plan_remesh(512, 256, model_parallel=16)
    assert plan.mesh_shape[-1] == 16 and plan.devices_used <= 256
    assert plan_remesh(512, 0, model_parallel=16).mesh_shape == (2, 16, 16)


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(factor=3.0, window=16)
    for i in range(10):
        wd.start()
        time.sleep(0.002)
        assert not wd.stop(i)
    wd.start()
    time.sleep(0.05)
    assert wd.stop(99)
    assert wd.flagged and wd.flagged[0][0] == 99


# ---------------- the training driver ----------------
def _tc(d, steps=20, every=10):
    return TrainConfig(learning_rate=1e-3, total_steps=steps, warmup_steps=2,
                       checkpoint_dir=str(d), checkpoint_every=every)


def test_train_checkpoint_resume_bitexact(tmp_path):
    """Port of test_system.py::test_train_checkpoint_resume_bitexact:
    interrupted at step 12, resumed from the step-10 checkpoint, the
    state equals the uninterrupted run's bit for bit on the CPU; so does
    a run that drops its state at step 15 and replays from the
    checkpoint (--simulate-failure)."""
    cfg = smoke_config("tinyllama-1.1b")
    kw = dict(batch=2, seq=32, log_every=100, device="cpu")
    p_full, o_full, _ = train(cfg, _tc(tmp_path / "a"), steps=20,
                              resume=False, **kw)
    train(cfg, _tc(tmp_path / "b"), steps=12, resume=False, **kw)
    p_res, o_res, _ = train(cfg, _tc(tmp_path / "b"), steps=20,
                            resume=True, **kw)
    p_sim, _, _ = train(cfg, _tc(tmp_path / "c"), steps=20, resume=False,
                        simulate_failure=15, **kw)
    for a, b, c in zip(leaves(p_full), leaves(p_res), leaves(p_sim)):
        assert torch.equal(a, b) and torch.equal(a, c)
    for a, b in zip(leaves(o_full), leaves(o_res)):
        assert torch.equal(a, b)


def test_train_20_steps_matches_reference(tmp_path):
    """The reference's 20-step run and the port's from the reference's
    initial weights (a step-0 checkpoint written by the reference, which
    the port resumes from), same tokens and schedule."""
    cfg, rcfg = smoke_config("tinyllama-1.1b"), ref_smoke("tinyllama-1.1b")
    rtc = RefTrainConfig(learning_rate=1e-3, total_steps=20, warmup_steps=2,
                         checkpoint_dir=str(tmp_path / "ref"),
                         checkpoint_every=0)
    rp, _, rlosses = ref_train(rcfg, rtc, batch=2, seq=32, steps=20,
                               resume=False, log_every=1)
    p0 = _ref_params("tinyllama-1.1b")
    ref_ckpt.save(tmp_path / "port", 0, p0)
    ref_ckpt.save(tmp_path / "port" / "opt", 0, ref_init_opt(p0))
    p, _, losses = train(cfg, _tc(tmp_path / "port", every=0), batch=2,
                         seq=32, steps=20, resume=True, log_every=1,
                         device="cpu")
    assert [s for s, _ in losses] == [s for s, _ in rlosses] == list(
        range(20))
    for (_, a), (_, b) in zip(losses, rlosses):
        assert abs(a - b) < 1e-3, (losses, rlosses)
    for a, b in zip(leaves(p), jax.tree.leaves(rp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=20 * 1e-3)


def test_train_cli_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--steps", "4", "--batch", "2", "--seq", "32", "--device", "cpu",
         "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
         "--simulate-failure", "3"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "recovered; replayed 1 steps" in r.stdout
    assert "[train] done" in r.stdout
    assert json.loads((tmp_path / "step_4" / "manifest.json").read_text())[
        "num_leaves"] == 12
