"""The sharded LM step over ranks of ``torch.distributed`` (gloo, CPU
tensors): DTensor shardings on a (data, model) mesh against the port's
one-process run on the same seeded weights and batches.

  * ports of ``tests/test_system.py``'s distributed-parity test (a
    train step on a (2, 2) mesh under the train policy equals the
    one-device step: loss within 1e-3, every parameter leaf within rtol
    3e-3, atol 3e-4) and elastic-restore test (a checkpoint written from
    a (4, 1) mesh restores onto (2, 2) bit-equal), run on four rank
    processes instead of four host devices;
  * what the step does, held where the leaf bound cannot see it: in its
    first steps AdamW moves a weight by about the learning rate
    whatever its gradient's size, an update the size of that bound.  So
    the gradient norm, every gradient leaf and every leaf's update
    ``p_after - p_before`` are held against the one-device step by
    relative norm (GNORM_TOL, GRAD_TOL, DELTA_TOL: two to eight times
    the gaps measured on this tree, and far under what a step with no
    update, or with a gradient missing its sum over "data", gives);
  * ``launch/train.py::train(mesh=)`` on (2, 2) for two steps of the
    parity test's schedule against its one-device run: each step's loss
    (1e-3) and gradient norm, and each leaf's update by relative norm
    (at these learning rates a gradient near zero whose sign differs in
    the last bits moves its weight 2 lr, past the leaf bound's atol);
  * prefill and two decode steps on (2, 2) under the inference policy,
    the decode cache laid out by ``cache_shardings`` (its sequence axis
    split over "model"), against the one-device forwards (logits within
    the bf16 tolerance of ``tests/test_torch_models.py``).

One spawn of four rank processes for the module (a file rendezvous, one
torch thread a rank); a rank that fails fails the tests.  The
one-device runs are the port's own, which ``tests/test_torch_train.py``
holds against the JAX package."""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import SRC
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.launch.serve import pad_cache_for_decode
from repro_torch.launch.steps import make_train_step, value_and_grad
from repro_torch.launch.train import build_state, train
from repro_torch.models import forward_decode, forward_prefill, \
    init_params, param_spec
from repro_torch.models.model import Transformer
from repro_torch.optim import init_opt_state
from repro_torch.tree import leaves

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
ARCH = "tinyllama-1.1b"
BATCH, SEQ = 4, 64                 # tests/test_system.py's (4, 64)
PROMPT, CTX, DECODE = 32, 64, 2
WORLD = 4
SPAWN_TIMEOUT_S = 240
LOSS_TOL, RTOL, ATOL = 1e-3, 3e-3, 3e-4     # tests/test_system.py
# relative norms against the one-device step (see the module docstring)
GNORM_TOL, GRAD_TOL, DELTA_TOL = 5e-4, 3e-2, 0.3
PARITY_TC = TrainConfig(total_steps=10, warmup_steps=2)
LOGIT_TOL = 5e-2                            # bf16 logits


def _inputs():
    """The seeded weights, batch and prompt every process draws."""
    cfg = smoke_config(ARCH)
    params = init_params(param_spec(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=g,
                           dtype=torch.int32)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT + DECODE),
                           generator=g, dtype=torch.int32)
    return cfg, params, {"tokens": tokens}, prompt


def _decode(model, cfg, cache, prompt, lay=lambda t: t):
    """DECODE steps from ``cache`` on the prompt's next tokens, each laid
    out by ``lay``; each step's logits."""
    out = []
    for i in range(DECODE):
        tok = lay(prompt[:, PROMPT + i:PROMPT + i + 1])
        logits, cache = forward_decode(model, cfg, tok, cache)
        out.append(logits)
    return out


def _train_tc(ckpt_dir):
    return dataclasses.replace(PARITY_TC, checkpoint_every=0,
                               checkpoint_dir=os.path.join(ckpt_dir, "none"))


def _full(x):
    from torch.distributed.tensor import DTensor
    return (x.full_tensor() if isinstance(x, DTensor) else x).float().numpy()


def rank_main(argv) -> None:
    """One rank: ``rank rendezvous out-dir``; rank 0 writes the results."""
    import torch.distributed as dist

    from repro_torch import checkpoint as ckpt
    from repro_torch.distributed import actctx
    from repro_torch.launch.mesh import batch_axes, device_mesh, \
        make_local_mesh
    from repro_torch.launch.steps import batch_shardings, cache_shardings
    from repro_torch.models.params import distribute, param_shardings
    rank, rdzv, out_dir = int(argv[0]), argv[1], argv[2]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                            world_size=WORLD)
    try:
        cfg, params, batch, prompt = _inputs()
        spec = param_spec(cfg)
        res = {}
        # -- the (2, 2) train step (test_system.py's parity test) -------
        mesh = make_local_mesh(2, 2)
        dm = device_mesh(mesh, "cpu")
        sh = param_shardings(spec, mesh)
        pd = distribute(params, sh, dm)
        shape = ShapeConfig("t", "train", SEQ, BATCH)
        bd = distribute(batch, batch_shardings(cfg, shape, mesh, batch), dm)
        step = make_train_step(cfg, PARITY_TC)
        with actctx.policy(actctx.make_train_policy(
                mesh, batch_axes=batch_axes(mesh, BATCH))):
            with actctx.sharded_ctx(pd):
                _, _, g2 = value_and_grad(cfg, pd, bd)
            p2, o2, m2 = step(pd, init_opt_state(pd), bd)
        res["step"] = {"loss": float(m2["loss"]),
                       "grad_norm": float(m2["grad_norm"]),
                       "grads": [_full(g) for g in leaves(g2)],
                       "leaves": [_full(t) for t in leaves(p2)],
                       "placements": [str(t.placements)
                                      for t in leaves(p2)]}
        res["opt_placements"] = str(leaves(o2.m)[0].placements)
        # -- train(mesh=) -------------------------------------------------
        hist = []
        pt, _, _ = train(cfg, _train_tc(out_dir), batch=BATCH, seq=SEQ,
                         steps=2, device="cpu", mesh=mesh, resume=False,
                         history=hist, log_every=2)
        res["train"] = ([(h["loss"], h["grad_norm"]) for h in hist
                         if "step" in h], [_full(t) for t in leaves(pt)])
        # -- elastic: saved from (4, 1), restored onto (2, 2) -------------
        mesh_a = make_local_mesh(4, 1)
        pa = distribute(params, param_shardings(spec, mesh_a),
                        device_mesh(mesh_a, "cpu"))
        d = os.path.join(out_dir, "ckpt")
        ckpt.save(d, 1, pa)
        back = ckpt.restore(d, 1, params, sh)
        res["elastic"] = (
            [_full(t) for t in leaves(back)],
            [str(t.placements) for t in leaves(back)],
            [torch.equal(t.to_local(), x.to_local())
             for t, x in zip(leaves(back), leaves(pd))])
        # -- prefill and decode on (2, 2) ----------------------------------
        model = Transformer(cfg, pd)
        with actctx.policy(actctx.make_infer_policy(
                mesh, batch_axes=batch_axes(mesh, BATCH))), \
                torch.no_grad():
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                pr = distribute({"tokens": prompt[:, :PROMPT]},
                                batch_shardings(cfg, shape, mesh,
                                                {"tokens": prompt}), dm)
                logits, cache = forward_prefill(model, cfg, pr)
                one = Transformer(cfg, params)
                _, cache1 = forward_prefill(one, cfg,
                                            {"tokens": prompt[:, :PROMPT]})
                full = pad_cache_for_decode(cfg, cache1, CTX, BATCH)
                cache_sh = cache_shardings(cfg, mesh, BATCH, CTX)
                cd = distribute(full, cache_sh, dm)
                steps = _decode(model, cfg, cd, prompt, lambda t: distribute(
                    {"tokens": t}, batch_shardings(cfg, shape, mesh,
                                                   {"tokens": t}),
                    dm)["tokens"])
                res["serve"] = (_full(logits), [_full(x) for x in steps],
                                [str(t.placements)
                                 for t in leaves(cd["segments"])])
        if rank == 0:
            with open(os.path.join(out_dir, "rank0.pkl"), "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


_WORKER = ("import sys; sys.path[:0] = [{tests!r}, {src!r}]; "
           "import test_torch_sharded_train as t; t.rank_main(sys.argv[1:])")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Rank 0's results of the one spawn of WORLD rank processes."""
    out = tmp_path_factory.mktemp("sharded")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    code = _WORKER.format(tests=TESTS_DIR, src=SRC)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(out / "rdzv"), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(
        log[-3000:] for log in logs)
    with open(out / "rank0.pkl", "rb") as f:
        return pickle.load(f)


def _close(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b.float().numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"leaf {i}")


def _rel(got, want) -> float:
    """``|got - want| / |want|`` (Frobenius norms) of numpy arrays."""
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _updates_close(got, want, before):
    """Each leaf's update from ``before`` within DELTA_TOL of the
    one-device update, by relative norm."""
    gaps = [_rel(a - p.numpy(), b.float().numpy() - p.numpy())
            for a, b, p in zip(got, want, before)]
    assert max(gaps) < DELTA_TOL, gaps


def test_distributed_train_parity_with_single_device(ranks):
    cfg, params, batch, _ = _inputs()
    step = make_train_step(cfg, PARITY_TC)
    _, _, g1 = value_and_grad(cfg, params, batch)
    p1, _, m1 = step(params, init_opt_state(params), batch)
    got = ranks["step"]
    assert abs(got["loss"] - float(m1["loss"])) < LOSS_TOL
    assert len(got["leaves"]) == len(leaves(p1))
    _close(got["leaves"], leaves(p1))
    assert abs(got["grad_norm"] / float(m1["grad_norm"]) - 1) < GNORM_TOL
    gaps = [_rel(a, b.float().numpy())
            for a, b in zip(got["grads"], leaves(g1))]
    assert max(gaps) < GRAD_TOL, gaps
    _updates_close(got["leaves"], leaves(p1), leaves(params))
    placements = got["placements"]
    # ZeRO-3 and tensor parallel: wq (L, d, H, hd) keeps d over "data"
    # and H over "model"; the optimizer state is laid out as its leaf
    assert "(Shard(dim=1), Shard(dim=2))" in placements
    assert ranks["opt_placements"] == placements[0]


def test_train_entry_point_on_a_mesh(ranks, tmp_path):
    cfg, *_ = _inputs()
    tc = _train_tc(str(tmp_path))
    hist = []
    p1, _, _ = train(cfg, tc, batch=BATCH, seq=SEQ, steps=2, device="cpu",
                     resume=False, history=hist, log_every=2)
    steps, got = ranks["train"]
    want = [(h["loss"], h["grad_norm"]) for h in hist if "step" in h]
    assert len(steps) == len(want) == 2
    for (loss, gnorm), (loss1, gnorm1) in zip(steps, want):
        assert abs(loss - loss1) < LOSS_TOL
        assert abs(gnorm / gnorm1 - 1) < GNORM_TOL
    p0, _ = build_state(cfg, tc, "cpu")
    _updates_close(got, leaves(p1), leaves(p0))


def test_elastic_restore_across_meshes(ranks):
    _, params, _, _ = _inputs()
    got, placements, same_shards = ranks["elastic"]
    for a, b in zip(got, leaves(params)):
        np.testing.assert_array_equal(a, b.numpy())
    # laid out on (2, 2) as a distributed tree of the same shardings is
    assert all(same_shards)
    assert "(Shard(dim=1), Shard(dim=2))" in placements


def test_sharded_prefill_and_decode_match_one_device(ranks):
    cfg, params, _, prompt = _inputs()
    model = Transformer(cfg, params)
    with torch.no_grad():
        logits, cache = forward_prefill(model, cfg,
                                        {"tokens": prompt[:, :PROMPT]})
        steps = _decode(model, cfg, pad_cache_for_decode(cfg, cache, CTX,
                                                         BATCH), prompt)
    got_prefill, got_steps, cache_pl = ranks["serve"]
    np.testing.assert_allclose(got_prefill, logits.float().numpy(),
                               atol=LOGIT_TOL, rtol=0)
    for a, b in zip(got_steps, steps):
        np.testing.assert_allclose(a, b.float().numpy(), atol=LOGIT_TOL,
                                   rtol=0)
    # the KV buffers' sequence axis split over "model"
    assert cache_pl[0] == "(Shard(dim=1), Shard(dim=2))"
