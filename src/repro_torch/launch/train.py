"""Training driver: the end-to-end loop with checkpoint/restart, the
straggler watchdog and a simulated failure with its remesh plan.

Runs real steps on the card unless ``--device cpu``: on one device, or,
given a mesh of more than one device (by default under a
``torch.distributed`` group of W ranks, ``make_local_mesh(W, 1)``, as
the reference's over its devices), on DTensors laid out by
``param_shardings`` and ``batch_shardings``, each rank holding its
shards.  Every
architecture of the registry trains; the audio family's frame embeddings
and the vlm's patch embeddings are drawn each step from a generator
seeded by ``(seed, step)`` (the stub frontends, as ``launch/serve.py``
draws them), so a resumed run sees the same inputs.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --smoke --steps 200 --batch 8 --seq 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-small \\
      --smoke --steps 20 --batch 2 --seq 64 --device cpu --no-resume

  # fault-tolerance demo: drop the state at step 60, restore the last
  # checkpoint and replay to it
  ... --simulate-failure 60

The activation-sharding policy (``make_train_policy``) applies only
when the mesh's "model" axis exceeds 1, as in the reference.  Over
gloo on CUDA tensors every collective of the step is staged through
pinned host memory (``actctx.StagedCollectives``).
"""

from __future__ import annotations

import argparse
import contextlib
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.registry import get_arch, smoke_config
from repro_torch.data import TokenStream
from repro_torch.distributed import actctx
from repro_torch.distributed.fault_tolerance import StepWatchdog, plan_remesh
from repro_torch.launch.mesh import batch_axes, device_mesh, make_local_mesh
from repro_torch.launch.serve import frontend_embeds
from repro_torch.launch.steps import batch_shardings, check_sharded, \
    make_train_step
from repro_torch.models import init_params, param_spec
from repro_torch.models.params import distribute, param_shardings
from repro_torch.optim import init_opt_state
from repro_torch.tree import tree_map


def _device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "train runs on CUDA and no CUDA device is available; pass "
            "device='cpu' (--device cpu) to run on the CPU")
    return torch.device("cuda")


def build_state(cfg, tc: TrainConfig, device, shardings=None, dmesh=None):
    """Parameters drawn from a ``torch.Generator`` seeded ``tc.seed`` on
    ``device`` and a fresh optimizer state.  Given ``shardings``
    (``param_shardings``) and their ``DeviceMesh`` ``dmesh``, every rank
    draws the same full tree and keeps its shards of it."""
    gen = torch.Generator(device=device).manual_seed(tc.seed)
    params = init_params(param_spec(cfg), gen, device)
    if dmesh is not None:
        params = distribute(params, shardings, dmesh)
    return params, init_opt_state(params)


def default_mesh():
    """The reference's ``make_local_mesh(len(jax.devices()), 1)``: under
    a ``torch.distributed`` group of W ranks ``make_local_mesh(W, 1)``,
    with none the one device."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return make_local_mesh(dist.get_world_size(), 1)
    return make_local_mesh()


def next_batch(stream: TokenStream, cfg, tc: TrainConfig, device) -> dict:
    """The stream's next tokens and, for the audio and vlm families, the
    stub frontend's embeddings in bf16 (``input_specs``' dtype), drawn
    on ``device`` from a generator seeded by ``(tc.seed, step)``."""
    step = stream.step
    b = stream.next()
    b.update(frontend_embeds(cfg, stream.global_batch, device,
                             seed=(tc.seed << 32) + step))
    return b


def _restore(tc: TrainConfig, step: int, params, opt, shardings=None):
    params = ckpt.restore(tc.checkpoint_dir, step, params, shardings)
    opt = ckpt.restore(f"{tc.checkpoint_dir}/opt", step, opt)
    return params, opt


def train(cfg, tc: TrainConfig, *, batch: int, seq: int, steps: int,
          device=None, mesh=None, simulate_failure: int = -1,
          log_every: int = 10, resume: bool = True, impl: str = "chunked",
          history: list | None = None):
    """Train ``steps`` steps (from the last checkpoint when ``resume``).
    Returns ``(params, opt_state, losses)``, ``losses`` the logged
    ``(step, loss)`` pairs.  A ``history`` list receives a record of
    every step (``step``, ``loss``, ``grad_norm``, ``lr`` and its wall
    ``s`` up to those host reads), of every checkpoint written
    (``write_s``), of a restore (``read_s``) and, when the collectives
    were staged through host memory, the ops staged (``staged``: op ->
    calls).

    ``mesh`` (``launch/mesh.Mesh``; :func:`default_mesh` when None) of
    more than one device needs a ``torch.distributed`` group of
    ``mesh.size`` ranks: each rank runs this with the same arguments and
    holds its shards, and the returned trees are DTensors; a family
    outside ``steps.SHARDED_FAMILIES`` raises ``NotImplementedError``
    there, before any state is built."""
    device = _device(device)
    mesh = mesh or default_mesh()
    check_sharded(cfg, mesh)
    dmesh = device_mesh(mesh, device.type) if mesh.size > 1 else None
    shardings = param_shardings(param_spec(cfg), mesh) if dmesh else None
    params, opt = build_state(cfg, tc, device, shardings, dmesh)
    stream = TokenStream(global_batch=batch, seq_len=seq,
                         vocab_size=cfg.vocab_size, seed=tc.seed)
    policy = None
    if dmesh is not None and mesh.shape.get("model", 1) > 1:
        policy = actctx.make_train_policy(
            mesh, batch_axes=batch_axes(mesh, batch))
    staging = contextlib.nullcontext()
    if dmesh is not None:
        import torch.distributed as dist
        if actctx.staged_backend(str(dist.get_backend()), device.type):
            staging = actctx.StagedCollectives()

    shape = ShapeConfig("train", "train", seq_len=seq, global_batch=batch)

    def feed(b):
        """The stream's full batch (the same on every rank) as each rank's
        shard of it."""
        if dmesh is None:
            return b
        return distribute(b, batch_shardings(cfg, shape, mesh, b), dmesh)

    with actctx.policy(policy), staging:
        start = 0
        if resume:
            last = ckpt.latest_step(tc.checkpoint_dir)
            if last is not None:
                t0 = time.perf_counter()
                params, opt = _restore(tc, last, params, opt,
                                       shardings)
                if history is not None:
                    history.append({"restored": last,
                                    "read_s": time.perf_counter() - t0})
                stream.restore(last)
                start = last
                print(f"[train] resumed from step {last}")

        step_fn = make_train_step(cfg, tc, impl=impl)
        watchdog = StepWatchdog()
        losses = []
        for step in range(start, steps):
            if step == simulate_failure:
                print(f"[train] SIMULATED FAILURE at step {step}: dropping "
                      "state, planning remesh, restoring checkpoint")
                plan = plan_remesh(256, 256)
                print(f"[train] remesh plan: {plan.mesh_shape} ({plan.note})")
                last = ckpt.latest_step(tc.checkpoint_dir)
                if last is None:
                    raise RuntimeError("no checkpoint to recover from")
                params = tree_map(torch.zeros_like, params)   # state lost
                params, opt = _restore(tc, last, params, opt,
                                       shardings)
                stream.restore(last)
                simulate_failure = -1
                # re-run from the checkpoint step
                for _ in range(last, step):
                    params, opt, _ = step_fn(
                        params, opt, feed(next_batch(stream, cfg, tc, device)))
                print(f"[train] recovered; replayed {step - last} steps")

            b = feed(next_batch(stream, cfg, tc, device))
            t_step = time.perf_counter()
            watchdog.start()
            params, opt, metrics = step_fn(params, opt, b)
            if history is not None:
                history.append({"step": step,
                                "loss": float(metrics["loss"]),
                                "grad_norm": float(metrics["grad_norm"]),
                                "lr": float(metrics["lr"]),
                                "s": time.perf_counter() - t_step})
            if step % log_every == 0 or step == steps - 1:
                loss = float(metrics["loss"])   # the step's one host read
                losses.append((step, loss))
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f}")
            if watchdog.stop(step):
                print(f"[train] straggler flagged at step {step}")
            if tc.checkpoint_every and (step + 1) % tc.checkpoint_every == 0:
                t0 = time.perf_counter()
                ckpt.save(tc.checkpoint_dir, step + 1, params,
                          keep=tc.keep_checkpoints)
                ckpt.save(f"{tc.checkpoint_dir}/opt", step + 1, opt,
                          keep=tc.keep_checkpoints)
                if history is not None:
                    history.append({"saved": step + 1,
                                    "write_s": time.perf_counter() - t0})
    if history is not None and isinstance(staging,
                                          actctx.StagedCollectives):
        history.append({"staged": dict(staging.staged)})
    return params, opt, losses


def main():
    ap = argparse.ArgumentParser(description="LM training loop.")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config for this arch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="build/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--simulate-failure", type=int, default=-1)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     warmup_steps=max(10, args.steps // 20),
                     checkpoint_dir=args.ckpt_dir,
                     checkpoint_every=args.ckpt_every)
    t0 = time.time()
    _, _, losses = train(cfg, tc, batch=args.batch, seq=args.seq,
                         steps=args.steps, device=args.device,
                         simulate_failure=args.simulate_failure,
                         resume=not args.no_resume)
    dt = time.time() - t0
    print(f"[train] done in {dt:.1f}s; loss {losses[0][1]:.3f} -> "
          f"{losses[-1][1]:.3f}")


if __name__ == "__main__":
    main()
