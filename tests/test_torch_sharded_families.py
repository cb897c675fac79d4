"""The sharded steps of the MoE, SSM, hybrid, audio and vlm families over
ranks of ``torch.distributed`` (gloo, CPU tensors): DTensor shardings on
a (data 2, model 2) mesh against the port's one-process run on the same
seeded weights and batches, for one arch of each family at its smoke
config (phi3.5-moe, mamba2, zamba2, whisper, internvl2).

  * the train step under the train policy, at the dense family's bounds
    (``tests/test_torch_sharded_train.py``): loss within 1e-3, every
    leaf within rtol 3e-3 / atol 3e-4, the gradient norm within 5e-4,
    every gradient leaf within 3e-2 and every leaf's update within 0.3
    by relative norm; the gradient norm and leaves within twice the
    one-process rounding floor where that is larger (attention through
    materialized scores against the chunked forward: the hybrid's, up
    to 3.8e-2 a leaf); the MoE's step with the one-process routing
    replayed on each rank's groups (a flipped choice moves its tokens by
    a whole expert), its aux metrics, and the share of its own routing
    choices that differ (each rank's groups put back in the one-process
    order) within twice the share the two roundings route apart;
  * the MoE's expert weights keep their placements through the step and
    are never all-gathered (every all-gather's input is recorded);
  * prefill and two decode steps under the inference policy, the cache
    laid out by ``cache_shardings``, logits within the bf16 tolerance of
    ``tests/test_torch_models.py``;
  * ``actctx.relayout`` by its two routes (an all-to-all of each rank's
    shard, and a gather and a slice), the same tensor and gradient;
  * ``launch/train.py::train(mesh=)`` for two steps of phi3.5-moe (its
    sequence split finer than a routing group, so each rank routes whole
    rows) and internvl2 (the vision stubs laid out by
    ``batch_shardings``): each step's loss and gradient norm, and each
    leaf's update.

The MoE's train step runs at sequence 512, so each rank's half of a row
holds whole groups of 256 tokens and routes them where they lie.

One spawn of four rank processes for the module (a file rendezvous, one
torch thread a rank); a rank that fails fails the tests.  The
one-process runs are the port's own, which ``tests/test_torch_train_
families.py`` and ``tests/test_torch_families.py`` hold against the JAX
package."""

import contextlib
import dataclasses
import functools
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
from repro_torch.launch import steps as S
from repro_torch.launch.serve import frontend_embeds, pad_cache_for_decode
from repro_torch.launch.steps import make_train_step, value_and_grad
from repro_torch.launch.train import build_state, train
from repro_torch.models import forward_decode, forward_prefill, \
    forward_train, init_params, param_spec
from repro_torch.models import moe
from repro_torch.models.model import Transformer
from repro_torch.optim import init_opt_state
from repro_torch.tree import leaves

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
MOE = "phi3.5-moe-42b-a6.6b"
ARCHS = (MOE, "mamba2-1.3b", "zamba2-7b", "whisper-small", "internvl2-1b")
TRAIN_ARCHS = (MOE, "internvl2-1b")        # through train(mesh=)
BATCH, SEQ, MOE_SEQ = 4, 64, 512
PROMPT, CTX, DECODE = 32, 64, 2
WORLD = 4
SPAWN_TIMEOUT_S = 300
# the dense family's bounds (tests/test_torch_sharded_train.py)
LOSS_TOL, RTOL, ATOL = 1e-3, 3e-3, 3e-4
GNORM_TOL, GRAD_TOL, DELTA_TOL = 5e-4, 3e-2, 0.3
AUX_TOL = 1e-4                              # relative, the MoE's aux sums
PARITY_TC = TrainConfig(total_steps=10, warmup_steps=2)
LOGIT_TOL = 5e-2                            # bf16 logits


def _seq(arch: str) -> int:
    return MOE_SEQ if arch == MOE else SEQ


def _inputs(arch: str):
    """The seeded weights, train batch, prompt and frontend stubs every
    process draws for ``arch``."""
    cfg = smoke_config(arch)
    params = init_params(param_spec(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, _seq(arch)),
                           generator=g, dtype=torch.int32)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT + DECODE),
                           generator=g, dtype=torch.int32)
    extras = frontend_embeds(cfg, BATCH, "cpu", seed=3)
    return cfg, params, {"tokens": tokens, **extras}, prompt, extras


def _ctx(cfg) -> int:
    return CTX + (cfg.vision_tokens if cfg.family == "vlm" else 0)


class _Replay:
    """Makes every ``moe.route`` call take the choices ``choices[l]``
    (one-process groups, as :class:`_Routes` recorded them) of its
    layer ``l``, found by its router's values among ``routers``, as
    ``pick`` maps them onto the call's own groups."""

    def __init__(self, routers, choices, pick):
        self.routers, self.choices, self.pick = routers, choices, pick

    def __enter__(self):
        self._route = moe.route

        def replay(router, x, E, K, C, choices=None):
            layer = next(i for i, w in enumerate(self.routers)
                         if torch.equal(router, w))
            return self._route(router, x, E, K, C, choices=torch.as_tensor(
                np.asarray(self.pick(self.choices[layer]))))

        moe.route = replay
        return self

    def __exit__(self, *exc):
        moe.route = self._route


def _train_groups(rank: int, want):
    """Rank ``rank``'s groups of the MoE's train step (sequence 512,
    groups of 256) out of the one-process ones: rank (i, j) holds rows
    2i and 2i+1 and the j-th half of each, so its group k is the
    one-process group (2i + k) * 2 + j."""
    i, j = divmod(rank, 2)
    return np.stack([want[(2 * i + k) * 2 + j] for k in range(2)])


def _routers(cfg, params):
    return list(params["segments"][0]["moe"]["router"])


class _Routes:
    """Records the top-k choices of every ``moe.route`` call while
    installed."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self._route = moe.route

        def rec(*args, **kwargs):
            out = self._route(*args, **kwargs)
            self.calls.append(out["gate_idx"].detach().clone())
            return out

        moe.route = rec
        return self

    def __exit__(self, *exc):
        moe.route = self._route


def _train_tc(out_dir):
    return dataclasses.replace(PARITY_TC, checkpoint_every=0,
                               checkpoint_dir=os.path.join(out_dir, "none"))


def _full(x):
    from torch.distributed.tensor import DTensor
    return (x.full_tensor() if isinstance(x, DTensor) else x).float().numpy()


def _decode(model, cfg, cache, prompt, lay=lambda t: t):
    out = []
    for i in range(DECODE):
        tok = lay(prompt[:, PROMPT + i:PROMPT + i + 1])
        logits, cache = forward_decode(model, cfg, tok, cache)
        out.append(logits)
    return out


def _rank_arch(arch, mesh, dm, out_dir, rank) -> dict:
    """One arch's sharded runs on this rank.  The MoE's train step is
    held against the one-process one with the one-process routing
    replayed (a choice that flips moves its tokens' outputs by far more
    than rounding); its own routing is recorded on a first pass."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import actctx
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.models.params import distribute, param_shardings
    from repro_torch.roofline.jaxpr_cost import CostCounter
    cfg, params, batch, prompt, extras = _inputs(arch)
    res = {}
    pd = distribute(params, param_shardings(param_spec(cfg), mesh), dm)
    shape = ShapeConfig("t", "train", _seq(arch), BATCH)
    bd = distribute(batch, S.batch_shardings(cfg, shape, mesh, batch), dm)
    step = make_train_step(cfg, PARITY_TC)
    replay = contextlib.nullcontext()
    with actctx.policy(actctx.make_train_policy(
            mesh, batch_axes=batch_axes(mesh, BATCH))):
        with actctx.sharded_ctx(pd), _Routes() as routes, \
                CostCounter() as counter:
            _, metrics, g2 = value_and_grad(cfg, pd, bd)
        if cfg.family == "moe":
            with torch.no_grad(), _Routes() as one:
                forward_train(params, cfg, batch)
            replay = _Replay(_routers(cfg, params), one.calls,
                             functools.partial(_train_groups, rank))
            with actctx.sharded_ctx(pd), replay:
                _, _, g2 = value_and_grad(cfg, pd, bd)
        with replay:
            p2, _, m2 = step(pd, init_opt_state(pd), bd)
    res["step"] = {"loss": float(m2["loss"]),
                   "grad_norm": float(m2["grad_norm"]),
                   "metrics": {k: float(m2[k]) for k in metrics},
                   "own_metrics": {k: float(v) for k, v in metrics.items()},
                   "grads": [_full(g) for g in leaves(g2)],
                   "leaves": [_full(t) for t in leaves(p2)],
                   "grad_placements": [str(g.placements)
                                       for g in leaves(g2)],
                   "placements": [str(t.placements) for t in leaves(pd)]}
    res["routes"] = [c.numpy() for c in routes.calls[:cfg.num_layers]]
    res["gathered"] = sorted(counter.cost.gathered)
    if arch in TRAIN_ARCHS:
        hist = []
        pt, _, _ = train(cfg, _train_tc(out_dir), batch=BATCH, seq=SEQ,
                         steps=2, device="cpu", mesh=mesh, resume=False,
                         history=hist, log_every=2)
        res["train"] = ([(h["loss"], h["grad_norm"]) for h in hist
                         if "step" in h], [_full(t) for t in leaves(pt)])
    model = Transformer(cfg, pd)
    pshape = ShapeConfig("p", "prefill", PROMPT, BATCH)

    def lay(b):
        return distribute(b, S.batch_shardings(cfg, pshape, mesh, b), dm)

    with actctx.policy(actctx.make_infer_policy(
            mesh, batch_axes=batch_axes(mesh, BATCH))), torch.no_grad(), \
            implicit_replication():
        with _Routes() as routes:
            logits, _ = forward_prefill(
                model, cfg, lay({"tokens": prompt[:, :PROMPT], **extras}))
        res["prefill_routes"] = [c.numpy() for c in routes.calls]
        _, cache1 = forward_prefill(Transformer(cfg, params), cfg,
                                    {"tokens": prompt[:, :PROMPT], **extras})
        full = pad_cache_for_decode(cfg, cache1, _ctx(cfg), BATCH)
        cd = distribute(full, S.cache_shardings(cfg, mesh, BATCH, _ctx(cfg)),
                        dm)
        steps = _decode(model, cfg, cd, prompt,
                        lambda t: lay({"tokens": t})["tokens"])
        res["serve"] = (_full(logits), [_full(x) for x in steps])
    return res


# (from, to) placements of a (4, 8, 6) tensor on the (2, 2) mesh ("r"
# replicated, an int the dim a mesh dim splits): a move of one mesh
# dim's split that an all-to-all takes, another with the other mesh dim
# splitting a third dim, and two moves that cross (gathered and sliced)
RELAYOUTS = (((1, 1), ("r", 0)), ((0, 2), (0, 1)), ((0, 1), (1, 0)))


def _relayout_routes(dm) -> list:
    """``actctx.relayout`` of each of RELAYOUTS by both routes
    (``all_to_all_route`` forced each way): the placements it gives, the
    whole tensor, the whole gradient of a weighted sum through it, and
    the collectives it issued."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed import actctx
    from repro_torch.roofline.jaxpr_cost import CostCounter

    def pl(spec):
        return tuple(Replicate() if q == "r" else Shard(q) for q in spec)

    g = torch.Generator().manual_seed(5)
    x, w = torch.randn(4, 8, 6, generator=g), torch.randn(4, 8, 6,
                                                         generator=g)
    real, out = actctx.all_to_all_route, []
    try:
        for cur, tgt in RELAYOUTS:
            got = {}
            for route in (True, False):
                actctx.all_to_all_route = lambda mesh, r=route: r
                d = distribute_tensor(x, dm, pl(cur)).requires_grad_(True)
                with CostCounter() as counter:
                    y = actctx.relayout(d, pl(tgt))
                (y * distribute_tensor(w, dm, pl(tgt))).sum().backward()
                got[route] = {
                    "placements": tuple(y.placements) == pl(tgt),
                    "value": y.full_tensor().detach().numpy(),
                    "grad": d.grad.full_tensor().numpy(),
                    "ops": sorted({op for op, _ in counter.cost.collectives})}
            out.append(got)
    finally:
        actctx.all_to_all_route = real
    return out, x.numpy(), w.numpy()


def rank_main(argv) -> None:
    """One rank: ``rank rendezvous out-dir``; each rank writes its
    results (the routing choices differ by rank)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import device_mesh, make_local_mesh
    rank, rdzv, out_dir = int(argv[0]), argv[1], argv[2]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                            world_size=WORLD)
    try:
        mesh = make_local_mesh(2, 2)
        dm = device_mesh(mesh, "cpu")
        res = {arch: _rank_arch(arch, mesh, dm, out_dir, rank)
               for arch in ARCHS}
        res["relayout"] = _relayout_routes(dm)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


_WORKER = ("import sys; sys.path[:0] = [{tests!r}, {src!r}]; "
           "import test_torch_sharded_families as t; "
           "t.rank_main(sys.argv[1:])")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of the one spawn of WORLD rank processes."""
    out = tmp_path_factory.mktemp("sharded_families")
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
    got = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return got


def _norm(tree) -> float:
    return float(torch.sqrt(sum((t.float() ** 2).sum() for t in tree)))


@functools.lru_cache(maxsize=None)
def _one_process(arch: str) -> dict:
    """The one-process train step, routing and serving of ``arch``, and
    its rounding floor: the gaps of the gradient norm and of each
    gradient leaf between attention through the chunked forward and
    through materialized scores (``impl="naive"``; the MoE's routing
    replayed), two roundings of one function."""
    cfg, params, batch, prompt, extras = _inputs(arch)
    step = make_train_step(cfg, PARITY_TC)
    with _Routes() as routes:
        _, metrics, g1 = value_and_grad(cfg, params, batch)
    with _Replay(_routers(cfg, params) if cfg.family == "moe" else [],
                 routes.calls[:cfg.num_layers], lambda w: w):
        _, _, gn = value_and_grad(cfg, params, batch, impl="naive")
    floor = {"grad_norm": abs(_norm(leaves(gn)) / _norm(leaves(g1)) - 1),
             "grads": max(_rel(a.float().numpy(), b.float().numpy())
                          for a, b in zip(leaves(gn), leaves(g1)))}
    p1, _, m1 = step(params, init_opt_state(params), batch)
    model = Transformer(cfg, params)
    with torch.no_grad():
        with _Routes() as proutes:
            logits, cache = forward_prefill(
                model, cfg, {"tokens": prompt[:, :PROMPT], **extras})
        steps = _decode(model, cfg, pad_cache_for_decode(
            cfg, cache, _ctx(cfg), BATCH), prompt)
        # the routing's own floor: the share of choices the two roundings
        # route apart
        with _Routes() as naive:
            forward_train(params, cfg, batch, impl="naive")
            forward_prefill(model, cfg, {"tokens": prompt[:, :PROMPT],
                                         **extras}, impl="naive")
    floor["flips"] = max(
        [float((a != b).float().mean()) for a, b in zip(
            naive.calls, routes.calls[:cfg.num_layers] + proutes.calls)],
        default=0.0)
    return {"params": params, "grads": leaves(g1), "leaves": leaves(p1),
            "floor": floor,
            "loss": float(m1["loss"]), "grad_norm": float(m1["grad_norm"]),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "routes": [c.numpy() for c in routes.calls[:cfg.num_layers]],
            "prefill_routes": [c.numpy() for c in proutes.calls],
            "logits": logits, "steps": steps}


def _rel(got, want) -> float:
    """``|got - want| / |want|`` (Frobenius norms) of numpy arrays."""
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _updates_close(got, want, before):
    gaps = [_rel(a - p.numpy(), b.float().numpy() - p.numpy())
            for a, b, p in zip(got, want, before)]
    assert max(gaps) < DELTA_TOL, gaps


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_one_process(ranks, arch):
    """The dense family's bounds, or twice the one-process rounding
    floor where that is larger (the hybrid: six mamba layers around
    shared attention carry an ulp of bf16 further, as its documented
    gap to the reference in ``tests/test_torch_train_families.py``)."""
    one = _one_process(arch)
    got = ranks[0][arch]["step"]
    assert abs(got["loss"] - one["loss"]) < LOSS_TOL
    assert len(got["leaves"]) == len(one["leaves"])
    for i, (a, b) in enumerate(zip(got["leaves"], one["leaves"])):
        np.testing.assert_allclose(a, b.float().numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"leaf {i}")
    floor = one["floor"]
    gnorm = abs(got["grad_norm"] / one["grad_norm"] - 1)
    print(f"{arch}: grad norm gap {gnorm:.3e} "
          f"(floor {floor['grad_norm']:.3e})")
    assert gnorm < max(GNORM_TOL, 2 * floor["grad_norm"])
    gaps = [_rel(a, b.float().numpy())
            for a, b in zip(got["grads"], one["grads"])]
    print(f"{arch}: gradient gap {max(gaps):.3e} (floor {floor['grads']:.3e})")
    assert max(gaps) < max(GRAD_TOL, 2 * floor["grads"]), gaps
    _updates_close(got["leaves"], one["leaves"], leaves(one["params"]))
    # every gradient laid out as its parameter
    assert got["grad_placements"] == got["placements"]


def _moe_leaves(arch):
    """Indices (in ``leaves`` order) of the MoE blocks' expert weights
    and their shard shapes on (2, 2), one layer's."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.params import param_shardings
    cfg = smoke_config(arch)
    spec = param_spec(cfg)
    shs = param_shardings(spec, make_local_mesh(2, 2))
    out = {}
    for seg, seg_sh in zip(spec["segments"], shs["segments"]):
        if "moe" not in seg:
            continue
        for k in moe.EXPERT_LEAVES:
            if k in seg["moe"]:
                s, sh = seg["moe"][k], seg_sh["moe"][k]
                out[k] = sh.shard_shape(s.shape)[1:]
    return out


def test_moe_aux_routing_and_expert_layout(ranks):
    """The MoE's aux metrics equal the one-process run's (each a mean
    over all groups, summed across ranks) where the routing is the
    same; its own routing choices differ in at most twice the share
    that the one-process run's two roundings route apart; its expert
    weights stay sharded in 2-D (experts over "model", their ffn dim
    over "data") and no all-gather moves one."""
    one = _one_process(MOE)
    got = ranks[0][MOE]["step"]
    # with the one-process routing replayed
    for k, v in one["metrics"].items():
        assert abs(got["metrics"][k] - v) <= AUX_TOL * max(abs(v), 1.0), k
    for r in ranks:                      # aux the same on every rank
        assert r[MOE]["step"]["metrics"] == got["metrics"]
        assert r[MOE]["step"]["own_metrics"] == got["own_metrics"]
    print(f"aux with its own routing {got['own_metrics']}, one process "
          f"{one['metrics']}")
    # train (sequence 512, groups of 256): rank (i, j) holds rows 2i,
    # 2i+1 and the j-th half of each, a group each: group k of rank
    # (i, j) is the one-process group (2i + k) * 2 + j
    flips = []
    for layer, want in enumerate(one["routes"]):
        back = np.empty_like(want)
        for r in range(WORLD):
            i, j = divmod(r, 2)
            loc = ranks[r][MOE]["routes"][layer]
            for k in range(loc.shape[0]):
                back[(2 * i + k) * 2 + j] = loc[k]
        flips.append(float(np.mean(back != want)))
    # prefill (prompt 32, one group a row): the model ranks share their
    # data rank's two rows out, rank r routing row r
    for layer, want in enumerate(one["prefill_routes"]):
        back = np.concatenate([ranks[r][MOE]["prefill_routes"][layer]
                               for r in range(WORLD)])
        flips.append(float(np.mean(back != want)))
    print(f"routing choices that differ: {flips} (floor "
          f"{one['floor']['flips']})")
    assert 0 < one["floor"]["flips"] and max(flips) <= 2 * one["floor"][
        "flips"], flips
    shapes = _moe_leaves(MOE)
    assert shapes
    for r in ranks:
        pl = r[MOE]["step"]["placements"]
        assert pl.count("(Shard(dim=3), Shard(dim=1))") >= 2     # wi, wg
        assert pl.count("(Shard(dim=2), Shard(dim=1))") >= 1     # wo
        moved = [g for g in r[MOE]["gathered"] if g[0] in shapes.values()]
        assert not moved, moved


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_one_process(ranks, arch):
    one = _one_process(arch)
    got_prefill, got_steps = ranks[0][arch]["serve"]
    np.testing.assert_allclose(got_prefill, one["logits"].float().numpy(),
                               atol=LOGIT_TOL, rtol=0)
    assert len(got_steps) == DECODE
    for a, b in zip(got_steps, one["steps"]):
        np.testing.assert_allclose(a, b.float().numpy(), atol=LOGIT_TOL,
                                   rtol=0)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_entry_point_on_a_mesh(ranks, arch, tmp_path):
    cfg = smoke_config(arch)
    tc = _train_tc(str(tmp_path))
    hist = []
    p1, _, _ = train(cfg, tc, batch=BATCH, seq=SEQ, steps=2, device="cpu",
                     resume=False, history=hist, log_every=2)
    steps, got = ranks[0][arch]["train"]
    want = [(h["loss"], h["grad_norm"]) for h in hist if "step" in h]
    assert len(steps) == len(want) == 2
    for (loss, gnorm), (loss1, gnorm1) in zip(steps, want):
        assert abs(loss - loss1) < LOSS_TOL
        assert abs(gnorm / gnorm1 - 1) < GNORM_TOL
    p0, _ = build_state(cfg, tc, "cpu")
    _updates_close(got, leaves(p1), leaves(p0))


def test_train_refuses_a_family_outside_sharded_families(monkeypatch,
                                                         tmp_path):
    """``train(mesh=)`` and ``lower_cell`` refuse a family that is not
    in ``SHARDED_FAMILIES`` at a mesh of more than one device, before
    any state is built (no process group is needed to refuse); at one
    device every family trains."""
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_local_mesh
    monkeypatch.setattr(S, "SHARDED_FAMILIES", ("dense",))
    built = []
    monkeypatch.setattr(T, "build_state",
                        lambda *a, **k: built.append(a) or build_state(*a,
                                                                       **k))
    tc = _train_tc(str(tmp_path))
    for arch in ARCHS:
        cfg = smoke_config(arch)
        with pytest.raises(NotImplementedError, match=cfg.family):
            train(cfg, tc, batch=BATCH, seq=SEQ, steps=1, device="cpu",
                  mesh=make_local_mesh(2, 2), resume=False)
        with pytest.raises(NotImplementedError, match="SHARDED_FAMILIES"):
            S.lower_cell(cfg, ShapeConfig("x", "decode", 64, 2),
                         make_local_mesh(2, 1))
    assert not built
    _, _, losses = train(smoke_config(MOE), tc, batch=2, seq=32, steps=1,
                         device="cpu", mesh=make_local_mesh(), resume=False)
    assert len(losses) == 1 and len(built) == 1


def test_relayout_routes_agree(ranks):
    """Both routes of ``actctx.relayout`` give every rank the same
    tensor and gradient: the all-to-all route issues an all-to-all
    where one mesh dim's split moves alone and the gather route never
    does; two moves that cross are gathered and sliced by either."""
    for r in ranks:
        cases, x, w = r["relayout"]
        for n, got in enumerate(cases):
            for route in (True, False):
                assert got[route]["placements"], (n, route)
                np.testing.assert_array_equal(got[route]["value"], x)
                np.testing.assert_array_equal(got[route]["grad"], w)
            assert ("all_to_all_single" in got[True]["ops"]) == (n < 2), n
            assert "all_to_all_single" not in got[False]["ops"], n
