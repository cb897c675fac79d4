"""The port's one-card LM dry-run against the JAX package's, on the CPU.

Host code, no devices.  For every (arch x shape) cell of the registry at
full width and depth: ``input_specs`` (keys, shapes, dtypes), the bytes
of ``abstract_params`` and ``abstract_opt_state``, ``model_flops``,
``analytic_memory_bytes`` and ``batch_axes`` on the one-card, pod and
multi-pod meshes equal the reference's (nothing is traced: the
reference's side is ``jax.eval_shape``).

At the smoke configs, ``lower_cell``'s counted matmul FLOPs for train,
prefill and decode hold a pinned relation to the reference's
``jaxpr_cost.count_fn`` on its step:

  * the reference counts a ``dot_general`` whose contracted size is 1
    or which contracts nothing (MoE's ``bte,btec->btec``, the outer
    product of the first step of SSD's three-operand einsums, decode's
    ``bsec,bsd->ebcd`` over one token) as 2·prod matmul FLOPs; torch's
    einsum computes those as elementwise products, which the port counts
    as elementwise FLOPs.  Left out of the reference's count, prefill
    and decode are equal for all ten archs, and train for the dense,
    MoE, audio and vlm families;
  * train of a mamba layer: the reference's backward of SSD's
    three-operand einsums contracts the broadcast decay factors with a
    ``dot_general`` (over the state dim N for the chunk states, the head
    dim P for the inter-chunk output), where torch's backward of the
    port's broadcast multiply is a multiply and a sum: 2·B·S·H·(N + P)
    matmul FLOPs a mamba layer that the port counts as elementwise.

Remat costs the same in both: the port's ``torch.utils.checkpoint``
stops its recompute at the last tensor the backward needs, as JAX's
remat drops what it does not need (the MoE computes its aux losses
before its experts so that a layer's last saved tensors are the combine
einsum's inputs).
"""

import dataclasses
import json
import math
import os
import pathlib
import re
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import REPO, SRC
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.configs.base import shapes_for as ref_shapes_for
from repro.configs.registry import ARCHS as REF_ARCHS
from repro.configs.registry import get_arch as ref_get_arch
from repro.configs.registry import smoke_config as ref_smoke
from repro.launch import steps as RS
from repro.launch.mesh import batch_axes as ref_batch_axes
from repro.models import param_spec as ref_spec
from repro.models.params import abstract_params as ref_abstract_params
from repro.roofline import analysis as ref_analysis
from repro.roofline import jaxpr_cost as RJ
from repro.roofline.recost import analytic_memory_bytes as ref_analytic

from repro_torch.configs.base import ShapeConfig, shapes_for
from repro_torch.configs.registry import ARCHS, get_arch, smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import (batch_axes, make_local_mesh,
                                     make_production_mesh)
from repro_torch.models import abstract_params, param_spec
from repro_torch.roofline import analysis, recost
from repro_torch.tree import leaves

CELLS = [(a, s.name) for a, c in REF_ARCHS.items() for s in ref_shapes_for(c)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread a worker keeps the test
    workers, which share the cores, from oversubscribing them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _abs_bytes(tree) -> int:
    return sum(math.prod(x.shape) * jnp.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


def test_cells_match_reference():
    assert [(a, s.name) for a, c in ARCHS.items()
            for s in shapes_for(c)] == CELLS
    assert len(CELLS) == 34


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_inputs_and_models_match_reference(arch, shape):
    """input_specs, parameter and optimizer-state bytes, model FLOPs,
    the analytic HBM model and the batch axes of one full-size cell."""
    cfg, rcfg = get_arch(arch), ref_get_arch(arch)
    sh = next(s for s in shapes_for(cfg) if s.name == shape)
    rsh = next(s for s in ref_shapes_for(rcfg) if s.name == shape)
    got, want = S.input_specs(cfg, sh), RS.input_specs(rcfg, rsh)
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        assert got[k].is_meta
    spec, rspec = param_spec(cfg), ref_spec(rcfg)
    port_bytes = S.tree_bytes(abstract_params(spec)) \
        + S.tree_bytes(S.abstract_opt_state(spec))
    assert port_bytes == _abs_bytes(ref_abstract_params(rspec)) \
        + _abs_bytes(RS.abstract_opt_state(rspec))
    assert analysis.model_flops(cfg, sh) == ref_analysis.model_flops(rcfg,
                                                                     rsh)
    assert recost.analytic_memory_bytes(cfg, sh) == ref_analytic(rcfg, rsh)
    for mesh in (make_local_mesh(), make_production_mesh(),
                 make_production_mesh(multi_pod=True)):
        assert batch_axes(mesh, sh.global_batch) == ref_batch_axes(
            SimpleNamespace(shape=mesh.shape), rsh.global_batch)


def test_meshes_match_reference_shapes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).size == 512
    assert make_local_mesh().size == 1
    assert batch_axes(make_production_mesh(multi_pod=True), 64) == (
        "pod", "data")
    assert batch_axes(make_production_mesh(), 1) is None


def _trivial_dots_left_out(monkeypatch):
    """The reference's counter without dot_generals whose contracted size
    is 1 or which contract nothing (see the module docstring)."""
    orig = RJ._dot_flops

    def contracting(eqn):
        (lc, _), _ = eqn.params["dimension_numbers"]
        lhs = eqn.invars[0].aval
        return orig(eqn) if math.prod(lhs.shape[i] for i in lc) > 1 \
            else 0.0

    monkeypatch.setattr(RJ, "_dot_flops", contracting)


def _ssd_bwd_dots(cfg, shape) -> float:
    """2·B·S·H·(N + P) a mamba layer: the reference's backward contracts
    SSD's broadcast decay factors, the port's multiplies and sums."""
    if shape.kind != "train" or cfg.family not in ("ssm", "hybrid"):
        return 0.0
    return (2.0 * shape.global_batch * shape.seq_len * cfg.ssm_nheads
            * (cfg.ssm_state + cfg.ssm_head_dim) * cfg.num_layers)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", list(REF_ARCHS))
def test_counted_matmul_flops_match_reference(arch, kind, monkeypatch):
    _trivial_dots_left_out(monkeypatch)
    cfg, rcfg = smoke_config(arch), ref_smoke(arch)
    sh, rsh = ShapeConfig("x", kind, 64, 2), RefShapeConfig("x", kind, 64, 2)
    plan, meta = S.lower_cell(cfg, sh, make_local_mesh())
    rp = ref_abstract_params(ref_spec(rcfg))
    batch = RS.input_specs(rcfg, rsh)
    if kind == "train":
        want = RJ.count_fn(RS.make_train_step(
            rcfg, RS.default_train_config(rcfg)), rp,
            RS.abstract_opt_state(ref_spec(rcfg)), batch)
    elif kind == "prefill":
        want = RJ.count_fn(RS.make_prefill_step(rcfg),
                           RS._to_serving_dtype(rp), batch)
    else:
        want = RJ.count_fn(RS.make_decode_step(rcfg),
                           RS._to_serving_dtype(rp),
                           RS.abstract_cache(rcfg, 2, 64), batch)
    assert plan.cost.matmul_flops == want.matmul_flops \
        - _ssd_bwd_dots(cfg, sh), (arch, kind)
    assert meta["program"] == {"train": "train_step",
                               "prefill": "prefill_step",
                               "decode": "serve_step(decode)"}[kind]
    assert plan.attention_route == "plain"
    assert plan.temp_bytes > 0 and plan.out_bytes > 0


def test_lower_cell_args_and_autograd_lifetimes():
    """Argument bytes: f32 parameters and (m, v, step) for train, the
    same f32 parameters (the dtype the port serves) plus the cache for
    serving.  The
    planned temp bytes of a train step hold what autograd saves: the
    remat run keeps less than the run without remat, and both more than
    a forward-only prefill of the same tokens."""
    cfg = smoke_config("tinyllama-1.1b")
    n = sum(t.numel() for t in leaves(abstract_params(param_spec(cfg))))
    mesh = make_local_mesh()
    tr = S.lower_cell(cfg, ShapeConfig("x", "train", 64, 2), mesh)[0]
    assert tr.arg_bytes == 3 * 4 * n + 4 + 2 * 64 * 4
    pf = S.lower_cell(cfg, ShapeConfig("x", "prefill", 64, 2), mesh)[0]
    assert pf.arg_bytes == 4 * n + 2 * 64 * 4
    # activations outweigh the optimizer's trees at 8 x 512 tokens
    big = ShapeConfig("x", "train", 512, 8)
    remat = S.lower_cell(cfg, big, mesh)[0]
    no_remat = S.lower_cell(cfg, big, mesh, dataclasses.replace(
        S.default_train_config(cfg), remat=False))[0]
    fwd = S.lower_cell(cfg, dataclasses.replace(big, kind="prefill"),
                       mesh)[0]
    assert no_remat.temp_bytes > remat.temp_bytes \
        > fwd.temp_bytes + remat.arg_bytes - fwd.arg_bytes
    assert no_remat.cost.matmul_flops < remat.cost.matmul_flops


NON_DENSE = ("phi3.5-moe-42b-a6.6b", "mamba2-1.3b", "zamba2-7b",
             "whisper-small", "internvl2-1b")


def test_lower_cell_plans_every_family_at_a_mesh():
    """Every family plans at a mesh of more than one device: the MoE,
    SSM, hybrid, audio and vlm archs (and a dense one) at (2, 1) and
    pod, each device's argument bytes under the one card's."""
    shape = ShapeConfig("x", "decode", 64, 2)
    for arch in NON_DENSE + ("tinyllama-1.1b",):
        cfg = smoke_config(arch)
        one = S.lower_cell(cfg, shape, make_local_mesh())[0]
        for mesh in (make_production_mesh(), make_local_mesh(2, 1)):
            plan, meta = S.lower_cell(cfg, shape, mesh)
            assert meta["program"] == "serve_step(decode)"
            assert 0 < plan.arg_bytes < one.arg_bytes, (arch, mesh)


def test_lower_cell_refuses_a_larger_mesh(monkeypatch):
    """A family taken out of ``SHARDED_FAMILIES`` is refused at a mesh
    of more than one device (``NotImplementedError``) and still plans
    on one device."""
    shape = ShapeConfig("x", "decode", 64, 2)
    monkeypatch.setattr(S, "SHARDED_FAMILIES", ("dense",))
    for arch in NON_DENSE:
        with pytest.raises(NotImplementedError, match="SHARDED_FAMILIES"):
            S.lower_cell(smoke_config(arch), shape, make_local_mesh(2, 1))
        assert S.lower_cell(smoke_config(arch), shape,
                            make_local_mesh())[0].arg_bytes > 0


def _ref_record_keys() -> set:
    """The reference's dry-run record keys: its Roofline's fields and
    what ``run_cell`` adds (read from src/repro/launch/dryrun.py, which
    cannot be imported in a test worker: it sets XLA_FLAGS)."""
    src = (pathlib.Path(SRC) / "repro" / "launch" / "dryrun.py").read_text()
    block = src[src.index("rec.update({"):].split("})", 1)[0]
    return ({f.name for f in dataclasses.fields(ref_analysis.Roofline)}
            | set(re.findall(r'"(\w+)":', block)))


RECOST_KEYS = {"jaxpr_matmul_flops_total", "jaxpr_elementwise_flops_total",
               "jaxpr_bytes_unfused_total", "analytic_hbm_bytes_total"}


def test_records_have_reference_keys_and_recost(tmp_path):
    """run_cell's record: the reference's keys, compile_s replaced by
    lower_s (``timing`` says so), plus ``h100``, ``attention_route`` and
    the counted FLOPs and unfused bytes under the reference recost's
    ``jaxpr_*`` keys (the plan's counts); recost adds the analytic bytes
    and prices them and the counted FLOPs, re-planning nothing."""
    cfg = smoke_config("phi3.5-moe-42b-a6.6b")
    rec = dryrun.run_cell(cfg.name, "decode_32k", "single", tmp_path,
                          cfg=cfg)
    want = _ref_record_keys()
    assert "compile_s" in want and "lower_s" in want
    assert set(rec) == (want - {"compile_s"}) | {
        "h100", "attention_route", "timing"} | (
        RECOST_KEYS - {"analytic_hbm_bytes_total"})
    plan = S.lower_cell(cfg, ShapeConfig("decode_32k", "decode", 32768, 128),
                        make_local_mesh())[0]
    assert rec["jaxpr_matmul_flops_total"] == plan.cost.matmul_flops
    assert rec["jaxpr_elementwise_flops_total"] == \
        plan.cost.elementwise_flops
    assert rec["jaxpr_bytes_unfused_total"] == plan.cost.bytes_touched
    assert "compile_s" in rec["timing"]
    assert rec["devices"] == 1 and rec["status"] == "ok"
    assert rec["collective_wire_bytes"] == 0.0
    h = rec["h100"]
    assert h["matmul_flops_per_s"] == analysis.H100_PEAK_FLOPS_BF16
    path = tmp_path / f"{cfg.name}__decode_32k__single.json"
    assert json.loads(path.read_text()) == rec
    new = recost.update_artifact(path, cfg)
    assert set(new) == set(rec) | RECOST_KEYS
    sh = ShapeConfig("decode_32k", "decode", 32768, 128)
    assert new["analytic_hbm_bytes_total"] == ref_analytic(
        ref_smoke(cfg.name), RefShapeConfig("d", "decode", 32768, 128))
    assert new["bytes_per_device"] == recost.analytic_memory_bytes(cfg, sh)
    mm, ew = new["jaxpr_matmul_flops_total"], \
        new["jaxpr_elementwise_flops_total"]
    assert new["h100"]["compute_s"] == pytest.approx(
        mm / analysis.H100_PEAK_FLOPS_BF16 + ew / analysis.H100_PEAK_FLOPS_F32)
    assert json.loads(path.read_text()) == new


def test_h100_prices_lm_matmuls_at_bf16_and_graphs_at_f32():
    r = analysis.Roofline("a", "s", "m", 1, 1e12, 1e9, 0.0, 1e12)
    g = dataclasses.replace(r).finalize()
    assert g.h100["compute_s"] == pytest.approx(
        1e12 / analysis.H100_PEAK_FLOPS_F32)
    assert "matmul_flops_per_s" not in g.h100
    lm = dataclasses.replace(r).finalize(matmul_flops_per_device=8e11)
    assert lm.h100["compute_s"] == pytest.approx(
        8e11 / analysis.H100_PEAK_FLOPS_BF16
        + 2e11 / analysis.H100_PEAK_FLOPS_F32)
    assert lm.compute_s == g.compute_s


def _cli_pod(monkeypatch, tmp_path, arch, shape):
    """``dryrun --arch arch --shape shape --smoke --mesh pod``'s record."""
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", arch, "--shape", shape, "--smoke",
        "--mesh", "pod", "--out", str(tmp_path)])
    dryrun.main()
    return json.loads((tmp_path / f"{arch}__{shape}__pod.json").read_text())


def test_cli_arch_plans_every_family_at_pod(monkeypatch, tmp_path):
    """``--mesh pod``: every family's cell plans 256 devices (the dense
    arch's and the MoE, SSM, hybrid, audio and vlm archs')."""
    for arch in NON_DENSE:
        rec = _cli_pod(monkeypatch, tmp_path, arch, "train_4k")
        assert rec["status"] == "ok" and rec["devices"] == 256, arch
        assert rec["collective_wire_bytes"] > 0, arch
    rec = _cli_pod(monkeypatch, tmp_path, "tinyllama-1.1b", "decode_32k")
    assert rec["status"] == "ok" and rec["devices"] == 256
    assert rec["collective_wire_bytes"] > 0


def test_cli_arch_with_pod_mesh_raises_l6(monkeypatch, tmp_path, capsys):
    """``--mesh pod`` with a family taken out of ``SHARDED_FAMILIES``:
    the CLI records the error and exits 1."""
    monkeypatch.setattr(S, "SHARDED_FAMILIES", ("dense",))
    with pytest.raises(SystemExit):
        _cli_pod(monkeypatch, tmp_path, NON_DENSE[0], "train_4k")
    rec = json.loads((tmp_path / f"{NON_DENSE[0]}__train_4k__pod.json")
                     .read_text())
    assert rec["status"] == "fail" and "SHARDED_FAMILIES" in rec["error"]
    assert "SHARDED_FAMILIES" in capsys.readouterr().out


def test_cli_smoke_cells_in_worker_processes(tmp_path):
    """``--arch a,b --shape ... --smoke --jobs 2``: a record for every
    cell, as a single-process pass writes it but for the wall time."""
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-1.3b,whisper-small", "--shape", "decode_32k,long_500k",
         "--smoke", "--jobs", "2", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "All dry-run cells passed." in r.stdout
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted(f"{a}__{s}__single.json" for a in (
        "mamba2-1.3b", "whisper-small") for s in ("decode_32k",
                                                  "long_500k"))
    got = json.loads((tmp_path / "mamba2-1.3b__decode_32k__single.json")
                     .read_text())
    direct = dryrun.run_cell("mamba2-1.3b", "decode_32k", "single", None,
                             cfg=smoke_config("mamba2-1.3b"))
    got.pop("lower_s"), direct.pop("lower_s")
    assert got == direct


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "phi3.5-moe-42b-a6.6b",
                                  "mamba2-1.3b", "zamba2-7b",
                                  "whisper-small", "internvl2-1b"])
def test_planned_peak_is_the_counted_peak_of_a_cpu_run(arch):
    """The plan on meta tensors against the same train step and prefill
    run on CPU tensors under the counter (the plain attention route on
    both): equal matmul FLOPs and equal peak live bytes, so the planned
    temp bytes follow the storages autograd saves and frees, as a real
    run holds them."""
    from repro_torch.launch.train import build_state
    from repro_torch.models import Transformer
    from repro_torch.roofline.jaxpr_cost import CostCounter

    cfg = smoke_config(arch)
    mesh = make_local_mesh()
    tc = S.default_train_config(cfg)
    sh = ShapeConfig("x", "train", 64, 2)
    params, opt = build_state(cfg, tc, "cpu")
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in S.input_specs(cfg, sh).items()}
    for kind, fn, args in (
            ("train", S.make_train_step(cfg, tc), (params, opt, batch)),
            ("prefill", S.make_prefill_step(cfg),
             (Transformer(cfg, params), batch))):
        plan = S.lower_cell(cfg, dataclasses.replace(sh, kind=kind), mesh,
                            tc)[0]
        counter = CostCounter()
        with counter, torch.set_grad_enabled(kind == "train"):
            fn(*args)
        assert plan.temp_bytes == counter.cost.peak_live_bytes, kind
        assert plan.cost.matmul_flops == counter.cost.matmul_flops, kind
        assert plan.arg_bytes == sum(S.tree_bytes(a) for a in args), kind
