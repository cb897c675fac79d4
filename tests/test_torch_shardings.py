"""The port's sharded LM plans against the JAX package's, exactly.

For each of the ten archs at its full config, at the pod (16 x 16) and
multipod (2 x 16 x 16) meshes: every parameter leaf's partition
(``resolve_axes`` through ``param_shardings``) and shard shape, the
per-device parameter bytes, and for every shape ``shapes_for`` gives
the arch, ``batch_shardings`` and ``cache_shardings`` leaf for leaf.
The activation policies (``make_train_policy``, ``make_infer_policy``)
give the reference's layout for every kind and ndim, the heads and ffn
rules on both sides of the "model" axis's size.

The reference side runs in one subprocess on 512 host devices
(``conftest.run_with_devices``); it builds shardings and lowers
nothing.  Then, at the smoke configs of the dense family on
``make_local_mesh(2, 4)`` and the pod mesh, ``lower_cell``'s sharded
plans (in a subprocess of their own: planning starts a fake process
group of the mesh's size):

  * per-device argument bytes equal the shards' bytes of the plans
    (parameters, AdamW's m and v and its step, the batch, the cache);
  * train cells' argument bytes equal the reference's compiled
    ``memory_analysis().argument_size_in_bytes`` at the same 8-device
    mesh; serving cells hold the one-card relation
    (``tests/test_torch_lm_dryrun.py``): the port plans f32 weights
    where the reference's serving checkpoints are bf16, so the port's
    parameter shards are twice the reference's and the rest equal;
  * per-device matmul FLOPs times the mesh size against the one-card
    plan's.  At (2, 4) the one excess is the k and v projections: the
    smoke configs' 2 kv heads do not divide the model axis of 4, so
    ``resolve_axes`` replicates ``wk`` and ``wv`` and every model rank
    projects the same k and v, m - 1 = 3 copies too many of
    2·B·S·d·KH·hd FLOPs each, four times a layer in a train step (the
    forward, the remat recompute, the backward's two products) and once
    in a prefill; a decode step has none.  At the pod mesh (model axis
    16) the smoke configs' heads (4) and kv heads replicate too, so the
    excess is bounded by the model axis's size;
  * the collectives' wire bytes by op, printed beside the reference's
    HLO figures at the same mesh.  The relation is pinned: GSPMD moves
    what DTensor moves and more (its weight gathers are bf16 where the
    port gathers the f32 masters, it reshards around the scan carry,
    and it all-reduces where DTensor reduce-scatters), so the two are
    not equal op by op (ROADMAP.md, section 3).
"""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from conftest import SRC, run_with_devices
from repro_torch.configs.base import shapes_for
from repro_torch.configs.registry import ARCHS, smoke_config
from repro_torch.distributed import actctx
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import batch_shardings, cache_shardings, \
    input_specs
from repro_torch.models import param_spec
from repro_torch.models.params import param_shardings, resolve_axes, \
    DEFAULT_RULES
from repro_torch.tree import leaves

MESHES = (("pod", False), ("multipod", True))
# (kind, shape) probes of the policies: below and above the model axis
POLICY_PROBES = (("resid", (32, 16, 8)), ("batch", (32, 16)),
                 ("batch", (32, 16, 8)), ("heads", (32, 16, 4, 8)),
                 ("heads", (32, 16, 32, 8)), ("ffn", (32, 16, 8)),
                 ("ffn", (32, 16, 64)), ("resid", (32, 16)),
                 ("heads", (32, 16, 8)), ("ffn", (32, 16, 4, 8)))

_REF = """
import json, jax, numpy as np
from repro.configs.registry import ARCHS
from repro.configs.base import shapes_for
from repro.distributed import actctx
from repro.launch.mesh import make_production_mesh, batch_axes
from repro.launch.steps import batch_shardings, cache_shardings, input_specs
from repro.models import param_spec
from repro.models.params import param_shardings, is_spec

def spec(ns):
    return None if ns is None else [list(e) if isinstance(e, tuple) else e
                                    for e in ns.spec]

out = {"params": {}, "policies": {}}
for name, multi in (("pod", False), ("multipod", True)):
    mesh = make_production_mesh(multi_pod=multi)
    for arch, cfg in ARCHS.items():
        tree = param_spec(cfg)
        sps = jax.tree.leaves(tree, is_leaf=is_spec)
        shs = jax.tree.leaves(param_shardings(tree, mesh))
        cells = {}
        for shape in shapes_for(cfg):
            b = input_specs(cfg, shape)
            c = cache_shardings(cfg, mesh, shape.global_batch, shape.seq_len)
            cells[shape.name] = {
                "batch": {k: spec(v) for k, v in
                          batch_shardings(cfg, shape, mesh, b).items()},
                "cache": [{k: spec(v) for k, v in seg.items()}
                          for seg in c["segments"]],
                "pos": spec(c["pos"])}
        out["params"][arch + "|" + name] = {
            "leaves": [[spec(s), list(s.shard_shape(p.shape))]
                       for p, s in zip(sps, shs)],
            "bytes": int(sum(np.prod(s.shard_shape(p.shape))
                             * np.dtype(p.dtype).itemsize
                             for p, s in zip(sps, shs))),
            "cells": cells}
    for ba in (None, "data", ("pod", "data")):
        if ba == ("pod", "data") and not multi:
            continue
        for pname, make in (("train", actctx.make_train_policy),
                            ("infer", actctx.make_infer_policy)):
            pol = make(mesh, batch_axes=ba)
            for kind, shp in PROBES:
                rule = pol[kind]
                x = jax.ShapeDtypeStruct(tuple(shp), jax.numpy.float32)
                sh = rule(x) if callable(rule) else rule.get(len(shp))
                out["policies"]["|".join([name, str(ba), pname, kind,
                                          str(shp)])] = spec(sh)
print("REF" + json.dumps(out))
"""


def _spec(sh):
    return None if sh is None else [list(e) if isinstance(e, tuple) else e
                                    for e in sh.spec]


@pytest.fixture(scope="module")
def ref():
    code = f"PROBES = {POLICY_PROBES!r}\n" + _REF
    text = run_with_devices(code, devices=512)
    return json.loads(text[text.index("REF") + 3:])


@pytest.mark.parametrize("mesh_name,multi", MESHES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_batch_and_cache_shardings_match_reference(ref, arch,
                                                         mesh_name, multi):
    cfg = ARCHS[arch]
    mesh = make_production_mesh(multi_pod=multi)
    want = ref["params"][f"{arch}|{mesh_name}"]
    tree = param_spec(cfg)
    sps = leaves(tree)
    shs = leaves(param_shardings(tree, mesh))
    got = [[_spec(s), list(s.shard_shape(p.shape))] for p, s in zip(sps, shs)]
    assert got == want["leaves"]
    assert [list(resolve_axes(p, DEFAULT_RULES, mesh)) for p in sps] == \
        [[e if not isinstance(e, list) else tuple(e) for e in w[0]]
         for w in want["leaves"]]
    nbytes = sum(math.prod(s.shard_shape(p.shape)) * p.dtype.itemsize
                 for p, s in zip(sps, shs))
    assert nbytes == want["bytes"]
    assert sorted(want["cells"]) == sorted(s.name for s in shapes_for(cfg))
    for shape in shapes_for(cfg):
        w = want["cells"][shape.name]
        b = input_specs(cfg, shape)
        assert {k: _spec(v) for k, v in
                batch_shardings(cfg, shape, mesh, b).items()} == w["batch"]
        c = cache_shardings(cfg, mesh, shape.global_batch, shape.seq_len)
        assert [{k: _spec(v) for k, v in seg.items()}
                for seg in c["segments"]] == w["cache"], shape.name
        assert _spec(c["pos"]) == w["pos"]


@pytest.mark.parametrize("mesh_name,multi", MESHES)
def test_policies_match_reference(ref, mesh_name, multi):
    mesh = make_production_mesh(multi_pod=multi)
    n = 0
    for ba in (None, "data", ("pod", "data")):
        if ba == ("pod", "data") and not multi:
            continue
        for pname, make in (("train", actctx.make_train_policy),
                            ("infer", actctx.make_infer_policy)):
            pol = make(mesh, batch_axes=ba)
            for kind, shp in POLICY_PROBES:
                x = torch.empty(shp, device="meta")
                key = "|".join([mesh_name, str(ba), pname, kind, str(shp)])
                with actctx.policy(pol):
                    assert _spec(actctx.layout(x, kind)) == \
                        ref["policies"][key], key
                n += 1
    assert n == sum(k.startswith(mesh_name + "|") for k in ref["policies"])


def test_policy_fallbacks_and_constrain_identity():
    """The heads rule replicates H under the model axis's size, the ffn
    rule likewise F; ``constrain`` is the identity on a plain tensor and
    with no policy."""
    mesh = make_production_mesh()
    pol = actctx.make_train_policy(mesh, batch_axes="data")
    assert pol["heads"](torch.empty(2, 8, 4, 8, device="meta")).spec == \
        ("data", None, None, None)
    assert pol["heads"](torch.empty(2, 8, 16, 8, device="meta")).spec == \
        ("data", None, "model", None)
    assert pol["ffn"](torch.empty(2, 8, 15, device="meta")).spec == \
        ("data", None, None)
    x = torch.ones(2, 3)
    with actctx.policy(pol):
        assert actctx.constrain(x, "batch") is x
    assert actctx.constrain(x, "batch") is x


# ---------------------------------------------------------------------------
# the sharded dry-run of the dense family, against the reference's compile
# ---------------------------------------------------------------------------

DENSE = ("tinyllama-1.1b", "h2o-danube-3-4b", "gemma3-27b", "qwen2.5-32b")
# small cells of each kind (the registry's full shapes are the CLI's)
CELLS = (("train", 64, 16), ("prefill", 64, 16), ("decode", 64, 16))

_REF_COMPILED = """
import json, jax
from repro.configs.base import ShapeConfig
from repro.configs.registry import smoke_config
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import lower_cell
from repro.roofline.analysis import parse_collectives
mesh = make_local_mesh(2, 4)
out = {}
for arch in ARCHS:
    for kind, seq, batch in CELLS:
        lowered, _ = lower_cell(smoke_config(arch),
                                ShapeConfig("c", kind, seq, batch), mesh)
        comp = lowered.compile()
        st = parse_collectives(comp.as_text())
        out[arch + "|" + kind] = {
            "args": comp.memory_analysis().argument_size_in_bytes,
            "wire": st.wire_bytes}
print("REF" + json.dumps(out))
"""

_PORT = """
import json, math, torch
torch.set_num_threads(1)
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.launch import steps as S
from repro_torch.models import param_spec
from repro_torch.models.params import param_shardings
from repro_torch.roofline.analysis import funcol_stats
from repro_torch.tree import leaves

def shard_bytes(tree, shs):
    return sum(t.element_size() * math.prod(s.shard_shape(t.shape))
               for t, s in zip(leaves(tree), leaves(shs))
               if isinstance(t, torch.Tensor))

out = {}
for arch in ARCHS:
    cfg = smoke_config(arch)
    spec = param_spec(cfg)
    one = {}
    for mname, mesh in (("local", make_local_mesh(2, 4)),
                        ("pod", make_production_mesh())):
        for kind, seq, batch in CELLS:
            shape = ShapeConfig("c", kind, seq, batch)
            if kind not in one:
                one[kind] = S.lower_cell(cfg, shape, make_local_mesh())[0]
            plan = S.lower_cell(cfg, shape, mesh)[0]
            pb = shard_bytes(S.abstract_params(spec),
                             param_shardings(spec, mesh))
            b = S.input_specs(cfg, shape)
            bb = shard_bytes(b, S.batch_shardings(cfg, shape, mesh, b))
            want = bb + (3 * pb + 4 if kind == "train" else pb)
            if kind == "decode":
                c = S.abstract_cache(cfg, batch, seq)
                want += shard_bytes(c, S.cache_shardings(cfg, mesh, batch,
                                                         seq))
            out[arch + "|" + mname + "|" + kind] = {
                "args": plan.arg_bytes, "want": want, "params": pb,
                "mm": plan.cost.matmul_flops * mesh.size,
                "one_mm": one[kind].cost.matmul_flops,
                "wire": funcol_stats(plan.cost.collectives)["wire_bytes"]}
print("PORT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def dense_plans():
    """The reference's compiled records and the port's plans, each in a
    subprocess of its own, the two at once."""
    head = f"ARCHS = {DENSE!r}\nCELLS = {CELLS!r}\n"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", head + _PORT], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        text = run_with_devices(head + _REF_COMPILED, devices=8)
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    return (json.loads(text[text.index("REF") + 3:]),
            json.loads(out[out.index("PORT") + 4:]))


@pytest.mark.parametrize("arch", DENSE)
def test_sharded_dense_plans(dense_plans, arch):
    ref, port = dense_plans
    for mname in ("local", "pod"):
        for kind, _, _ in CELLS:
            p = port[f"{arch}|{mname}|{kind}"]
            assert p["args"] == p["want"], (mname, kind)
            if mname != "local":
                continue
            r = ref[f"{arch}|{kind}"]
            if kind == "train":
                assert p["args"] == r["args"], kind
            elif kind == "prefill":   # f32 weights; the reference's bf16
                assert p["args"] - p["params"] // 2 == r["args"], kind
            else:    # and its cache's pos an int32 array, the port's an int
                assert p["args"] - p["params"] // 2 + 4 == r["args"], kind
            cfg = smoke_config(arch)
            passes = {"train": 4, "prefill": 1, "decode": 0}[kind]
            _, seq, batch = next(c for c in CELLS if c[0] == kind)
            kv = 2 * batch * seq * cfg.d_model * cfg.num_kv_heads \
                * cfg.head_dim
            assert p["mm"] - p["one_mm"] == \
                3 * passes * 2 * kv * cfg.num_layers, kind
            print(f"{arch} {kind} (2, 4): matmul x 8 {p['mm']:.4e} one-card "
                  f"{p['one_mm']:.4e}; wire by op, port {p['wire']} / "
                  f"reference HLO {r['wire']}")
    for kind, _, _ in CELLS:
        p = port[f"{arch}|pod|{kind}"]
        assert p["one_mm"] <= p["mm"] <= 16 * p["one_mm"], kind
        print(f"{arch} {kind} pod: matmul x 256 {p['mm']:.4e} one-card "
              f"{p['one_mm']:.4e}")
