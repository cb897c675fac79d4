"""The sharded dry-run of the MoE, SSM, hybrid, audio and vlm families:
``lower_cell`` at ``make_local_mesh(2, 4)`` and at the pod mesh (16 x
16) for the six non-dense archs' smoke configs (phi3.5-moe, dbrx,
mamba2, zamba2, whisper, internvl2), across train, prefill and decode
cells, against the shards' bytes, the one-card plans and the JAX
package's compiled plans at (2, 4).  As ``tests/test_torch_shardings.
py`` holds the dense family's:

  * per-device argument bytes equal the shards' bytes of the plans
    (parameters, AdamW's m and v and its step, the batch with its
    frontend stubs, the cache);
  * train cells' argument bytes equal the reference's compiled
    ``memory_analysis().argument_size_in_bytes`` at the same 8-device
    mesh; serving cells hold the pinned relation (the port plans f32
    weights where the reference's serving checkpoints are bf16, so the
    port's parameter shards are twice the reference's; the reference's
    cache ``pos`` is an int32 array where the port's is an int; and
    ``jax.jit`` drops the arguments a step never reads, which whisper's
    decode step has: the encoder's weights, the cross-attention's k and
    v projections (the cache holds their products) and the frame
    embeddings, all of which the port's plan counts as it holds them);
  * per-device matmul FLOPs times 8 against the one-card plan's.  The
    one excess at (2, 4) is the dense family's: where the kv heads do
    not divide the model axis of 4 (phi3.5-moe's and dbrx's 2,
    internvl2's 2; whisper's and zamba2's 4 divide, mamba2 has no
    attention), ``resolve_axes`` replicates ``wk`` and ``wv`` and every
    model rank projects the same k and v: m - 1 = 3 copies too many of
    2·B·S·d·KH·hd FLOPs each (S counting internvl2's vision tokens),
    four times a layer in a train step (forward, remat recompute, the
    backward's two products), once in a prefill, none in a decode step.
    Nothing else repeats: the MoE routes each group on one rank (ranks
    holding the same tokens share the groups out) and runs each expert
    where its weights rest; the SSM runs each batch row on one rank.
    At the pod mesh (model axis 16) a rank holds one row, and the smoke
    configs' 4 heads, 2 or 4 kv heads and 4 experts do not divide the
    axis, so each matmul either splits 16 ways or runs whole on every
    model rank: the excess over the one-card plan is 15 times the
    one-card FLOPs of the whole-run matmuls.  ``POD_SPLIT`` pins the
    FLOPs that do split (the prefill's last-position lm head of
    phi3.5-moe and dbrx, 2·B·d·V = 2·16·64·256, is the whole of
    theirs), so a plan in which every model rank repeats all the work
    fails;
  * no all-gather in a MoE plan moves an expert weight (every
    all-gather's input shape is recorded: none is a layer's shard of
    ``wi``, ``wg`` or ``wo``);
  * the collectives' wire bytes by op, printed beside the reference's
    HLO figures at (2, 4) (the relation is the dense family's: GSPMD
    moves what DTensor moves and more, ROADMAP.md section 3).

The reference side compiles in one subprocess on 8 host devices, the
port plans in another (planning starts a fake process group of the
mesh's size), the two at once.
"""

import json
import os
import subprocess
import sys

import pytest

from conftest import SRC, run_with_devices
from repro_torch.configs.registry import smoke_config

ARCHS = ("phi3.5-moe-42b-a6.6b", "dbrx-132b", "mamba2-1.3b", "zamba2-7b",
         "whisper-small", "internvl2-1b")
# small cells of each kind, as the dense test's
CELLS = (("train", 64, 16), ("prefill", 64, 16), ("decode", 64, 16))
# the one-card matmul FLOPs of each cell that split over the pod's model
# axis of 16 (see the module docstring)
POD_SPLIT = {
    "phi3.5-moe-42b-a6.6b": {"train": 134217728, "prefill": 524288,
                             "decode": 262144},
    "dbrx-132b": {"train": 134217728, "prefill": 524288, "decode": 262144},
    "mamba2-1.3b": {"train": 234881024, "prefill": 34078720,
                    "decode": 1048576},
    "zamba2-7b": {"train": 738197504, "prefill": 201850880,
                  "decode": 4718592},
    "whisper-small": {"train": 457179136, "prefill": 92798976,
                      "decode": 1310720},
    "internvl2-1b": {"train": 549453824, "prefill": 113770496,
                     "decode": 2883584}}

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
from repro_torch.models import moe, param_spec
from repro_torch.models.params import param_shardings
from repro_torch.roofline.analysis import funcol_stats
from repro_torch.tree import leaves

def shard_bytes(tree, shs):
    return sum(t.element_size() * math.prod(s.shard_shape(t.shape))
               for t, s in zip(leaves(tree), leaves(shs))
               if isinstance(t, torch.Tensor))

def unread(cfg, spec, shs, b, bsh):
    # whisper's decode: the encoder's weights and the cross-attention's
    # k and v projections in bf16, and the frame embeddings
    if cfg.family != "audio":
        return 0
    w = shard_bytes(S.abstract_params(spec["encoder"]), shs["encoder"])
    for seg, sh in zip(spec["segments"], shs["segments"]):
        for k in ("wk", "wv"):
            w += shard_bytes(S.abstract_params(seg["xattn"][k]),
                             sh["xattn"][k])
    return w // 2 + shard_bytes({"e": b["enc_embeds"]},
                                {"e": bsh["enc_embeds"]})

def expert_shards(spec, shs):
    # one layer's shard of each MoE expert weight
    out = []
    for seg, sh in zip(spec["segments"], shs["segments"]):
        for k in moe.EXPERT_LEAVES:
            if k in seg.get("moe", {}):
                out.append(list(sh["moe"][k].shard_shape(
                    seg["moe"][k].shape)[1:]))
    return out

out = {}
for arch in ARCHS:
    cfg = smoke_config(arch)
    spec = param_spec(cfg)
    one = {}
    for mname, mesh in (("local", make_local_mesh(2, 4)),
                        ("pod", make_production_mesh())):
        shs = param_shardings(spec, mesh)
        for kind, seq, batch in CELLS:
            shape = ShapeConfig("c", kind, seq, batch)
            if kind not in one:
                one[kind] = S.lower_cell(cfg, shape, make_local_mesh())[0]
            plan = S.lower_cell(cfg, shape, mesh)[0]
            pb = shard_bytes(S.abstract_params(spec), shs)
            b = S.input_specs(cfg, shape)
            bsh = S.batch_shardings(cfg, shape, mesh, b)
            bb = shard_bytes(b, bsh)
            want = bb + (3 * pb + 4 if kind == "train" else pb)
            if kind == "decode":
                c = S.abstract_cache(cfg, batch, seq)
                want += shard_bytes(c, S.cache_shardings(cfg, mesh, batch,
                                                         seq))
            out[arch + "|" + mname + "|" + kind] = {
                "args": plan.arg_bytes, "want": want, "params": pb,
                "unread": unread(cfg, spec, shs, b, bsh)
                if kind == "decode" else 0,
                "mm": plan.cost.matmul_flops * mesh.size,
                "one_mm": one[kind].cost.matmul_flops,
                "wire": funcol_stats(plan.cost.collectives)["wire_bytes"],
                "gathered": [list(s) for s, _ in plan.cost.gathered],
                "experts": expert_shards(spec, shs)}
print("PORT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def plans():
    """The reference's compiled records and the port's plans, each in a
    subprocess of its own, the two at once."""
    head = f"ARCHS = {ARCHS!r}\nCELLS = {CELLS!r}\n"
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


def _kv_excess(cfg, kind: str, seq: int, batch: int, m: int = 4) -> int:
    """The replicated k and v projections' FLOPs over the one-card
    plan's, at a model axis of ``m`` (see the module docstring)."""
    if cfg.num_kv_heads == 0 or cfg.num_kv_heads % m == 0:
        return 0
    passes = {"train": 4, "prefill": 1, "decode": 0}[kind]
    if cfg.family == "vlm" and kind != "decode":
        seq += cfg.vision_tokens
    kv = 2 * batch * seq * cfg.d_model * cfg.num_kv_heads * cfg.head_dim
    return (m - 1) * passes * 2 * kv * cfg.num_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_family_plans(plans, arch):
    ref, port = plans
    cfg = smoke_config(arch)
    for mname in ("local", "pod"):
        for kind, seq, batch in CELLS:
            p = port[f"{arch}|{mname}|{kind}"]
            assert p["args"] == p["want"], (mname, kind)
            # no all-gather moves an expert weight
            assert cfg.family != "moe" or p["experts"]
            moved = [g for g in p["gathered"] if g in p["experts"]]
            assert not moved, (mname, kind, moved)
            if mname != "local":
                continue
            r = ref[f"{arch}|{kind}"]
            if kind == "train":
                assert p["args"] == r["args"], kind
            elif kind == "prefill":   # f32 weights; the reference's bf16
                assert p["args"] - p["params"] // 2 == r["args"], kind
            else:    # and its cache's pos an int32 array, the port's an
                # int; and its jit drops what the step never reads
                assert p["args"] - p["params"] // 2 + 4 - p["unread"] == \
                    r["args"], kind
            assert p["mm"] - p["one_mm"] == _kv_excess(cfg, kind, seq,
                                                       batch), kind
            print(f"{arch} {kind} (2, 4): matmul x 8 {p['mm']:.4e} one-card "
                  f"{p['one_mm']:.4e}; wire by op, port {p['wire']} / "
                  f"reference HLO {r['wire']}")
    for kind, _, _ in CELLS:
        p = port[f"{arch}|pod|{kind}"]
        split = POD_SPLIT[arch][kind]
        assert 0 < split < p["one_mm"], kind
        assert p["mm"] - p["one_mm"] == 15 * (p["one_mm"] - split), kind
        print(f"{arch} {kind} pod: matmul x 256 {p['mm']:.4e} one-card "
              f"{p['one_mm']:.4e}")
