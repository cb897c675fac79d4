"""``chip_smoke.py``'s LM training and dry-run phases rehearsed on the
CPU at the smoke configs: the card's checks and counts run on the plain
versions, so a change that breaks a phase shows here before a chip run.

The rehearsal stands in for the card in three places: the registry's
archs are their smoke configs, ``FlashAttention``'s forward goes through
the kernel wrapper (on a CPU tensor the wrapper runs its plain version,
``ref.py``) and a counter around the wrapper bumps its launch counts, as
a launch on the card would.  Memory readings are "not measured" off the
card.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO

from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.models import layers as L

FAMILIES = (("phi3.5-moe-42b-a6.6b", 2, 64, 1), ("mamba2-1.3b", 2, 64, None),
            ("zamba2-7b", 2, 64, None), ("whisper-small", 2, 32, None),
            ("internvl2-1b", 2, 24, None))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cs(monkeypatch):
    """chip_smoke as a module, with the card's routes stood in for."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name in list(registry.ARCHS):
        monkeypatch.setitem(registry.ARCHS, name,
                            registry.smoke_config(name))
    wrapped = ops.flash_attention_fwd

    def counting(q, k, v, **kw):
        kernel.flash_attention_fwd.launches += 1
        if q.dtype == torch.bfloat16:
            kernel.flash_attention_fwd.launches_tc += 1
        return wrapped(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention_fwd", counting)
    plain = L.FlashAttention.forward

    def forward(ctx, q, k, v, causal, window, softcap, q_chunk, kv_chunk,
                plain_route):
        if plain_route:
            return plain(ctx, q, k, v, causal, window, softcap, q_chunk,
                         kv_chunk, plain_route)
        out, lse = L.flash_attention_kernel(q, k, v, causal=causal,
                                            window=window, softcap=softcap,
                                            return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        q_chunk=q_chunk, kv_chunk=kv_chunk)
        return out

    monkeypatch.setattr(L.FlashAttention, "forward", staticmethod(forward))
    return mod


def test_train_families_and_dryrun_lm_phases_rehearse(cs, tmp_path):
    port = cs.Port()
    tf = cs.run_train_families(port, "cpu", families=FAMILIES, steps=2)
    cells = tf.pop("dryrun_cells")
    per_step = {"phi3.5-moe-42b-a6.6b": 2, "mamba2-1.3b": 0, "zamba2-7b": 2,
                "whisper-small": 12, "internvl2-1b": 4}
    for arch, c in tf["cells"].items():
        assert c["flash_launches_a_step"] == per_step[arch], arch
        assert c["flash_launches"] == 2 * per_step[arch], arch
        assert c["resident_bytes"] is None and c["peak_requested"] is None
    assert tf["launches"] == 2 * sum(per_step.values())
    assert tf["cells"]["mamba2-1.3b"]["grad_gaps_plain"] is None
    assert {s["arch"] for s in tf["lse_shapes"]} == set(per_step) - {
        "mamba2-1.3b"}
    assert sorted(cells) == sorted(f"train-families {a}" for a in per_step)
    cli = cs.DryrunCLI(passes=(
        ("mamba2-1.3b,whisper-small", "decode_32k", "single", 2),
        ("tinyllama-1.1b", "train_4k", "single", 1),
        ("tinyllama-1.1b", "train_4k", "pod", 1)), out_dir=tmp_path / "lm",
        smoke=True)
    try:
        dr = cs.run_dryrun_lm(port, cells, "cpu", cli)
    finally:
        cli.stop()
    assert sorted(dr["cells"]) == sorted(cells)
    for c in dr["cells"].values():
        assert c["planned_arg_bytes"] > 0 and c["resident_bytes"] is None
        assert c["planned_peak"] > c["planned_arg_bytes"]
    assert sorted(dr["cli_records"]) == [
        "mamba2-1.3b__decode_32k__single", "tinyllama-1.1b__train_4k__pod",
        "tinyllama-1.1b__train_4k__single",
        "whisper-small__decode_32k__single"]
    pod = dr["cli_records"]["tinyllama-1.1b__train_4k__pod"]
    assert pod["arg_bytes_per_device"] == cs.sharded_arg_bytes(
        port, registry.smoke_config("tinyllama-1.1b"), "train_4k", "pod")
    assert pod["collective_wire_bytes"] > 0


# ---------------------------------------------------------------------------
# the [dist] phase: its host helpers, and the phase rehearsed on the CPU
# ---------------------------------------------------------------------------

def _urand_engines(cs, port, n=1024, parts_list=(1, 4)):
    edges = port.urand_edges(n, 16 * n, cs.SEED)
    out = {}
    for parts in parts_list:
        g = port.partition_graph(edges, n, parts)
        eng = port.GraphEngine(g, device="cpu")
        out[parts] = (g, eng, eng.device_graph())
    return out


def test_dist_part_hand_off_round_trips(cs, tmp_path):
    """A part written for a rank loads as the same one-part shards: every
    array, the shared ELL metas and the part index."""
    port = cs.Port()
    g = _urand_engines(cs, port, parts_list=(4,))[4][0]
    for p in range(4):
        path = tmp_path / f"part{p}.pkl"
        assert cs.hand_off(g.take_part(p), path) == path.stat().st_size
        h = cs.load_part(path)
        assert h.part_index == p and h.parts == 4 and h.n == g.n
        assert h.ell_meta == g.ell_meta
        for k in ("out_src_local", "out_dst_global", "in_src_global",
                  "in_dst_local", "out_degree", "in_degree"):
            assert np.array_equal(getattr(h, k), getattr(g, k)[p:p + 1])
        assert h.ell_arrays.keys() == g.ell_arrays.keys()
        for k, v in h.ell_arrays.items():
            assert np.array_equal(v, g.ell_arrays[k][p:p + 1]), k


def test_dist_wait_ranks_checks_every_exit_code(cs):
    """A rank that exits non-zero fails the phase, and so does one still
    running at the timeout, which is killed with every other one."""
    def start(code):
        return subprocess.Popen([sys.executable, "-c", code])

    cs.wait_ranks([start("pass"), start("pass")], 60)
    with pytest.raises(AssertionError, match=r"\(1, 3\)"):
        cs.wait_ranks([start("pass"), start("raise SystemExit(3)")], 60)
    procs = [start("pass"), start("import time; time.sleep(60)")]
    with pytest.raises(AssertionError, match="rank 1 still running"):
        cs.wait_ranks(procs, 2)
    assert all(p.poll() is not None for p in procs)


def test_dist_phase_rehearses(cs, tmp_path, monkeypatch, capsys):
    """``run_dist`` on the CPU at urand 1024 (triangles on 512 vertices):
    one gloo rank at parts 1 running every program and four at parts 4
    (rank processes of chip_smoke.py itself) running DIST_PROGRAMS, each
    with the guarded runs, equal to StackedComm, nothing staged, no
    kernel launched; then, in the same ranks, DIST_RECOVERY's
    checkpointed runs under the chaos schedule, a rank server's answers
    and a durable rank server on urand12's parts (its WAL, mirrors and
    recovery) equal to the stacked ones; compression at one layer's
    shapes."""
    monkeypatch.setattr(cs, "DIST_DIR", tmp_path / "dist")
    monkeypatch.setattr(cs, "TRI_N", 512)
    monkeypatch.setattr(cs, "DIST_DURABLE_GRAPH", "urand12")
    port = cs.Port()
    out = cs.run_dist(port, _urand_engines(cs, port), "cpu")
    assert out["launches"] == {"spmv_ell": 0, "bfs_pull": 0}
    assert out["by_rank"] == [{"spmv_ell": 0, "bfs_pull": 0}] * 4
    text = capsys.readouterr().out
    assert text.count("[dist] gloo world=1 parts=1 ") == 18
    assert text.count("[dist] gloo world=4 parts=4 ") == \
        len(cs.DIST_PROGRAMS) + 2
    assert "bfs/fast chaos" in text and "ok=0" in text
    assert text.count("[dist-recovery] gloo world=4 ") == \
        len(cs.DIST_RECOVERY)
    assert "resumed from its round-" in text
    assert text.count("[dist-serve] gloo world=4 ") == \
        2 * len(cs.DIST_SERVED) + 1
    assert text.count("[dist-durable] gloo world=4 urand12: ") == 1
    assert "equal to the stacked server's" in text
    assert "part_sums equals the one-row sums (cpu)" in text
    assert "ops staged through pinned host memory (gloo on CUDA " \
        "tensors): none" in text
    assert "bit-equal to the CPU's" in text
    assert "[dist done]" in text and not (tmp_path / "dist").exists()


def test_sharded_phase_rehearses(cs, tmp_path, monkeypatch, capsys):
    """``run_sharded`` on the CPU with TinyLlama at the smoke config (2
    layers, batch 4 x 32, 2 steps): four gloo rank processes of
    chip_smoke.py on a (2, 2) mesh through ``train(mesh=)`` equal to
    the one-process run, each rank's flash forwards at its (B/2 * H/2,
    S, D) slice, its shards' bytes equal to lower_cell's plan, the
    parameters saved from (2, 2) equal to the shards and restored onto
    (4, 1) equal, grad norms and updates held, prefill and decode on
    the mesh against one process; nothing staged off the card."""
    monkeypatch.setattr(cs, "SHARDED_DIR", tmp_path / "sharded")
    out = cs.run_sharded(cs.Port(), "cpu",
                         runs=(("tinyllama-1.1b", 2, 32, 2),), batch=4)
    assert out == {"launches": 0, "by_rank": [0, 0, 0, 0],
                   "serve_launches": 0, "serve_by_rank": [0, 0, 0, 0],
                   "families_launches": 0, "families_by_rank": [0, 0, 0, 0]}
    text = capsys.readouterr().out
    assert "flash 8 a rank, launches by rank [0, 0, 0, 0] at " \
        "[[4, 32, 16]]" in text
    assert "staged through pinned host memory (by backend and device), " \
        "rank 0's train steps: none (cpu)" in text
    assert "restored onto (4, 1) equal" in text
    assert "grad norms" in text and "of the one-process update" in text
    assert "[sharded] tinyllama-1.1b prefill of 4 x 32 and 2 decode steps " \
        "on the mesh" in text
    assert "flash launches by rank [0, 0, 0, 0]" in text
    assert "peak by rank not measured" in text
    assert "[sharded done]" in text and not (tmp_path / "sharded").exists()


def test_sharded_families_phase_rehearses(cs, tmp_path, monkeypatch,
                                          capsys):
    """``run_sharded`` on the CPU with the other families at the smoke
    configs (batch 4, 2 steps): four gloo rank processes of
    chip_smoke.py on a (2, 2) mesh train each family through
    ``train(mesh=)`` equal to the one-process run (the MoE at sequence
    512, each rank routing the half rows it holds, with the one-process
    routing replayed on its own groups), each rank's shards equal to
    lower_cell's plan, then prefill and two decode steps on the mesh
    against one process; the MoE's own prefill routing put back in the
    one-process order; nothing staged off the card."""
    monkeypatch.setattr(cs, "SHARDED_DIR", tmp_path / "sf")
    runs = (("phi3.5-moe-42b-a6.6b", 1, 512, 2), ("mamba2-1.3b", 2, 64, 2),
            ("zamba2-7b", 3, 64, 2), ("whisper-small", 1, 32, 2),
            ("internvl2-1b", 2, 24, 2))
    out = cs.run_sharded(cs.Port(), "cpu", runs=runs)
    assert out == {"launches": 0, "by_rank": [0, 0, 0, 0],
                   "serve_launches": 0, "serve_by_rank": [0, 0, 0, 0],
                   "families_launches": 0, "families_by_rank": [0, 0, 0, 0]}
    text = capsys.readouterr().out
    for arch, _, seq, _ in runs:
        assert f"[sharded-families] {arch}" in text
        assert f"prefill of 4 x {seq} and 2 decode steps on the mesh" in text
    assert "routing replayed, its own prefill routing flips" in text
    assert "staged a rank none;" in text
    assert "[sharded done]" in text
    assert not (tmp_path / "sf").exists()


def test_moe_groups_cover_the_one_process_groups(cs):
    """The groups the four ranks route, put together, are each
    one-process group once, for every kind of step."""
    for kind, seq in (("train", 1024), ("train", 512), ("train", 64),
                      ("prefill", 1024), ("prefill", 24), ("decode", 1)):
        got = sorted(g for r in range(4)
                     for g in cs.moe_groups(kind, r, 4, seq))
        gs = min(256, 1 if kind == "decode" else seq)
        assert got == list(range(4 * (1 if kind == "decode" else
                                      seq // gs))), (kind, seq)
