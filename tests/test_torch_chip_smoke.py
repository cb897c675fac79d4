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
        ("mamba2-1.3b,whisper-small", "decode_32k", 2),
        ("tinyllama-1.1b", "train_4k", 1)), out_dir=tmp_path / "lm",
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
        "mamba2-1.3b__decode_32k", "tinyllama-1.1b__train_4k",
        "whisper-small__decode_32k"]
