"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs."""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    dbrx_132b,
    gemma3_27b,
    h2o_danube3_4b,
    internvl2_1b,
    mamba2_1_3b,
    phi35_moe_42b,
    qwen2_5_32b,
    tinyllama_1_1b,
    whisper_small,
    zamba2_7b,
)
from repro_torch.configs.base import (LM_SHAPES, ModelConfig, ShapeConfig,
                                      shapes_for)

_MODULES = (
    dbrx_132b,
    phi35_moe_42b,
    mamba2_1_3b,
    h2o_danube3_4b,
    gemma3_27b,
    qwen2_5_32b,
    tinyllama_1_1b,
    whisper_small,
    internvl2_1b,
    zamba2_7b,
)

ARCHS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

SHAPES: dict[str, ShapeConfig] = {s.name: s for s in LM_SHAPES}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells() -> list[tuple[ModelConfig, ShapeConfig]]:
    """Every applicable (architecture x shape) pair."""
    cells = []
    for cfg in ARCHS.values():
        for s in shapes_for(cfg):
            cells.append((cfg, s))
    return cells


def skipped_cells() -> list[tuple[str, str, str]]:
    """(arch, shape, reason) for assignment cells skipped per the rules."""
    out = []
    for cfg in ARCHS.values():
        valid = {s.name for s in shapes_for(cfg)}
        for s in LM_SHAPES:
            if s.name not in valid:
                reason = (
                    "pure full-attention arch: long_500k needs sub-quadratic attention"
                    if s.name == "long_500k"
                    else "arch has no decode step"
                )
                out.append((cfg.name, s.name, reason))
    return out


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests: same family/topology, tiny sizes.
# ---------------------------------------------------------------------------
_SMOKE_OVERRIDES: dict[str, dict] = {
    "dbrx-132b": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                      head_dim=16, d_ff=96, vocab_size=256, num_experts=4,
                      num_experts_per_tok=2),
    "phi3.5-moe-42b-a6.6b": dict(num_layers=2, d_model=64, num_heads=4,
                                 num_kv_heads=2, head_dim=16, d_ff=96,
                                 vocab_size=256, num_experts=4,
                                 num_experts_per_tok=2),
    "mamba2-1.3b": dict(num_layers=2, d_model=64, vocab_size=256, ssm_state=16,
                        ssm_head_dim=16, ssm_chunk=32),
    "h2o-danube-3-4b": dict(num_layers=2, d_model=64, num_heads=4,
                            num_kv_heads=2, head_dim=16, d_ff=128,
                            vocab_size=256, sliding_window=32),
    "gemma3-27b": dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
                       head_dim=16, d_ff=128, vocab_size=512,
                       sliding_window=16, global_every=2),
    "qwen2.5-32b": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                        head_dim=16, d_ff=128, vocab_size=256),
    "tinyllama-1.1b": dict(num_layers=2, d_model=64, num_heads=4,
                           num_kv_heads=2, head_dim=16, d_ff=128,
                           vocab_size=256),
    "whisper-small": dict(num_layers=2, encoder_layers=2, encoder_seq=24,
                          d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                          d_ff=128, vocab_size=256),
    "internvl2-1b": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                         head_dim=16, d_ff=128, vocab_size=256,
                         vision_tokens=8),
    "zamba2-7b": dict(num_layers=6, d_model=64, num_heads=4, num_kv_heads=4,
                      head_dim=16, d_ff=128, vocab_size=256, ssm_state=16,
                      ssm_head_dim=16, ssm_chunk=32, hybrid_attn_every=3),
}


def smoke_config(name: str) -> ModelConfig:
    cfg = get_arch(name)
    return dataclasses.replace(cfg, **_SMOKE_OVERRIDES[name])


SMOKE_SHAPE = ShapeConfig("smoke", "train", seq_len=64, global_batch=2)
