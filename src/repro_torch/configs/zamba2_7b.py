"""Zamba2-7B: hybrid Mamba2 backbone + shared attention blocks.

Adaptation note (DESIGN.md §Arch-applicability): Zamba2 interleaves two
shared transformer blocks with per-invocation LoRA deltas; we model a
single shared attention+MLP block applied every ``hybrid_attn_every``
SSM layers, which preserves the parameter-sharing structure and the
compute/communication shape.

[arXiv:2411.15242; unverified]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,             # mamba2 blocks
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,           # shared block is MHA
    head_dim=112,              # 3584 / 32
    d_ff=14336,                # shared block MLP
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_conv=4,
    ssm_groups=1,
    hybrid_attn_every=6,       # shared attn block before every 6th mamba layer
    tie_embeddings=True,
    norm="rmsnorm",
    act="swiglu",
    supports_long_context=True,   # SSM-dominated -> run long_500k
    notes="Mamba2 + shared attn blocks",
    source="arXiv:2411.15242",
)
