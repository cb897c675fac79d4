"""Mamba2-1.3B: attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_conv=4,
    ssm_groups=1,
    tie_embeddings=True,
    norm="rmsnorm",
    supports_long_context=True,    # O(1)-state decode -> run long_500k
    notes="SSD (state-space duality); attention-free",
    source="arXiv:2405.21060",
)
