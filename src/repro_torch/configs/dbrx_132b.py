"""DBRX-132B: fine-grained MoE, 16 experts top-4, GQA kv=8.

[hf:databricks/dbrx-base; unverified]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,                # per-expert FFN width
    vocab_size=100352,
    num_experts=16,
    num_experts_per_tok=4,
    rope_theta=500_000.0,
    norm="layernorm",
    act="swiglu",
    supports_long_context=False,   # pure full attention -> skip long_500k
    notes="16 experts top-4, fine-grained MoE; every layer is MoE",
    source="hf:databricks/dbrx-base",
)
