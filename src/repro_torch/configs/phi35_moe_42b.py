"""Phi-3.5-MoE 42B (6.6B active): 16 experts top-2, GQA kv=8.

[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,                 # per-expert FFN width
    vocab_size=32064,
    num_experts=16,
    num_experts_per_tok=2,
    rope_theta=10_000.0,
    norm="layernorm",
    act="swiglu",
    supports_long_context=False,   # full attention -> skip long_500k
    notes="16 experts top-2",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
