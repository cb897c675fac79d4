"""Gemma3-27B: dense, 5:1 local:global attention, 128k context, 262k vocab.

[hf:google/gemma-3-1b-pt; unverified]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    sliding_window=1024,       # local layers
    global_every=6,            # every 6th layer is global (5:1 local:global)
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="swiglu",               # gemma uses gelu-glu; swiglu is the same cost/shape
    max_seq_len=131_072,
    supports_long_context=True,   # 5:1 local:global -> decode cache mostly O(window)
    notes="5:1 local:global, 128k context",
    source="hf:google/gemma-3-1b-pt",
)
