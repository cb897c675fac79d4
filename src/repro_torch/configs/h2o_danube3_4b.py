"""H2O-Danube3-4B: dense llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; unverified]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,              # 3840 / 32 (not a multiple of 128)
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,       # mistral-style SWA
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="swiglu",
    supports_long_context=True,   # SWA => O(window) decode cache -> run long_500k
    notes="llama+mistral mix, SWA",
    source="arXiv:2401.16818",
)
