"""InternVL2-1B: InternViT frontend (STUB) + InternLM2 LM backbone.

The vision frontend is a stub: ``input_specs()`` provides precomputed
patch embeddings of shape (batch, vision_tokens, d_model) which the model
prepends to the token embeddings.

[arXiv:2404.16821; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    vision_tokens=256,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    norm="rmsnorm",
    act="swiglu",
    supports_long_context=False,   # full attention -> skip long_500k
    notes="InternViT stub + InternLM2 backbone",
    source="arXiv:2404.16821",
)
