"""Whisper-small: encoder-decoder, conv audio frontend (STUB per assignment).

The modality frontend is a stub: ``input_specs()`` provides precomputed
frame embeddings of shape (batch, encoder_seq, d_model).

[arXiv:2212.04356; unverified]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,             # decoder layers
    encoder_layers=12,
    encoder_seq=1500,          # 30s of audio at 50 frames/s (stub embeddings)
    cross_attention=True,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,           # MHA
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    rope_theta=10_000.0,       # positions: we use RoPE in place of learned-abs (noted in DESIGN.md)
    norm="layernorm",
    act="gelu",
    supports_long_context=False,   # full attention -> skip long_500k
    notes="enc-dec, conv frontend stubbed to precomputed frame embeddings",
    source="arXiv:2212.04356",
)
