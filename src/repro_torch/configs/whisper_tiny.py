"""Whisper-tiny [arXiv:2212.04356; unverified] — enc-dec, conv audio
frontend STUBBED (input_specs supplies precomputed frame embeddings)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,           # decoder layers
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    act="gelu",
    norm="ln",
    qkv_bias=True,
    rope=False,
    tie_embeddings=True,
    enc_seq=1500,
    max_seq=532480,       # decoder learned-pos table sized for assigned shapes
    frontend="audio_stub",
)
