"""Qwen2-0.5B [arXiv:2407.10671; hf] — dense, GQA kv=2, QKV bias."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    act="silu_glu",
    norm="rms",
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    max_seq=131072,
)
