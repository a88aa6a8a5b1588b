"""Zamba2-2.7B [arXiv:2411.15242; hf] — Mamba2 backbone + shared attention
blocks (2 parameter-shared transformer blocks interleaved every 6 SSM layers)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    act="gelu_glu",
    norm="rms",
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    hybrid_attn_every=6,
    hybrid_n_shared_blocks=2,
    tie_embeddings=True,
    max_seq=4096,
)
