"""Mamba2-2.7B [arXiv:2405.21060; unverified] — attention-free SSD."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    act="silu_glu",
    norm="rms",
    rope=False,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
    max_seq=1048576,
)
