"""Yi-34B [arXiv:2403.04652; hf] — llama-arch dense, GQA kv=8."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    act="silu_glu",
    norm="rms",
    rope_theta=5e6,
    tie_embeddings=False,
    max_seq=200000,
)
