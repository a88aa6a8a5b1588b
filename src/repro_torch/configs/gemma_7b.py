"""Gemma-7B [arXiv:2403.08295; hf] — GeGLU, head_dim 256, MQA only on 2B."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    act="gelu_glu",
    norm="rms",
    tie_embeddings=True,
    max_seq=8192,
)
