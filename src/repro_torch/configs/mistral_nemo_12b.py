"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407] — dense GQA kv=8,
128k context, head_dim 128 (d_model 5120 / 32 heads ⇒ 160, but Nemo pins 128)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    act="silu_glu",
    norm="rms",
    rope_theta=1e6,
    tie_embeddings=False,
    max_seq=131072,
)
