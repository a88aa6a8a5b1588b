"""Mixtral-8x22B [arXiv:2401.04088] — 8 experts top-2, sliding-window attn
(window 4096 per the assignment note ⇒ bounded KV, long_500k applicable)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    act="silu_glu",
    norm="rms",
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    rope_theta=1e6,
    tie_embeddings=False,
    max_seq=65536,
)
