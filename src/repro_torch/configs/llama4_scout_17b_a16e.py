"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified] —
MoE 16 experts top-1 + shared expert, early fusion (vision frontend stubbed)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    act="silu_glu",
    norm="rms",
    n_experts=16,
    top_k=1,
    n_shared_experts=1,
    rope_theta=5e5,
    tie_embeddings=False,
    max_seq=262144,
    frontend="vision_stub",
)
