"""Chameleon-34B [arXiv:2405.09818; unverified] — early-fusion VQ image
tokens share the text vocab; QK-norm for stability (blocks q↔k CLE —
DESIGN.md §Arch-applicability)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    act="silu_glu",
    norm="rms",
    qk_norm=True,
    tie_embeddings=False,
    max_seq=4096,
    frontend="vision_stub",
)
