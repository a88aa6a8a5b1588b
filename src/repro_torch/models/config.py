"""Architecture configuration: the decoder fields of
``repro.models.config.ModelConfig`` (dense, early-fusion and MoE decoders,
sliding-window attention), its ``smoke()`` reduction, and the input-shape
cells (``ShapeConfig``, ``SHAPES``) of the JAX package."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | vlm (early fusion: the dense
                                   # path) | moe
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None           # default d_model // n_heads
    act: str = "silu_glu"                     # silu_glu | gelu_glu | gelu | relu
    norm: str = "rms"                         # rms
    qkv_bias: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    qk_norm: bool = False                     # chameleon
    kv_cache_bits: int = 16                   # 8 → int8 KV cache (per-token,
                                              # per-head absmax scales)
    tie_embeddings: bool = True
    sliding_window: Optional[int] = None      # mixtral SWA
    max_seq: int = 131072

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0                 # llama4 shared expert
    capacity_factor: float = 1.25

    frontend: str = "none"                    # none | vision_stub (vlm:
                                              # image tokens share the vocab)
    dtype: str = "bfloat16"                   # activation compute dtype
    param_dtype: str = "float32"
    logit_chunk: int = 1024                   # the loss's sequence chunking
    kv_bias_correct: bool = False             # int8 KV only: store per-token
                                              # V error means (v_err) and
                                              # subtract Σ p·v_err (§4.2)

    def __post_init__(self):
        if self.head_dim is None and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def supports_long_context(self) -> bool:
        """Bounded-KV decode at 500k+ tokens: a sliding window."""
        return self.sliding_window is not None

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def param_count(self) -> int:
        """Parameter count: embedding (and untied head) + blocks, as the JAX
        config counts them (an MoE block: its experts, router and shared
        experts)."""
        d, f = self.d_model, self.d_ff
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * self.attn_dim + 2 * d * self.kv_dim + self.attn_dim * d
        if self.n_experts:
            mlp = self.n_experts * 3 * d * f + d * self.n_experts
            mlp += self.n_shared_experts * 3 * d * f
        else:
            mlp = (3 if self.act.endswith("_glu") else 2) * d * f
        return n + self.n_layers * (attn + mlp)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE top-k counting)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_moe = self.n_experts * 3 * d * f
        active_moe = (self.top_k + self.n_shared_experts) * 3 * d * f
        return self.param_count() - self.n_layers * (
            dense_moe - active_moe - d * self.n_experts)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU tests (as the JAX package's)."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            capacity_factor=4.0,   # drop-free in smoke: cache-parity testable
            sliding_window=16 if self.sliding_window else None,
            max_seq=128,
            dtype="float32",
            param_dtype="float32",
            logit_chunk=32,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple:
    """(applies, why not): long_500k needs bounded-KV attention (a sliding
    window)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch — quadratic 500k decode "
                       "skipped (DESIGN.md §7)")
    return True, ""
