"""Architecture configuration: the fields of
``repro.models.config.ModelConfig`` that change what a model computes —
dense, early-fusion and MoE decoders, sliding-window attention, the Mamba2
SSM and the zamba2 hybrid, and the whisper encoder-decoder — its
``smoke()`` reduction, and the input-shape cells (``ShapeConfig``,
``SHAPES``) of the JAX package."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | vlm (early fusion: the dense
                                   # path) | moe | ssm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None           # default d_model // n_heads
    act: str = "silu_glu"                     # silu_glu | gelu_glu | gelu | relu
    norm: str = "rms"                         # rms | ln
    qkv_bias: bool = False
    mlp_bias: bool = False                    # the DFQ plan pairs an MLP
                                              # up bias (mlp/bu) with wu
    rope: bool = True
    rope_theta: float = 10000.0
    qk_norm: bool = False                     # chameleon
    attn_causal_segments: int = 8             # the chunked training
                                              # attention's causal block
                                              # skipping (chunk_kv only)
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

    # SSM (mamba2 / zamba2 mamba blocks)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    ssm_n_groups: int = 1

    # hybrid (zamba2): a shared attention+MLP block applied every k SSM layers
    hybrid_attn_every: int = 0                # 0 → not hybrid
    hybrid_n_shared_blocks: int = 2

    # encoder-decoder (whisper)
    n_enc_layers: int = 0                     # 0 → decoder-only
    enc_seq: int = 1500                       # whisper 30 s → 1500 frames

    frontend: str = "none"                    # none | vision_stub (vlm:
                                              # image tokens share the
                                              # vocab) | audio_stub (whisper:
                                              # the caller gives the frames)
    dtype: str = "bfloat16"                   # activation compute dtype
    param_dtype: str = "float32"
    remat: bool = True                        # recompute each block in the
                                              # backward (memory, not numbers)
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
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic (or bounded-KV) decode at 500k+ tokens: an SSM
        backbone or a sliding window."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def _ssm_proj(self) -> int:
        """Width of a Mamba2 block's in_proj output: z, x, B, C, dt."""
        return (2 * self.d_inner + 2 * self.ssm_n_groups * self.ssm_state
                + self.ssm_heads)

    def param_count(self) -> int:
        """Approximate parameter count: embedding (and untied head) + blocks,
        as the JAX config counts them (an MoE block: its experts, router and
        shared experts; an SSM layer: in/out projections and the conv; the
        hybrid: its SSM layers and shared blocks; an encoder-decoder: both
        stacks and the decoder's cross attention)."""
        d, f = self.d_model, self.d_ff
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            din = self.d_inner
            per_layer = d * self._ssm_proj() + din * d + self.ssm_conv_width * (
                din + 2 * self.ssm_n_groups * self.ssm_state)
            return n + self.n_layers * per_layer
        attn = d * self.attn_dim + 2 * d * self.kv_dim + self.attn_dim * d
        if self.n_experts:
            mlp = self.n_experts * 3 * d * f + d * self.n_experts
            mlp += self.n_shared_experts * 3 * d * f
        else:
            mlp = (3 if self.act.endswith("_glu") else 2) * d * f
        if self.family == "hybrid":
            ssm = d * self._ssm_proj() + self.d_inner * d
            return (n + self.n_layers * ssm
                    + self.hybrid_n_shared_blocks * (attn + mlp))
        n += (self.n_layers + self.n_enc_layers) * (attn + mlp)
        if self.is_encdec:
            n += self.n_layers * attn
        return n

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
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16,
            ssm_chunk=8,
            n_enc_layers=2 if self.n_enc_layers else 0,
            enc_seq=16,
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            sliding_window=16 if self.sliding_window else None,
            max_seq=128,
            dtype="float32",
            param_dtype="float32",
            remat=False,
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
    """(applies, why not): long_500k needs sub-quadratic decode (an SSM
    backbone) or bounded-KV attention (a sliding window)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch — quadratic 500k decode "
                       "skipped (DESIGN.md §7)")
    return True, ""
