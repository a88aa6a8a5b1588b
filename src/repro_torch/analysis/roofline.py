"""Roofline analysis of a dry-run cell on the NVIDIA H100 — port of
``repro.analysis.roofline``.

Three terms per (arch × shape × mesh), the reference's formulas over the
card's constants:

    compute    = FLOPs / (chips × peak_FLOP/s)
    memory     = bytes / (chips × HBM_bw)
    collective = collective_bytes / (chips × link_bw)

The dry-run (``launch.dryrun``) counts per-device FLOPs, bytes and
collective bytes of the real step; they are made global (× chips) before
the formulas, as the reference does. The reference parses collective bytes
out of XLA's optimized HLO (``collective_bytes_from_hlo``); the port has no
HLO, and its collectives report themselves to
``sharding.collectives.record_collectives`` instead.

``HW_H100`` holds one NVIDIA H100 SXM5 80GB's data-sheet peaks (NVIDIA H100
Tensor Core GPU data sheet, SXM5 column, dense rates without sparsity, at
the 700 W power limit). No figure of another chip is carried over.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

HW_H100 = {
    "peak_flops_bf16": 989e12,       # dense bf16 tensor-core FLOP/s
    "peak_flops_int8": 1979e12,      # dense int8 tensor-core OP/s
    "peak_flops_f32": 67e12,         # float32 FLOP/s outside the tensor cores
    "hbm_bw": 3.35e12,               # HBM3 bytes/s
    "hbm_per_chip": 80e9,            # bytes of HBM3
    # the collective term's link: a 16-wide model axis spans two 8-GPU
    # nodes, so its slowest hop is a GPU's 400 Gb/s network port
    "link_bw": 50e9,                 # bytes/s per GPU (400 Gb/s)
    # within one node: NVLink 4, 900 GB/s a GPU both ways
    "nvlink_bw": 450e9,              # bytes/s per GPU, one direction
}


def analytic_hbm_bytes(cfg, shape, *, chips: int, model_n: int = 16,
                       quantized: bool = False) -> float:
    """Per-device HBM traffic estimate for one step (the fused view): only
    HBM-resident tensors are counted — the reference's formula, term for
    term:

      train:   weight shards ×3 passes (fwd + 2 bwd) + fp32 grads + AdamW
               state r/w + per-layer activation checkpoints + sharded logits,
      prefill: weight shard ×1 + activation stream + KV-cache write,
      decode:  weight shard ×1 (int8 weights halve it) + KV/SSM cache
               read + tiny activations.
    """
    dp_n = chips // model_n
    N = cfg.param_count()
    Na = cfg.active_param_count()
    B_loc = max(1, shape.global_batch // dp_n)
    T = shape.seq_len
    D = cfg.d_model
    L = cfg.n_layers + cfg.n_enc_layers
    V_loc = cfg.vocab_size / model_n
    kv_dim = 2 * cfg.kv_dim if cfg.n_kv_heads else 0
    ssm_state_bytes = 0
    if cfg.ssm_state:
        ssm_state_bytes = (cfg.n_layers * cfg.ssm_heads * cfg.ssm_head_dim
                           * cfg.ssm_state * 4)

    w_bytes = 1 if quantized else 2           # int8 halves weight HBM
    w_shard = N / model_n * w_bytes
    w_active_shard = Na / model_n * w_bytes
    opt = N / chips * 4 * 6                   # fp32 p/m/v read+write
    grads = N / chips * 4 * 2                 # fp32 grad reduce-scatter r/w

    if shape.kind == "train":
        acts = L * B_loc * T * D * 2 * 2 * 2  # ckpt write+read, fwd+bwd
        logits = B_loc * T * V_loc * 4 * 2 * 2
        return 3 * w_shard + opt + grads + acts + logits
    if shape.kind == "prefill":
        acts = L * B_loc * T * D * 2 * 2
        cache_w = (cfg.n_layers * B_loc * min(T, cfg.sliding_window or T)
                   * kv_dim * 2)
        return w_active_shard + acts + cache_w
    # decode: one token
    S = min(T, cfg.sliding_window or T)
    cache_layers = cfg.n_layers
    if cfg.family == "hybrid":
        cache_layers = cfg.n_layers // max(cfg.hybrid_attn_every, 1)
    kv_bytes = cfg.kv_cache_bits / 8 if hasattr(cfg, "kv_cache_bits") else 2
    cache_r = cache_layers * B_loc * S * kv_dim * kv_bytes
    state_rw = B_loc * ssm_state_bytes * 2
    return (w_active_shard + cache_r + state_rw
            + B_loc * (L * D * 2 * 4 + V_loc * 4))


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D for training (dense; N_active for MoE), 2·N·D for
    inference-forward — the "useful work" yardstick."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "train" else
                                   shape.seq_len if shape.kind == "prefill"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float                 # from the counted bytes (an upper bound)
    collective_s: float
    flops_global: float
    bytes_global: float
    collective_bytes_global: float
    model_flops: float
    chips: int
    memory_analytic_s: float = 0.0  # the analytic HBM floor

    @property
    def dominant(self) -> str:
        """The bottleneck, by the ANALYTIC memory term; the counted bytes
        are reported beside it as the pessimistic bound."""
        terms = {"compute": self.compute_s, "memory": self.memory_analytic_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_analytic_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / max(self.flops_global, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the roofline the USEFUL work achieves if the program
        runs at its bound: (model_flops / peak) / bound_time."""
        ideal = self.model_flops / (self.chips * HW_H100["peak_flops_bf16"])
        return ideal / max(self.bound_time_s, 1e-30)


def roofline_report(
    per_device_flops: float,
    per_device_bytes: float,
    per_device_collective_bytes: float,
    chips: int,
    cfg=None,
    shape=None,
    mf: Optional[float] = None,
    quantized: bool = False,
    model_n: int = 16,
) -> RooflineTerms:
    """The terms of one cell. ``model_n`` is the mesh's model axis, which
    the analytic memory term divides the weights by (the reference's fixed
    16, its default; a 1x1 mesh passes 1)."""
    flops_g = per_device_flops * chips
    bytes_g = per_device_bytes * chips
    coll_g = per_device_collective_bytes * chips
    mf = mf if mf is not None else (model_flops(cfg, shape) if cfg else 0.0)
    mem_an = 0.0
    if cfg is not None and shape is not None:
        mem_an = analytic_hbm_bytes(cfg, shape, chips=chips, model_n=model_n,
                                    quantized=quantized) / HW_H100["hbm_bw"]
    return RooflineTerms(
        compute_s=flops_g / (chips * HW_H100["peak_flops_bf16"]),
        memory_s=bytes_g / (chips * HW_H100["hbm_bw"]),
        collective_s=coll_g / (chips * HW_H100["link_bw"]),
        flops_global=flops_g,
        bytes_global=bytes_g,
        collective_bytes_global=coll_g,
        model_flops=mf,
        chips=chips,
        memory_analytic_s=mem_an,
    )
