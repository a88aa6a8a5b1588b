"""Built-in pipeline stages wrapping the core DFQ transforms (port of the
serving half of ``repro.pipeline.stages``).

Stage order in a recipe follows the paper's Fig. 4: fold_norm → cle →
bias_absorb → pack (true-int8 serving), then kv_cache, which records the
KV-cache precision. ``weight_quant``, ``bias_correct``, ``act_ranges`` and
``shard`` are later slices of the port (``registry.NOT_PORTED``).
"""
from __future__ import annotations

import dataclasses

from ..core.dfq import run_plan_ops
from ..core.graph import (
    DensePairOp,
    HighBiasAbsorbOp,
    NormFoldOp,
    QKPairOp,
    VBiasAbsorbOp,
    VOPairOp,
)
from ..core.quantizer import sqnr_db
from ..core.tree import get_path
from .registry import register_stage
from .state import PipelineError

_CLE_KINDS = (DensePairOp, VOPairOp, QKPairOp)
_ABSORB_KINDS = (VBiasAbsorbOp, HighBiasAbsorbOp)


def _count_ops(plan, kinds) -> int:
    return sum(isinstance(op, kinds) for op in plan.ops)


@register_stage("fold_norm")
def fold_norm_stage(state, ctx):
    """Fold norm scale (and LayerNorm shift) into consuming linears."""
    state.params = run_plan_ops(state.params, state.plan, state.config,
                                kinds=(NormFoldOp,), iterations=1)
    state.note(ops=_count_ops(state.plan, NormFoldOp))
    return state


@register_stage("cle", iterations=None)
def cle_stage(state, ctx, *, iterations):
    """Cross-layer equalization over the plan's exact pairs (paper §4.1)."""
    cfg = dataclasses.replace(state.config, cle=True)
    it = iterations if iterations is not None else cfg.cle_iterations
    state.params = run_plan_ops(state.params, state.plan, cfg,
                                kinds=_CLE_KINDS, iterations=it)
    state.note(pairs=_count_ops(state.plan, _CLE_KINDS), iterations=int(it))
    return state


@register_stage("bias_absorb")
def bias_absorb_stage(state, ctx):
    """The exact value-bias absorption through attention into the output
    bias. (High-bias absorption, paper §4.1.3, comes with the CNN slice:
    ``run_plan_ops`` refuses its op.)"""
    cfg = dataclasses.replace(state.config, bias_absorb=True)
    state.params = run_plan_ops(state.params, state.plan, cfg,
                                kinds=_ABSORB_KINDS, iterations=1)
    state.note(ops=_count_ops(state.plan, _ABSORB_KINDS))
    return state


@register_stage("kv_cache", bits=8)
def kv_cache_stage(state, ctx, *, bits):
    """Record the serving KV-cache precision on the artifact.

    bits=8 applies the paper's symmetric per-token/per-head quantizer to the
    KV stream: caches built for the resulting QuantizedModel hold int8
    payload + float32 scales. A weight-free stage. The port serves the int8
    cache only: bits=16 (the JAX package's fp cache) is refused here.
    """
    if bits == 16:
        raise PipelineError("kv_cache: bits=16 (the fp KV cache) is not "
                            "ported yet; the port serves the int8 cache "
                            "(bits=8)")
    if bits != 8:
        raise PipelineError(f"kv_cache: bits must be 8 or 16, got {bits!r}")
    state.kv_bits = int(bits)
    state.note(bits=int(bits))
    return state


@register_stage("pack", mode="w8a16", per_channel=False)
def pack_stage(state, ctx, *, mode, per_channel):
    """Pack weight sites into int8 QTensors for true-int8 serving.

    mode="w8a16": int8 weights, fp activations (the W8A16 GEMM);
    mode="w8a8": dynamic int8 activations too (the W8A8 GEMM). Records the
    bytes summary and the per-site SQNR of the packed (dequantized) weights
    against their fp source.
    """
    if mode not in ("w8a16", "w8a8"):
        raise PipelineError(
            f"pack: unknown mode {mode!r}; use 'w8a16' or 'w8a8'")
    from ..quantized.ptq import quantize_for_serving, serving_summary

    fp = state.params
    packed = quantize_for_serving(fp, state.plan, mode=mode,
                                  per_channel=bool(per_channel))
    snr = {site.name: float(sqnr_db(get_path(fp, site.w),
                                    get_path(packed, site.w).dequant()))
           for site in state.plan.sites}
    state.params = packed
    state.note(mode=mode, per_channel=bool(per_channel),
               sites=len(state.plan.sites), sqnr_db=snr,
               **serving_summary(packed))
    return state
