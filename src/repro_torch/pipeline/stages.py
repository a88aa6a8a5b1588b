"""Built-in pipeline stages wrapping the core DFQ transforms (port of
``repro.pipeline.stages``).

Stage order in a recipe follows the paper's Fig. 4: fold_norm → cle →
bias_absorb → bias_correct → weight_quant (fake-quant) or pack (true-int8
serving), then kv_cache, which records the KV-cache precision;
act_ranges sets the activation ranges data-free. ``bias_correct`` runs
before weight quantization because ε = W̃ − W is computed from the
still-fp weights. ``shard`` records the serving parallelism plan (the
``-tp`` recipes).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.bias_correction import expected_input_analytic
from ..core.dfq import bias_correct as core_bias_correct
from ..core.dfq import quantize_weights as core_quantize_weights
from ..core.dfq import run_plan_ops, weight_quant_snr
from ..core.graph import (
    DensePairOp,
    HighBiasAbsorbOp,
    NormFoldOp,
    QKPairOp,
    VBiasAbsorbOp,
    VOPairOp,
)
from ..core.quantizer import qparams_from_range, sqnr_db
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


@register_stage("cle", iterations=None, include_approx_pairs=None)
def cle_stage(state, ctx, *, iterations, include_approx_pairs):
    """Cross-layer equalization over the plan's exact pairs (paper §4.1)."""
    cfg = dataclasses.replace(
        state.config, cle=True,
        cle_include_approx_pairs=(
            state.config.cle_include_approx_pairs
            if include_approx_pairs is None else include_approx_pairs))
    it = iterations if iterations is not None else cfg.cle_iterations
    state.params = run_plan_ops(state.params, state.plan, cfg,
                                kinds=_CLE_KINDS, iterations=it)
    state.note(pairs=_count_ops(state.plan, _CLE_KINDS), iterations=int(it))
    return state


@register_stage("bias_absorb")
def bias_absorb_stage(state, ctx):
    """High-bias absorption into the following layer (paper §4.1.3)."""
    cfg = dataclasses.replace(state.config, bias_absorb=True)
    state.params = run_plan_ops(state.params, state.plan, cfg,
                                kinds=_ABSORB_KINDS, iterations=1)
    state.note(ops=_count_ops(state.plan, _ABSORB_KINDS))
    return state


@register_stage("bias_correct", method="empirical")
def bias_correct_stage(state, ctx, *, method):
    """Quantization-bias correction b ← b − εᵀE[x] (paper §4.2).

    method="empirical": E[x] from the context's calibration hook (synthetic
    tokens — still data-free). method="analytic": the closed-form
    clipped-normal route; needs the model to expose
    ``analytic_input_stats()`` returning ``{stat_key: (beta, gamma,
    activation)}``.
    """
    if method == "none":
        state.note(skipped="method='none'")
        return state
    if method not in ("empirical", "analytic"):
        raise PipelineError(
            f"bias_correct: unknown method {method!r}; "
            "use 'empirical', 'analytic', or 'none'")
    if method == "analytic":
        stats_fn = getattr(ctx.model, "analytic_input_stats", None)
        if stats_fn is None:
            raise PipelineError(
                "bias_correct(method='analytic') needs the model to expose "
                "analytic_input_stats() -> {stat_key: (beta, gamma, activation)} "
                f"but {type(ctx.model).__name__} does not; use "
                "method='empirical' (synthetic-calibration route) instead")
        means = {k: expected_input_analytic(beta, gamma, activation)
                 for k, (beta, gamma, activation) in stats_fn().items()}
    else:
        if ctx.calibrate is None:
            state.note(skipped="no calibration hook available")
            return state
        means = ctx.calibrate(state.params)
    if not means:
        state.note(skipped="calibration returned no statistics")
        return state
    state.input_means = means
    state.params = core_bias_correct(state.params, state.plan, state.config,
                                     means)
    corrected = [s.name for s in state.plan.sites
                 if s.stat_key is not None and s.stat_key in means]
    state.note(method=method, sites_corrected=corrected)
    return state


@register_stage("weight_quant", bits=None, per_channel=None, symmetric=None)
def weight_quant_stage(state, ctx, *, bits, per_channel, symmetric):
    """Fake-quantize every weight site (simulated INT-k inference).

    Records the per-site SQNR (dB) of the quantized weights against the
    pre-quantization snapshot (``weight_quant_snr``).
    """
    repl = {}
    if bits is not None:
        repl["weight_bits"] = int(bits)
    if per_channel is not None:
        repl["per_channel"] = bool(per_channel)
    if symmetric is not None:
        repl["weight_symmetric"] = bool(symmetric)
    cfg = dataclasses.replace(state.config, **repl) if repl else state.config
    fp = state.params
    state.fp_params = fp
    state.params = core_quantize_weights(fp, state.plan, cfg)
    snr = weight_quant_snr(fp, state.params, state.plan)
    state.note(sites=len(state.plan.sites), bits=cfg.weight_bits,
               per_channel=cfg.per_channel, sqnr_db=snr,
               sqnr_min_db=min(snr.values()) if snr else None,
               sqnr_mean_db=(sum(snr.values()) / len(snr)) if snr else None)
    return state


@register_stage("act_ranges", n_sigma=None)
def act_ranges_stage(state, ctx, *, n_sigma):
    """Data-free activation-range setting (paper §5: range = β ± nγ).

    LM route: the per-channel calibration means stand in for β and their
    spread across channels for γ (the capture records first moments only).
    The QParams are kept on the state and the artifact for static-activation
    backends; the W8A8 kernels quantize activations dynamically and do not
    read them.
    """
    ns = float(n_sigma if n_sigma is not None
               else state.config.act_range_n_sigma)
    means = state.input_means
    if means is None and ctx.calibrate is not None:
        means = ctx.calibrate(state.params)
        state.input_means = means
    if not means:
        state.note(skipped="no calibration statistics available")
        return state
    spec = state.config.act_spec
    ranges = {}
    for key, m in means.items():
        if not isinstance(m, torch.Tensor):
            continue
        v = m.to(torch.float32).reshape(-1)
        # the population std, as jnp.std (ddof 0): torch.std is unbiased
        # unless told otherwise
        sd = v.std(correction=0)
        lo, hi = v.min() - ns * sd, v.max() + ns * sd
        state.act_qparams[key] = qparams_from_range(lo, hi, spec)
        ranges[key] = (float(lo), float(hi))
    state.note(n_sigma=ns, keys=sorted(ranges), ranges=ranges)
    return state


@register_stage("kv_cache", bits=8)
def kv_cache_stage(state, ctx, *, bits):
    """Record the serving KV-cache precision on the artifact.

    bits=8 applies the paper's symmetric per-token/per-head quantizer to the
    KV stream: caches built for the resulting QuantizedModel hold int8
    payload + float32 scales; bits=16 keeps the fp cache. A weight-free
    stage: ``quantize`` folds the bits into the artifact's config
    (``kv_cache_bits``), as the JAX package does.
    """
    if bits not in (8, 16):
        raise PipelineError(f"kv_cache: bits must be 8 or 16, got {bits!r}")
    state.kv_bits = int(bits)
    state.note(bits=int(bits))
    return state


@register_stage("shard", mode="tp")
def shard_stage(state, ctx, *, mode):
    """Record the serving parallelism plan on the artifact.

    mode="tp": serve the model tensor-parallel — weights placed under the
    serve-mode partition specs (Megatron TP over the mesh's "model" axis,
    int8 QTensor scales co-sharded with their payload columns, no FSDP
    factor) and the pooled KV cache sharded slot-wise over "data". A
    weight-free stage, like ``kv_cache``: the per-layer DFQ metadata shards
    with its tensor, so nothing is re-quantized —
    ``ServingEngine(mesh=...)`` applies the plan at load.
    """
    if mode not in ("tp", "none"):
        raise PipelineError(f"shard: unknown mode {mode!r}; use 'tp' or "
                            "'none'")
    state.shard_mode = None if mode == "none" else mode
    state.note(mode=mode)
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
    state.fp_params = fp
    packed = quantize_for_serving(fp, state.plan, mode=mode,
                                  per_channel=bool(per_channel))
    snr = {site.name: float(sqnr_db(get_path(fp, site.w),
                                    get_path(packed, site.w).dequant()))
           for site in state.plan.sites}
    state.params = packed
    state.packed = True
    state.pack_mode = mode
    state.note(mode=mode, per_channel=bool(per_channel),
               sites=len(state.plan.sites), sqnr_db=snr,
               **serving_summary(packed))
    return state
