"""DFQ: the paper's method as one call — port of ``repro.core.dfq``.

Paper Fig. 4: norm folding → cross-layer equalization → high-bias
absorption → weight quantization → bias correction → activation-range
setting. ``apply_dfq`` runs the function-preserving rewrites (folding, CLE,
absorption) over a params tree and a ``DFQPlan``; the pipeline's
``fold_norm`` / ``cle`` / ``bias_absorb`` stages each run one slice of them
through ``run_plan_ops``. ``quantize_weights`` and ``bias_correct`` are the
quantization and correction stage, and ``dfq_quantize`` chains everything
(the pipeline's ``dfq-int8`` recipe).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import torch

from . import bias_absorption, bias_correction, cle
from .graph import (
    DFQPlan,
    DensePairOp,
    HighBiasAbsorbOp,
    NormFoldOp,
    QKPairOp,
    VBiasAbsorbOp,
    VOPairOp,
)
from .quantizer import QuantSpec, fake_quant, sqnr_db
from .tree import get_path, has_path, set_path


@dataclasses.dataclass(frozen=True)
class DFQConfig:
    """Level-1 defaults: 8-bit asymmetric per-tensor, everything on (paper
    §5). The JAX config's fields, in its order."""

    weight_bits: int = 8
    act_bits: int = 8
    weight_symmetric: bool = False
    act_symmetric: bool = False
    per_channel: bool = False            # paper's per-channel baseline [18]
    cle: bool = True
    cle_iterations: int = 2              # pairs here are closed-form optimal;
                                         # >1 only matters for shared tensors
    bias_absorb: bool = True
    bias_correct: str = "empirical"      # "empirical" | "analytic" | "none"
    n_sigma_absorb: float = 3.0          # paper: 3γ ⇒ 99.865 %
    act_range_n_sigma: float = 6.0       # paper §5: β ± 6γ
    cle_include_approx_pairs: bool = False  # plain-GELU pairs (whisper MLP)

    @property
    def weight_spec(self) -> QuantSpec:
        return QuantSpec(bits=self.weight_bits, symmetric=self.weight_symmetric,
                         per_channel_axis=-1 if self.per_channel else None)

    @property
    def act_spec(self) -> QuantSpec:
        return QuantSpec(bits=self.act_bits, symmetric=self.act_symmetric)


def _maybe(params, path):
    return (get_path(params, path)
            if path is not None and has_path(params, path) else None)


def _fold(params, op: NormFoldOp) -> dict:
    consumers = [get_path(params, p) for p in op.consumers]
    cbias_paths = (list(op.consumer_biases) if op.consumer_biases is not None
                   else [None] * len(op.consumers))
    cbias = [_maybe(params, p) for p in cbias_paths]
    ones, zeros, new_ws, new_bs = cle.fold_norm(
        get_path(params, op.norm_w), consumers, _maybe(params, op.norm_b),
        cbias)
    params = set_path(params, op.norm_w, ones)
    if op.norm_b is not None and zeros is not None:
        params = set_path(params, op.norm_b, zeros)
    for p, w in zip(op.consumers, new_ws):
        params = set_path(params, p, w)
    for p, b in zip(cbias_paths, new_bs):
        if p is not None and b is not None:
            params = set_path(params, p, b)
    return params


def _set_pair(params, w1_path, w1, w2_path, w2, b_path, b) -> dict:
    params = set_path(params, w1_path, w1)
    params = set_path(params, w2_path, w2)
    if b_path is not None and b is not None:
        params = set_path(params, b_path, b)
    return params


def run_plan_ops(params: Mapping, plan: DFQPlan, config: DFQConfig, *,
                 kinds: Optional[tuple] = None, iterations: int = 1) -> dict:
    """Execute (a filtered slice of) the plan's function-preserving rewrites.

    ``kinds`` restricts execution to the given op classes (None → all ops);
    plan order is kept within a pass, so the stages' filtered schedule
    composes to the interleaved one for the LM plans (bias absorption
    commutes with the CLE rescales it follows).
    """
    for _ in range(max(1, iterations)):
        for op in plan.ops:
            if kinds is not None and not isinstance(op, kinds):
                continue
            if isinstance(op, NormFoldOp):
                params = _fold(params, op)
            elif isinstance(op, DensePairOp):
                if not config.cle:
                    continue
                if not op.exact and not config.cle_include_approx_pairs:
                    continue
                res = cle.equalize_dense_pair(get_path(params, op.w1),
                                              _maybe(params, op.b1),
                                              get_path(params, op.w2))
                params = _set_pair(params, op.w1, res.w1, op.w2, res.w2,
                                   op.b1, res.b1)
            elif isinstance(op, VOPairOp):
                if not config.cle:
                    continue
                res = cle.equalize_vo(get_path(params, op.wv),
                                      _maybe(params, op.bv),
                                      get_path(params, op.wo), n_q=op.n_q,
                                      n_kv=op.n_kv, head_dim=op.head_dim)
                params = _set_pair(params, op.wv, res.w1, op.wo, res.w2,
                                   op.bv, res.b1)
            elif isinstance(op, QKPairOp):
                if not config.cle:
                    continue
                res = cle.equalize_qk(
                    get_path(params, op.wq), _maybe(params, op.bq),
                    get_path(params, op.wk), _maybe(params, op.bk),
                    n_q=op.n_q, n_kv=op.n_kv, head_dim=op.head_dim,
                    rope=op.rope)
                params = _set_pair(params, op.wq, res.wq, op.wk, res.wk,
                                   op.bq, res.bq)
                if op.bk is not None and res.bk is not None:
                    params = set_path(params, op.bk, res.bk)
            elif isinstance(op, VBiasAbsorbOp):
                if not config.bias_absorb:
                    continue
                res = bias_absorption.absorb_v_bias(
                    get_path(params, op.bv), get_path(params, op.wo),
                    _maybe(params, op.bo), n_q=op.n_q, n_kv=op.n_kv,
                    head_dim=op.head_dim)
                params = set_path(params, op.bv, res.b1)
                params = set_path(params, op.bo, res.b2)
            elif isinstance(op, HighBiasAbsorbOp):
                if not config.bias_absorb:
                    continue
                c = bias_absorption.absorption_amount(
                    get_path(params, op.beta), get_path(params, op.gamma),
                    config.n_sigma_absorb)
                res = bias_absorption.absorb_dense(
                    get_path(params, op.b1), get_path(params, op.w2),
                    _maybe(params, op.b2), c)
                params = set_path(params, op.b1, res.b1)
                params = set_path(params, op.b2, res.b2)
            else:
                raise TypeError(f"unknown plan op {op!r}")
    return params


def apply_dfq(params: Mapping, plan: DFQPlan, config: DFQConfig) -> dict:
    """Function-preserving stage: norm folding, CLE, bias absorption.

    Returns a new params tree computing the same fp32 function (exactly,
    except ops flagged non-exact) with per-channel ranges equalized: the
    interleaved Fig. 4 schedule over ``run_plan_ops``.
    """
    return run_plan_ops(params, plan, config, iterations=config.cle_iterations)


def quantize_weights(params: Mapping, plan: DFQPlan, config: DFQConfig) -> dict:
    """Fake-quantize every weight site (simulated INT-k inference). The
    spec reduces over the whole stacked [L, ...] leaf, as the JAX package
    does: a per-tensor scale is one scale for every layer of a site."""
    spec = config.weight_spec
    for site in plan.sites:
        params = set_path(params, site.w,
                          fake_quant(get_path(params, site.w), spec))
    return params


def bias_correct(params: Mapping, plan: DFQPlan, config: DFQConfig,
                 input_means: Mapping[str, torch.Tensor]) -> dict:
    """Paper §4.2: subtract ε·E[x] from each site's bias.

    ``input_means[stat_key]`` is E[x] for the site's input (analytic or
    from a calibration run). A site without a bias gets one created — the
    correction IS the bias (the model reads biases with ``.get``, so the
    new leaf is served as it is).
    """
    spec = config.weight_spec
    for site in plan.sites:
        if site.stat_key is None or site.stat_key not in input_means:
            continue
        e_x = input_means[site.stat_key]
        w = get_path(params, site.w)
        b = _maybe(params, site.b)
        if site.kind == "dense":
            b_new = bias_correction.bias_correction_dense(w, b, e_x, spec)
        else:
            b_new = bias_correction.bias_correction_conv(
                w, b, e_x, spec, depthwise=(site.kind == "depthwise"))
        if site.b is None:
            raise ValueError(f"site {site.name} has no bias path for correction")
        params = set_path(params, site.b, b_new)
    return params


def dfq_quantize(params: Mapping, plan: DFQPlan,
                 config: DFQConfig = DFQConfig(),
                 input_means_fn: Optional[Callable[[Mapping], Mapping]] = None
                 ) -> dict:
    """The paper's end-to-end flow (Fig. 4) as one call.

    ``input_means_fn(params_equalized)`` supplies E[x] per stat_key.
    Returns fake-quantized params. A thin wrapper over the pipeline's
    ``dfq-int8`` recipe with the config's switches applied; prefer
    ``repro_torch.quantize``, which also returns the ``QuantizedModel``
    with the stage diagnostics.
    """
    # deferred: the pipeline's stages wrap this module
    from ..pipeline.api import run_legacy_dfq

    return run_legacy_dfq(params, plan, config, input_means_fn)


def weight_quant_snr(params_fp: Mapping, params_q: Mapping,
                     plan: DFQPlan) -> dict:
    """Per-site weight SQNR (dB)."""
    return {site.name: float(sqnr_db(get_path(params_fp, site.w),
                                     get_path(params_q, site.w)))
            for site in plan.sites}
