"""DFQ's function-preserving rewrites as one call — port of the first half
of ``repro.core.dfq``.

Paper Fig. 4: norm folding → cross-layer equalization → high-bias
absorption → weight quantization → bias correction. ``apply_dfq`` runs the
function-preserving rewrites (folding, CLE, absorption) over a params tree
and a ``DFQPlan``; the pipeline's ``fold_norm`` / ``cle`` / ``bias_absorb``
stages each run one slice of them through ``run_plan_ops``. Weight
fake-quantization and bias correction (``quantize_weights``,
``bias_correct``, ``dfq_quantize``) are the next slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

from . import bias_absorption, cle
from .graph import (
    DFQPlan,
    DensePairOp,
    HighBiasAbsorbOp,
    NormFoldOp,
    QKPairOp,
    VBiasAbsorbOp,
    VOPairOp,
)
from .tree import get_path, has_path, set_path


@dataclasses.dataclass(frozen=True)
class DFQConfig:
    """The options the function-preserving rewrites read (paper §5: every
    rewrite on). The JAX config's quantizer, bias-correction and
    activation-range options come with the slice that ports those stages;
    the pack stage takes its own ``mode`` and ``per_channel``."""

    cle: bool = True
    cle_iterations: int = 2              # pairs here are closed-form optimal;
                                         # >1 only matters for shared tensors
    bias_absorb: bool = True


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
                # approximate (plain-GELU) pairs are left alone, as the
                # JAX package does by default; no port model emits one
                if not config.cle or not op.exact:
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
                raise NotImplementedError(
                    "high-bias absorption (HighBiasAbsorbOp) is not ported "
                    "yet: it comes with the CNN slice, whose plans emit it")
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
