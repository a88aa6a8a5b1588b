"""Quantization bias correction (paper §4.2, appendices B-D) — port of
``repro.core.bias_correction``.

Weight quantization error ε = W̃ − W shifts a layer's output mean:
E[ỹ] = E[y] + ε·E[x]. The correction subtracts the expected error from the
layer's bias:

    b ← b − εᵀ E[x]                                (dense: y = x @ W + b)
    b_c ← b_c − Σ_ci E[x_ci] Σ_mn ε_{c,ci,mn}     (conv, appendix B)

E[x] comes analytically (a preceding norm's N(β, γ²) through the
activation: ``expected_input_analytic``) or empirically (the mean of a
calibration run on synthetic tokens, which keeps the flow data-free;
``models.lm.LMModel.calibration_stats``). ``empirical_bias_correction_
sequential`` is appendix D's exact layer-by-layer form for chain networks.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from .clipped_normal import clipped_normal_mean, gaussian_expect
from .quantizer import QuantSpec, compute_qparams, dequantize, quantize


def weight_quant_error(w: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """ε = W̃ − W for a min/max-calibrated quantizer."""
    qp = compute_qparams(w, spec)
    return dequantize(quantize(w, qp), qp) - w


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to approximate=True, the tanh form
    return F.gelu(x, approximate="tanh")


def expected_input_analytic(beta: torch.Tensor, gamma: torch.Tensor,
                            activation: str = "relu",
                            clip_max: Optional[float] = None) -> torch.Tensor:
    """E[x] for x = act(N(β, γ²)) — paper eq. 18/19 and appendix C.

    activation: "relu" | "relu6" | "identity" | "gelu" | "silu".
    """
    gamma = gamma.abs()
    if activation == "identity":
        return beta
    if activation == "relu":
        return clipped_normal_mean(beta, gamma, a=0.0, b=clip_max)
    if activation == "relu6":
        return clipped_normal_mean(beta, gamma, a=0.0, b=6.0)
    if activation == "gelu":
        return gaussian_expect(_gelu_tanh, beta, gamma)
    if activation == "silu":
        return gaussian_expect(F.silu, beta, gamma)
    raise ValueError(f"unknown activation {activation!r}")


def bias_correction_dense(w: torch.Tensor, b: Optional[torch.Tensor],
                          e_x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Corrected bias for a dense layer y = x @ W + b.

    w: [..., d_in, d_out], e_x: [..., d_in] → [..., d_out]. E[x] may be a
    bfloat16 mean (the calibration forward's compute dtype): it is widened
    to ε's float32 first, the promotion ``jnp.einsum`` makes.
    """
    eps = weight_quant_error(w, spec)
    corr = torch.einsum("...i,...io->...o", e_x.to(eps.dtype), eps)
    return -corr if b is None else b - corr


def bias_correction_conv(w: torch.Tensor, b: Optional[torch.Tensor],
                         e_x: torch.Tensor, spec: QuantSpec,
                         depthwise: bool = False) -> torch.Tensor:
    """Appendix B: E[ε * x] = ε * E[x]; with a spatially uniform E[x] the
    correction is the kernel's spatial sum. w: HWIO."""
    eps = weight_quant_error(w, spec)
    e_x = e_x.to(eps.dtype)
    if depthwise:
        corr = e_x * eps[..., 0, :].sum(dim=(0, 1))
    else:
        corr = torch.einsum("i,hwio->o", e_x, eps)
    return -corr if b is None else b - corr


class EmpiricalBC(NamedTuple):
    """Result of the appendix-D sequential procedure."""

    biases: list
    residual_bias: list  # E[ỹ] − E[y] after correction (diagnostic, → 0)


def empirical_bias_correction_sequential(
    layer_apply: Callable[[int, torch.Tensor, torch.Tensor, torch.Tensor],
                          torch.Tensor],
    weights: list,
    biases: list,
    x0: torch.Tensor,
    quantize_w: Callable[[torch.Tensor], torch.Tensor],
    reduce_axes: tuple = (0,),
) -> EmpiricalBC:
    """Appendix D, the exact sequential form, for chain networks.

    ``layer_apply(i, x, w, b)`` computes layer i's output from the previous
    layer's (the caller puts the previous activation inside it). The fp and
    the quantized chains run side by side; after layer i is computed in
    both, E[ỹ_i] − E[y_i] is folded into b̃_i, so a layer is corrected only
    after every layer feeding it has been.
    """
    x_fp = x_q = x0
    new_biases, residuals = [], []
    for i, (w, b) in enumerate(zip(weights, biases)):
        y_fp = layer_apply(i, x_fp, w, b)
        w_q = quantize_w(w)
        y_q = layer_apply(i, x_q, w_q, b)
        err = (y_q - y_fp).mean(dim=reduce_axes)
        b_new = (b if b is not None else 0.0) - err
        y_q = layer_apply(i, x_q, w_q, b_new)
        residuals.append((y_q - y_fp).mean(dim=reduce_axes))
        new_biases.append(b_new)
        x_fp, x_q = y_fp, y_q
    return EmpiricalBC(new_biases, residuals)


def output_bias_error(y_fp: torch.Tensor, y_q: torch.Tensor,
                      channel_axis: int = -1) -> torch.Tensor:
    """Paper eq. 1: per-channel E[ỹ − y] (the quantity of Fig. 3)."""
    axis = channel_axis % y_fp.ndim
    axes = tuple(a for a in range(y_fp.ndim) if a != axis)
    return (y_q - y_fp).mean(dim=axes)
