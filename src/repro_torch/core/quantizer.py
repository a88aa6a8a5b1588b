"""Fixed-point quantizers (paper §1, §5) — port of ``repro.core.quantizer``.

Hardware-style affine quantization:

    q = clamp(round(x / scale) + zero_point, qmin, qmax)
    x̂ = (q - zero_point) * scale

symmetric (zero_point = 0) or asymmetric (paper Table 7), per-tensor (the
paper's hardware-friendly setting) or per-channel, any bit width. Weight
ranges are the tensor's min and max (paper §5); activation ranges come
data-free from normalization statistics as ``β ± n·γ``.

Every division here is tensor by tensor: on CUDA, PyTorch divides by a
Python scalar through its reciprocal, which is not the IEEE quotient the
JAX package computes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of a quantizer."""

    bits: int = 8
    symmetric: bool = False          # paper default: asymmetric (§5)
    per_channel_axis: Optional[int] = None  # None → per-tensor

    @property
    def qmin(self) -> int:
        return -(2 ** (self.bits - 1)) if self.symmetric else 0

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1 if self.symmetric else 2 ** self.bits - 1

    @property
    def dtype(self) -> torch.dtype:
        if self.bits <= 8:
            return torch.int8 if self.symmetric else torch.uint8
        return torch.int16 if self.symmetric else torch.uint16


@dataclasses.dataclass
class QParams:
    """Scale/zero-point pair. Tensors broadcast against what they quantize."""

    scale: torch.Tensor
    zero_point: torch.Tensor
    spec: QuantSpec


def _const(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full_like(like, float(value))


def _reduce_axes(x: torch.Tensor, channel_axis: Optional[int]) -> tuple:
    if channel_axis is None:
        return tuple(range(x.ndim))
    channel_axis = channel_axis % x.ndim
    return tuple(a for a in range(x.ndim) if a != channel_axis)


def _keepdims_shape(x: torch.Tensor, channel_axis: Optional[int]) -> tuple:
    if channel_axis is None:
        return ()
    channel_axis = channel_axis % x.ndim
    return tuple(x.shape[a] if a == channel_axis else 1 for a in range(x.ndim))


def compute_qparams(x: torch.Tensor, spec: QuantSpec,
                    eps: float = 1e-8) -> QParams:
    """Min/max-derived quantization parameters (paper §5: ranges are tensor
    min/max; per-channel reduces over all non-channel axes)."""
    axes = _reduce_axes(x, spec.per_channel_axis)
    if spec.symmetric:
        amax = x.abs().amax(dim=axes)
        scale = torch.clamp_min(amax, eps) / _const(amax, spec.qmax)
        zp = torch.zeros_like(scale)
    else:
        xmin = torch.clamp_max(x.amin(dim=axes), 0.0)  # grid must contain 0
        xmax = torch.clamp_min(x.amax(dim=axes), 0.0)
        rng = torch.clamp_min(xmax - xmin, eps)
        scale = rng / _const(rng, spec.qmax - spec.qmin)
        zp = torch.round(_const(xmin, spec.qmin) - xmin / scale)
        zp = torch.clamp(zp, spec.qmin, spec.qmax)
    shape = _keepdims_shape(x, spec.per_channel_axis)
    return QParams(scale.reshape(shape), zp.reshape(shape), spec)


def qparams_from_range(xmin: torch.Tensor, xmax: torch.Tensor,
                       spec: QuantSpec, eps: float = 1e-8) -> QParams:
    """Quantizer from externally supplied ranges — the data-free activation
    path (paper §5: range = β ± 6γ from normalization statistics)."""
    xmin = torch.as_tensor(xmin, dtype=torch.float32)
    xmax = torch.as_tensor(xmax, dtype=torch.float32)
    if spec.symmetric:
        amax = torch.maximum(xmin.abs(), xmax.abs())
        scale = torch.clamp_min(amax, eps) / _const(amax, spec.qmax)
        zp = torch.zeros_like(scale)
    else:
        xmin = torch.clamp_max(xmin, 0.0)
        xmax = torch.clamp_min(xmax, 0.0)
        rng = torch.clamp_min(xmax - xmin, eps)
        scale = rng / _const(rng, spec.qmax - spec.qmin)
        zp = torch.clamp(torch.round(_const(xmin, spec.qmin) - xmin / scale),
                         spec.qmin, spec.qmax)
    return QParams(scale, zp, spec)


def quantize(x: torch.Tensor, qp: QParams) -> torch.Tensor:
    q = torch.round(x / qp.scale) + qp.zero_point
    return torch.clamp(q, qp.spec.qmin, qp.spec.qmax).to(qp.spec.dtype)


def dequantize(q: torch.Tensor, qp: QParams) -> torch.Tensor:
    return (q.to(torch.float32) - qp.zero_point) * qp.scale


def fake_quant(x: torch.Tensor, spec: QuantSpec,
               eps: float = 1e-8) -> torch.Tensor:
    """Quantize-dequantize in one step (simulated fixed-point)."""
    qp = compute_qparams(x, spec, eps)
    return dequantize(quantize(x, qp), qp).to(x.dtype)


def fake_quant_with_qparams(x: torch.Tensor, qp: QParams) -> torch.Tensor:
    return dequantize(quantize(x, qp), qp).to(x.dtype)


# ----------------------------------------------------------------------------
# Range helpers of cross-layer equalization (paper §4.1.2 / appendix A).
# ----------------------------------------------------------------------------

def channel_ranges(w: torch.Tensor, channel_axis: int) -> torch.Tensor:
    """Symmetric per-channel range r_i = max_j |W_ij| (the paper's factor 2
    cancels in every ratio CLE takes; appendix A eq. 20)."""
    return w.abs().amax(dim=_reduce_axes(w, channel_axis))


def tensor_range(w: torch.Tensor) -> torch.Tensor:
    return w.abs().amax()


def channel_precision(w: torch.Tensor, channel_axis: int) -> torch.Tensor:
    """Per-channel precision p_i = r_i / R (paper eq. 8)."""
    r = channel_ranges(w, channel_axis)
    return r / torch.clamp_min(tensor_range(w), 1e-12)


def sqnr_db(x: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    """Signal-to-quantization-noise ratio in dB, the per-site quality metric
    of the pack stage."""
    x = x.to(torch.float32)
    x_hat = x_hat.to(torch.float32)
    num = x.square().sum()
    den = (x - x_hat).square().sum() + 1e-30
    return 10.0 * torch.log10(num / den)
