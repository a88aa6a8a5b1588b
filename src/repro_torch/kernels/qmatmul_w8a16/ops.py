"""Public weight-only GEMM op, dispatched on the activation's device.

``quantize_out=True`` selects the epilogue variant (its own op and launch
counter, ``qmatmul_w8a16_q8``): the GEMM emits (int8 out, per-row scale) in
one launch, the ``quantize_act`` formula applied to the float32 result. It
is checked against the blocked ``qmatmul_w8a16_q8_ref`` (float32
accumulation order matters here, unlike the exact W8A8 case).

A leading expert axis on every operand (the MoE block's projections) is
one expert-batched launch on the card; the plain version loops over the
experts.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..dispatch import register_impl, register_spec, resolve
from .kernel import qmatmul_w8a16_cuda, qmatmul_w8a16_q8_cuda
from .ref import qmatmul_w8a16_q8_ref, qmatmul_w8a16_ref


@register_impl("qmatmul_w8a16", "cuda", pad="zero")
def _w8a16_cuda(a, w_q, w_scale, bias, *, out_dtype):
    # the kernel zero-fills ragged M / N / K tiles itself
    if out_dtype != a.dtype:
        raise ValueError(f"qmatmul_w8a16: the kernel writes a's dtype "
                         f"({a.dtype}), got out_dtype={out_dtype}")
    return qmatmul_w8a16_cuda(a, w_q, w_scale, bias)


@register_impl("qmatmul_w8a16", "torch", pad="zero")
def _w8a16_torch(a, w_q, w_scale, bias, *, out_dtype):
    if a.ndim == 3:
        return torch.stack([
            qmatmul_w8a16_ref(a[e], w_q[e], w_scale[e],
                              None if bias is None else bias[e], out_dtype)
            for e in range(a.shape[0])])
    return qmatmul_w8a16_ref(a, w_q, w_scale, bias, out_dtype)


@register_impl("qmatmul_w8a16_q8", "cuda", pad="zero")
def _w8a16_q8_cuda(a, w_q, w_scale, bias):
    return qmatmul_w8a16_q8_cuda(a, w_q, w_scale, bias)


@register_impl("qmatmul_w8a16_q8", "torch", pad="zero")
def _w8a16_q8_torch(a, w_q, w_scale, bias):
    return qmatmul_w8a16_q8_ref(a, w_q, w_scale, bias)


def qmatmul_w8a16(a: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *,
                  out_dtype: Optional[torch.dtype] = None,
                  quantize_out: bool = False, backend: Optional[str] = None):
    """y = a @ dequant(w_q) + bias. a [M, K] float32 | bfloat16, w_q [K, N]
    int8, w_scale [N] | [1], bias [N] or None; ``out_dtype`` defaults to
    a's dtype, the one the kernel writes. ``quantize_out=True`` returns
    (y_q int8 [M, N], y_scale float32 [M]) from the fused epilogue
    instead. E experts at once: a [E, M, K], w_q [E, K, N], w_scale [E, N]
    | [E, 1], bias [E, N] → [E, M, N] (no ``quantize_out``)."""
    if a.ndim == 3:
        if quantize_out:
            raise ValueError("qmatmul_w8a16: the quantize-out epilogue takes "
                             "no expert axis")
        return resolve("qmatmul_w8a16", a, backend)(
            a, w_q, w_scale, bias,
            out_dtype=a.dtype if out_dtype is None else out_dtype)
    if quantize_out:
        return resolve("qmatmul_w8a16_q8", a, backend)(
            a, w_q, torch.atleast_1d(w_scale), bias)
    return resolve("qmatmul_w8a16", a, backend)(
        a, w_q, torch.atleast_1d(w_scale), bias,
        out_dtype=a.dtype if out_dtype is None else out_dtype)


@register_spec("qmatmul_w8a16")
def _spec(*, device, d_in: int = 64, d_out: int = 128, **_):
    M, K, N = 8, d_in, d_out
    return (qmatmul_w8a16,
            (torch.zeros((M, K), device=device),
             # the [K, N] view of a contiguous [N, K] buffer: QTensor's
             # K-major layout, the one the kernel takes
             torch.zeros((N, K), dtype=torch.int8, device=device).t(),
             torch.ones((N,), device=device)),
            {"out_dtype": torch.float32})
