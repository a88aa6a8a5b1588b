"""Public weight-only GEMM op, dispatched on the activation's device.

The JAX op's ``quantize_out`` epilogue variant (``qmatmul_w8a16_q8_pallas``)
is off the serving path and waits for the kernel-bench slice of the port.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..dispatch import register_impl, resolve
from .kernel import qmatmul_w8a16_cuda
from .ref import qmatmul_w8a16_ref


@register_impl("qmatmul_w8a16", "cuda", pad="zero")
def _w8a16_cuda(a, w_q, w_scale, bias, *, out_dtype):
    # the kernel zero-fills ragged M / N / K tiles itself
    if out_dtype != a.dtype:
        raise ValueError(f"qmatmul_w8a16: the kernel writes a's dtype "
                         f"({a.dtype}), got out_dtype={out_dtype}")
    return qmatmul_w8a16_cuda(a, w_q, w_scale, bias)


@register_impl("qmatmul_w8a16", "torch", pad="zero")
def _w8a16_torch(a, w_q, w_scale, bias, *, out_dtype):
    return qmatmul_w8a16_ref(a, w_q, w_scale, bias, out_dtype)


def qmatmul_w8a16(a: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *,
                  out_dtype: Optional[torch.dtype] = None,
                  quantize_out: bool = False) -> torch.Tensor:
    """y = a @ dequant(w_q) + bias. a [M, K] float32 | bfloat16, w_q [K, N]
    int8, w_scale [N] | [1], bias [N] or None; ``out_dtype`` defaults to
    a's dtype, the one the kernel writes."""
    if quantize_out:
        raise NotImplementedError(
            "qmatmul_w8a16(quantize_out=True): the quantize-out epilogue "
            "(qmatmul_w8a16_q8_pallas) is a later slice of the port, with "
            "the kernel-bench entry point")
    return resolve("qmatmul_w8a16", a)(
        a, w_q, torch.atleast_1d(w_scale), bias,
        out_dtype=a.dtype if out_dtype is None else out_dtype)
