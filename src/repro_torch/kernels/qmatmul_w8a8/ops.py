"""Public W8A8 GEMM op, dispatched on the activation's device.

``quantize_out=True`` selects the epilogue variant (its own op and launch
counter, ``qmatmul_w8a8_q8``): the GEMM emits (int8 out, per-row scale) in
one launch — the exact ``quantize_act`` formula applied to the float32
result, so the stepwise GEMM → ``quantize_act`` pair collapses into one
launch bit-identically.

Asymmetric activations, as in the JAX op: with a = (a_q − zp)·s_a,
y = s_a s_w (Σ a_q w_q − zp Σ_k w_q[k, :]) + bias, so ``a_zero_point``
[M] | scalar applies the rank-1 term ``zp·colsum(w_q)·s_a·s_w`` after the
GEMM, in plain torch, as the reference applies it outside its Pallas
kernel; it cannot combine with ``quantize_out``.

``qmatmul_w8a8_qin`` takes the float activation instead and quantizes it
per row first (``quantize_act``), as the JAX package's ``quantize_input``
→ ``qmatmul_w8a8`` does: on the card one launch of the quantize-in kernel
(its own counter, ``qmatmul_w8a8_qin``), on the CPU the plain composition.
The model calls it wherever ``gemm_plan`` folds (``GemmPlan.fold``), for
the first projection that reads an activation, which also hands the
quantized activation to the others (``quantized=True``).

``qmatmul_w8a8_i32`` is the epilogue-free variant (its own launch counter,
``qmatmul_w8a8_i32_experts`` with an expert axis): the exact int32
accumulator, which a row-parallel shard sums over its ranks before
``w8a8_epilogue`` (the kernel's epilogue, in plain torch: the same bits).

A leading expert axis on every operand (the MoE block's projections) is
one expert-batched launch of the GEMM or its quantize-in variant on the
card; the plain versions loop over the experts.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..dispatch import register_impl, register_spec, resolve
from .kernel import (
    qmatmul_w8a8_cuda,
    qmatmul_w8a8_i32_cuda,
    qmatmul_w8a8_q8_cuda,
    qmatmul_w8a8_qin_cuda,
)
from .ref import (
    qmatmul_w8a8_i32_ref,
    qmatmul_w8a8_q8_ref,
    qmatmul_w8a8_qin_ref,
    qmatmul_w8a8_ref,
)


@register_impl("qmatmul_w8a8", "cuda", pad="zero")
def _w8a8_cuda(a_q, w_q, a_scale, w_scale, bias, *, out_dtype):
    # the kernel zero-fills ragged M / N / K tiles itself
    return qmatmul_w8a8_cuda(a_q, w_q, a_scale, w_scale, bias,
                             out_dtype=out_dtype)


def _per_expert(fn, *args, **kw):
    """``fn`` over each expert's slice of every tensor argument, stacked
    (a tuple result stacked item by item)."""
    outs = [fn(*(a[e] if isinstance(a, torch.Tensor) else a for a in args),
               **kw) for e in range(args[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


@register_impl("qmatmul_w8a8", "torch", pad="zero")
def _w8a8_torch(a_q, w_q, a_scale, w_scale, bias, *, out_dtype):
    if a_q.ndim == 3:
        return _per_expert(qmatmul_w8a8_ref, a_q, w_q, a_scale, w_scale,
                           bias, out_dtype)
    return qmatmul_w8a8_ref(a_q, w_q, a_scale, w_scale, bias, out_dtype)


@register_impl("qmatmul_w8a8_i32", "cuda", pad="zero")
def _w8a8_i32_cuda(a_q, w_q):
    return qmatmul_w8a8_i32_cuda(a_q, w_q)


@register_impl("qmatmul_w8a8_i32", "torch", pad="zero")
def _w8a8_i32_torch(a_q, w_q):
    if a_q.ndim == 3:
        return _per_expert(qmatmul_w8a8_i32_ref, a_q, w_q)
    return qmatmul_w8a8_i32_ref(a_q, w_q)


@register_impl("qmatmul_w8a8_q8", "cuda", pad="zero")
def _w8a8_q8_cuda(a_q, w_q, a_scale, w_scale, bias):
    return qmatmul_w8a8_q8_cuda(a_q, w_q, a_scale, w_scale, bias)


@register_impl("qmatmul_w8a8_q8", "torch", pad="zero")
def _w8a8_q8_torch(a_q, w_q, a_scale, w_scale, bias):
    return qmatmul_w8a8_q8_ref(a_q, w_q, a_scale, w_scale, bias)


@register_impl("qmatmul_w8a8_qin", "cuda", pad="zero")
def _w8a8_qin_cuda(x, w_q, w_scale, bias, *, out_dtype, quantized):
    return qmatmul_w8a8_qin_cuda(x, w_q, w_scale, bias, out_dtype=out_dtype,
                                 quantized=quantized)


@register_impl("qmatmul_w8a8_qin", "torch", pad="zero")
def _w8a8_qin_torch(x, w_q, w_scale, bias, *, out_dtype, quantized):
    if x.ndim == 3:
        return _per_expert(qmatmul_w8a8_qin_ref, x, w_q, w_scale, bias,
                           out_dtype, quantized)
    return qmatmul_w8a8_qin_ref(x, w_q, w_scale, bias, out_dtype, quantized)


def _scale_bias(w_scale, bias, lead: tuple, N: int, dev):
    """w_scale broadcast to float32 [*lead, N]; bias float32 [*lead, N],
    zeros if None (``lead`` (E,) for expert-stacked operands, else ())."""
    w_scale = torch.as_tensor(w_scale, dtype=torch.float32, device=dev)
    if lead and w_scale.ndim == 1:
        w_scale = w_scale[:, None]
    w_scale = torch.broadcast_to(w_scale, lead + (N,)).contiguous()
    bias = (torch.zeros(lead + (N,), dtype=torch.float32, device=dev)
            if bias is None else bias.to(torch.float32).contiguous())
    return w_scale, bias


def qmatmul_w8a8_qin(x: torch.Tensor, w_q: torch.Tensor, w_scale,
                     bias: Optional[torch.Tensor] = None, *,
                     out_dtype: torch.dtype = torch.float32,
                     quantized: bool = False, backend: Optional[str] = None):
    """y = quantize_act(x) @ dequant(w_q) + bias, x [M, K] float32 |
    bfloat16, w_q [K, N] int8, w_scale [N] | [1], bias [N]: the same bits as
    ``quantize_act`` followed by ``qmatmul_w8a8``. ``quantized=True``
    returns (y, x_q, x_scale), ``quantize_act(x)`` for the other W8A8
    projections that read x (on the card, from the same launch). E experts
    at once: x [E, M, K], w_q [E, K, N], w_scale [E, N] | [E, 1], bias
    [E, N] → [E, M, N] (x_q [E, M, K], x_scale [E, M])."""
    w_scale, bias = _scale_bias(w_scale, bias, tuple(x.shape[:-2]),
                                w_q.shape[-1], x.device)
    return resolve("qmatmul_w8a8_qin", x, backend)(x, w_q, w_scale, bias,
                                          out_dtype=out_dtype,
                                          quantized=quantized)


def qmatmul_w8a8_i32(a_q: torch.Tensor, w_q: torch.Tensor, *,
                     backend: Optional[str] = None) -> torch.Tensor:
    """The epilogue-free W8A8 GEMM: a_q [M, K] int8 times w_q [K, N] int8
    (K-major) → the exact int32 accumulator [M, N], no scale and no bias.
    A row-parallel shard sums these over its ranks in int32 and then
    applies ``w8a8_epilogue``, which gives ``qmatmul_w8a8``'s bits. E
    experts at once: a_q [E, M, K], w_q [E, K, N] → [E, M, N] (one launch
    on the card)."""
    return resolve("qmatmul_w8a8_i32", a_q, backend)(a_q, w_q)


def qmatmul_w8a8(a_q: torch.Tensor, w_q: torch.Tensor, a_scale, w_scale,
                 bias: Optional[torch.Tensor] = None,
                 a_zero_point=None, *,
                 out_dtype: torch.dtype = torch.float32,
                 quantize_out: bool = False, backend: Optional[str] = None):
    """y = dequant(a_q) @ dequant(w_q) + bias. a_q [M, K] int8, w_q [K, N]
    int8, a_scale [M] | [1], w_scale [N] | [1], bias [N]; ``a_zero_point``
    [M] | scalar for asymmetric activations (see the module docstring).

    ``quantize_out=True`` returns (y_q int8 [M, N], y_scale float32 [M])
    instead — the fused GEMM + quantize epilogue feeding a W8A8 layer.

    E experts at once: a_q [E, M, K], w_q [E, K, N], a_scale [E, M],
    w_scale [E, N] | [E, 1], bias [E, N] → [E, M, N] (symmetric, no
    ``quantize_out``)."""
    lead = tuple(a_q.shape[:-2])
    M = a_q.shape[-2]
    N = w_q.shape[-1]
    dev = a_q.device
    if lead and (a_zero_point is not None or quantize_out):
        raise ValueError("qmatmul_w8a8: an expert axis takes symmetric "
                         "activations and no quantize-out epilogue")
    a_scale = torch.broadcast_to(
        torch.as_tensor(a_scale, dtype=torch.float32, device=dev), lead + (M,)
    ).contiguous()
    w_scale, bias = _scale_bias(w_scale, bias, lead, N, dev)
    if a_zero_point is not None:
        if quantize_out:
            raise ValueError(
                "qmatmul_w8a8: quantize_out folds the epilogue into the "
                "kernel, but the zero-point correction is applied post-GEMM "
                "— drop a_zero_point (symmetric activations) or quantize_out")
        # zp per row, colsum per column: a rank-1 term after the GEMM, in
        # the reference's order of products
        colsum = w_q.to(torch.int32).sum(dim=0).to(torch.float32)
        zp = torch.broadcast_to(torch.as_tensor(
            a_zero_point, dtype=torch.float32, device=dev), (M,))
        zp_term = (zp[:, None] * colsum[None, :] * a_scale[:, None]
                   * w_scale[None, :])
    if quantize_out:
        return resolve("qmatmul_w8a8_q8", a_q, backend)(a_q, w_q, a_scale,
                                                        w_scale, bias)
    out = resolve("qmatmul_w8a8", a_q, backend)(a_q, w_q, a_scale, w_scale,
                                                bias, out_dtype=out_dtype)
    if a_zero_point is not None:
        out = (out.to(torch.float32) - zp_term).to(out_dtype)
    return out


@register_spec("qmatmul_w8a8")
def _spec(*, device, d_in: int = 64, d_out: int = 128, **_):
    M, K, N = 8, d_in, d_out
    return (qmatmul_w8a8,
            (torch.zeros((M, K), dtype=torch.int8, device=device),
             torch.zeros((K, N), dtype=torch.int8, device=device),
             torch.ones((M,), device=device), torch.ones((N,), device=device)),
            {})
