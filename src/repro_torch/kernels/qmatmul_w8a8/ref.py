"""Plain PyTorch version of the W8A8 GEMM.

Arithmetic in the order of ``repro/kernels/qmatmul_w8a8/ref.py``: exact
integer accumulation, then ``((acc * a_scale) * w_scale) + bias`` in float32.
CUDA has no integer matmul, so the accumulator is taken in float64, which is
exact here on either device: every partial sum is an integer of magnitude at
most 128 * 127 * K, far below 2**53 for any K the models use.
"""
from __future__ import annotations

from typing import Optional

import torch


def qmatmul_w8a8_acc(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Σ_k a_q[m, k] · w_q[k, n], exact, as float64 [M, N]."""
    return a_q.to(torch.float64) @ w_q.to(torch.float64)


def w8a8_epilogue(acc: torch.Tensor, a_scale, w_scale,
                  bias: Optional[torch.Tensor] = None,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The W8A8 GEMM's scale epilogue on an exact accumulator ``acc``
    [M, N] (int32 or integral float64): ``((acc * a_scale) * w_scale) +
    bias`` in float32, each step rounded alone — the kernel's
    ``__fmul_rn`` / ``__fadd_rn`` order, so the same bits on either
    device. With a leading expert axis: acc [E, M, N], a_scale [E, M],
    w_scale [E, N] | [E, 1], bias [E, N]."""
    out = acc.to(torch.float32)
    out = (out * torch.atleast_1d(a_scale).float()[..., :, None]
           * torch.atleast_1d(w_scale).float()[..., None, :])
    if bias is not None:
        out = out + bias.float()[..., None, :]
    return out.to(out_dtype)


def qmatmul_w8a8_i32_ref(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The epilogue-free plain version: the exact accumulator as int32
    [M, N] (a row-parallel shard's partial sums, added over the ranks in
    int32 before ``w8a8_epilogue``)."""
    return qmatmul_w8a8_acc(a_q, w_q).to(torch.int32)


def qmatmul_w8a8_ref(
    a_q: torch.Tensor,          # [M, K] int8
    w_q: torch.Tensor,          # [K, N] int8
    a_scale: torch.Tensor,      # [M] or [1]
    w_scale: torch.Tensor,      # [N] or [1]
    bias: Optional[torch.Tensor] = None,   # [N] float32
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    return w8a8_epilogue(qmatmul_w8a8_acc(a_q, w_q), a_scale, w_scale, bias,
                         out_dtype)


def qmatmul_w8a8_q8_ref(a_q, w_q, a_scale, w_scale, bias=None, bits: int = 8):
    """The quantize-out plain version: the float32 GEMM (exact accumulation)
    re-quantized per row by ``quantize_act_ref`` — bit-equal to the GEMM
    followed by ``quantize_act``, as ``repro``'s ``qmatmul_w8a8_q8_ref``."""
    from ..quantize_act.ref import quantize_act_ref

    return quantize_act_ref(
        qmatmul_w8a8_ref(a_q, w_q, a_scale, w_scale, bias, torch.float32), bits)


def qmatmul_w8a8_qin_ref(x, w_q, w_scale, bias=None,
                         out_dtype: torch.dtype = torch.float32,
                         quantized: bool = False):
    """The quantize-in plain version: ``quantize_act_ref`` of the float
    activation x [M, K], then the W8A8 GEMM — the JAX package's
    ``quantize_input`` → ``qmatmul_w8a8``; ``quantized=True`` returns
    (y, x_q, x_scale)."""
    from ..quantize_act.ref import quantize_act_ref

    a_q, a_s = quantize_act_ref(x)
    y = qmatmul_w8a8_ref(a_q, w_q, a_s, w_scale, bias, out_dtype)
    return (y, a_q, a_s) if quantized else y
