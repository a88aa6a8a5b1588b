"""Plain PyTorch version of the weight-only (W8A16) GEMM.

Arithmetic in the order of ``repro/kernels/qmatmul_w8a16/ref.py``: the
weight is dequantized in float32 (``q · scale``) before the product, the
product is ``a.float() @ w``, then ``+ bias``, then the cast. This is what
the JAX package serves on the CPU (its ``xla`` tier is this function), so
the plain path keeps token parity with the JAX engine. The CUDA kernel
applies the scale after the sum instead, so it is held to a tolerance
(``chip_smoke.py``), not to bit-equality.
"""
from __future__ import annotations

from typing import Optional

import torch


def qmatmul_w8a16_ref(
    a: torch.Tensor,                  # [M, K] bf16 / f32 activations
    w_q: torch.Tensor,                # [K, N] int8 (symmetric)
    w_scale: torch.Tensor,            # [N] or [1]
    bias: Optional[torch.Tensor] = None,   # [N]
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    w = w_q.to(torch.float32) * torch.atleast_1d(w_scale).to(torch.float32)[None, :]
    out = a.to(torch.float32) @ w
    if bias is not None:
        out = out + bias.to(torch.float32)[None, :]
    return out.to(out_dtype)
