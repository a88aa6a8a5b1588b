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


def qmatmul_w8a16_q8_ref(a, w_q, w_scale, bias=None, bits: int = 8, *,
                         bk: int = 1024):
    """The quantize-out plain version, blocked as ``repro``'s
    ``qmatmul_w8a16_q8_ref``: the weight cast to a's dtype per K block of
    ``bk`` (exact for int8), float32 partial sums added block by block, then
    ``acc · scale + bias`` in float32 (never rounded to a's dtype) and the
    ``quantize_act`` formula per row → (q int8 [M, N], scale float32 [M])."""
    M, K = a.shape
    N = w_q.shape[1]
    bk_e = min(bk, K)
    pad = (-K) % bk_e
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        w_q = torch.nn.functional.pad(w_q, (0, 0, 0, pad))
    acc = torch.zeros((M, N), dtype=torch.float32, device=a.device)
    for k0 in range(0, K + pad, bk_e):
        w_blk = w_q[k0:k0 + bk_e].to(a.dtype)
        acc = acc + a[:, k0:k0 + bk_e].float() @ w_blk.float()
    out = acc * torch.atleast_1d(w_scale).float()[None, :]
    if bias is not None:
        out = out + bias.float()[None, :]
    qmax = 2 ** (bits - 1) - 1
    amax = out.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, 1e-8) / torch.full_like(amax, qmax)
    q = torch.clamp(torch.round(out / scale[:, None]), -qmax - 1, qmax)
    return q.to(torch.int8), scale
