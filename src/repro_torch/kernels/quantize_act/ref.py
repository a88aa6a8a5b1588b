"""Plain PyTorch version of per-row dynamic activation quantization.

Arithmetic in the order of ``repro/kernels/quantize_act/ref.py``: float32
absmax, ``scale = max(amax, 1e-8) / qmax`` and ``x / scale`` by true
division, round half to even, clip to ``[-qmax - 1, qmax]``.
"""
from __future__ import annotations

import torch


def quantize_act_ref(x: torch.Tensor, bits: int = 8):
    """x [M, K] → (q int8 [M, K], scale float32 [M])."""
    qmax = 2 ** (bits - 1) - 1
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    # divide by a tensor: PyTorch turns division by a Python scalar into a
    # multiplication by its reciprocal on CUDA, which is not IEEE division
    scale = torch.clamp_min(amax, 1e-8) / torch.full_like(amax, qmax)
    q = torch.clamp(torch.round(xf / scale[:, None]), -qmax - 1, qmax)
    return q.to(torch.int8), scale
