"""Launch wrapper of the CUDA W8A8 GEMM (``csrc/qmatmul_w8a8.cu``).

Replaces ``qmatmul_w8a8_pallas`` (``repro/kernels/qmatmul_w8a8/kernel.py``).
The weight must be stored K-major: ``w_q`` is the [K, N] view of an [N, K]
contiguous buffer (``w_q.t().is_contiguous()``), which is how the port's
``QTensor`` keeps every int8 weight — so the kernel reads each output
column's K bytes contiguously and no copy is made per call.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..dispatch import count_launch

_ARGS = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,))


def qmatmul_w8a8_cuda(a_q: torch.Tensor, w_q: torch.Tensor,
                      a_scale: torch.Tensor, w_scale: torch.Tensor,
                      bias: torch.Tensor, *, out_dtype=torch.float32):
    """a_q [M, K] int8, w_q [K, N] int8 (K-major), a_scale [M], w_scale [N],
    bias [N] float32, all on the card → [M, N] ``out_dtype``."""
    tensors = {"a_q": a_q, "w_q": w_q, "a_scale": a_scale,
               "w_scale": w_scale, "bias": bias}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != a_q.device:
            raise ValueError(f"qmatmul_w8a8_cuda: {name} is on {t.device}, "
                             f"expected {a_q.device}")
    if a_q.dtype != torch.int8 or w_q.dtype != torch.int8 or a_q.ndim != 2 \
            or w_q.ndim != 2 or a_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"qmatmul_w8a8_cuda: want int8 a [M, K] and w [K, N], "
                         f"got {tuple(a_q.shape)} {a_q.dtype} and "
                         f"{tuple(w_q.shape)} {w_q.dtype}")
    M, K = a_q.shape
    N = w_q.shape[1]
    wt = w_q.t()
    if not wt.is_contiguous():
        raise ValueError("qmatmul_w8a8_cuda: w_q must be the [K, N] view of "
                         "a contiguous [N, K] buffer (QTensor's K-major "
                         "layout)")
    for name, t, n in (("a_scale", a_scale, M), ("w_scale", w_scale, N),
                       ("bias", bias, N)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,) \
                or not t.is_contiguous():
            raise ValueError(f"qmatmul_w8a8_cuda: {name} must be contiguous "
                             f"float32 [{n}], got {tuple(t.shape)} {t.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"qmatmul_w8a8_cuda: out_dtype {out_dtype} not "
                         f"supported (float32 | bfloat16)")
    a_q = a_q.contiguous()
    vec = int(K % 16 == 0 and a_q.data_ptr() % 16 == 0
              and wt.data_ptr() % 16 == 0)
    out = torch.empty((M, N), dtype=out_dtype, device=a_q.device)
    _build.call("repro_qmatmul_w8a8", _ARGS, a_q.data_ptr(), wt.data_ptr(),
                a_scale.data_ptr(), w_scale.data_ptr(), bias.data_ptr(),
                out.data_ptr(), M, N, K, int(out_dtype == torch.bfloat16),
                vec, torch.cuda.current_stream(a_q.device).cuda_stream)
    count_launch("qmatmul_w8a8")
    return out
