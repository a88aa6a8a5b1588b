"""Launch wrappers of the CUDA W8A8 GEMM (``csrc/qmatmul_w8a8.cu``).

Replace ``qmatmul_w8a8_pallas`` and, with the quantize-out epilogue,
``qmatmul_w8a8_q8_pallas`` (``repro/kernels/qmatmul_w8a8/kernel.py``).
The weight must be stored K-major: ``w_q`` is the [K, N] view of an [N, K]
contiguous buffer (``w_q.t().is_contiguous()``), which is how the port's
``QTensor`` keeps every int8 weight — so the kernel reads each output
column's K bytes contiguously and no copy is made per call. The split of K
across CTAs comes from ``gemm_plan`` (shared with the W8A16 wrapper); the
private ``_splits`` keyword forces it, to sweep the reduction on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build, gemm_plan
from ..dispatch import count_launch, stream_scratch

_ARGS = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,))
_ARGS_Q8 = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 6
            + (ctypes.c_void_p,))


def q8_workspace(M: int, N: int, device: torch.device):
    """The quantize-out epilogue's operands besides the GEMM's own
    (``csrc/q8_epilogue.cuh``): the float32 y workspace [M, N] and the
    uint32 scratch of the rows' max and the M tiles' counters,
    [M + ceil(M / 16)]."""
    return (torch.empty((M, N), dtype=torch.float32, device=device),
            stream_scratch(M + -(-M // 16), device))


def _checked(a_q, w_q, a_scale, w_scale, bias, who):
    """Check the operands; return (a_q contiguous, the [N, K] weight, vec)."""
    tensors = {"a_q": a_q, "w_q": w_q, "a_scale": a_scale,
               "w_scale": w_scale, "bias": bias}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != a_q.device:
            raise ValueError(f"{who}: {name} is on {t.device}, expected "
                             f"{a_q.device}")
    if a_q.dtype != torch.int8 or w_q.dtype != torch.int8 or a_q.ndim != 2 \
            or w_q.ndim != 2 or a_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"{who}: want int8 a [M, K] and w [K, N], got "
                         f"{tuple(a_q.shape)} {a_q.dtype} and "
                         f"{tuple(w_q.shape)} {w_q.dtype}")
    M, K = a_q.shape
    N = w_q.shape[1]
    wt = w_q.t()
    if not wt.is_contiguous():
        raise ValueError(f"{who}: w_q must be the [K, N] view of a "
                         f"contiguous [N, K] buffer (QTensor's K-major "
                         f"layout)")
    for name, t, n in (("a_scale", a_scale, M), ("w_scale", w_scale, N),
                       ("bias", bias, N)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,) \
                or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous float32 "
                             f"[{n}], got {tuple(t.shape)} {t.dtype}")
    a_q = a_q.contiguous()
    vec = int(K % 16 == 0 and a_q.data_ptr() % 16 == 0
              and wt.data_ptr() % 16 == 0)
    return a_q, wt, vec


def qmatmul_w8a8_cuda(a_q: torch.Tensor, w_q: torch.Tensor,
                      a_scale: torch.Tensor, w_scale: torch.Tensor,
                      bias: torch.Tensor, *, out_dtype=torch.float32,
                      _splits: Optional[int] = None):
    """a_q [M, K] int8, w_q [K, N] int8 (K-major), a_scale [M], w_scale [N],
    bias [N] float32, all on the card → [M, N] ``out_dtype``."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"qmatmul_w8a8_cuda: out_dtype {out_dtype} not "
                         f"supported (float32 | bfloat16)")
    a_q, wt, vec = _checked(a_q, w_q, a_scale, w_scale, bias,
                            "qmatmul_w8a8_cuda")
    M, K = a_q.shape
    N = wt.shape[0]
    dev = a_q.device
    plan = gemm_plan.plan(M, N, K, splits=_splits)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    _build.call("repro_qmatmul_w8a8", _ARGS, a_q.data_ptr(), wt.data_ptr(),
                a_scale.data_ptr(), w_scale.data_ptr(), bias.data_ptr(),
                out.data_ptr(), M, N, K, plan.bm, plan.splits,
                int(out_dtype == torch.bfloat16), vec,
                torch.cuda.current_stream(dev).cuda_stream)
    count_launch("qmatmul_w8a8")
    return out


def qmatmul_w8a8_q8_cuda(a_q: torch.Tensor, w_q: torch.Tensor,
                         a_scale: torch.Tensor, w_scale: torch.Tensor,
                         bias: torch.Tensor, *,
                         _splits: Optional[int] = None):
    """The GEMM with the quantize-out epilogue, in one launch: operands as
    ``qmatmul_w8a8_cuda`` → (q int8 [M, N], scale float32 [M]), the float32
    result quantized per row by the ``quantize_act`` formula."""
    a_q, wt, vec = _checked(a_q, w_q, a_scale, w_scale, bias,
                            "qmatmul_w8a8_q8_cuda")
    M, K = a_q.shape
    N = wt.shape[0]
    dev = a_q.device
    plan = gemm_plan.plan(M, N, K, splits=_splits)
    y, scratch = q8_workspace(M, N, dev)
    q = torch.empty((M, N), dtype=torch.int8, device=dev)
    s = torch.empty((M,), dtype=torch.float32, device=dev)
    _build.call("repro_qmatmul_w8a8_q8", _ARGS_Q8, a_q.data_ptr(),
                wt.data_ptr(), a_scale.data_ptr(), w_scale.data_ptr(),
                bias.data_ptr(), y.data_ptr(), scratch.data_ptr(),
                q.data_ptr(), s.data_ptr(), M, N, K, plan.bm, plan.splits,
                vec, torch.cuda.current_stream(dev).cuda_stream)
    count_launch("qmatmul_w8a8_q8")
    return q, s
