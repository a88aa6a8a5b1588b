"""Launch wrappers of the CUDA W8A16 GEMM (``csrc/qmatmul_w8a16.cu``).

Replace ``qmatmul_w8a16_pallas`` and, with the quantize-out epilogue,
``qmatmul_w8a16_q8_pallas`` (``repro/kernels/qmatmul_w8a16/kernel.py``).
The weight must be stored K-major, as the port's ``QTensor`` keeps every
int8 weight: ``w_q`` is the [K, N] view of an [N, K] contiguous buffer. The
scale is read through a pointer and a stride (0 for a per-tensor ``[1]``
scale) and the bias through a nullable pointer, each float32 or bfloat16 as
the caller holds it, so a call allocates nothing but its output. The split
of K across CTAs comes from ``gemm_plan`` (shared with the W8A8 wrapper);
the private ``_splits`` keyword forces it, to sweep the reduction on the
card. The quantize-out variant takes its route as the W8A8 one does
(``qmatmul_w8a16_q8_plan``; the private ``_route`` forces a route), always
at the plain GEMM's tile and splits.

Expert-batched (the MoE block's projections): a [E, M, K], w_q [E, K, N]
(each expert's K-major), w_scale [E, N] or [E, 1], bias [E, N] → [E, M, N]
in ONE launch, expert index in the grid (``gemm_plan.plan(...,
experts=E)``); the quantize-out variant takes no expert axis.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build, gemm_plan
from ..dispatch import count_launch
from ..qmatmul_w8a8.kernel import (
    Q8_ROUTE_IDS,
    q8_operands,
    q8_plan_with,
    q8_qmax,
)

_ARGS = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 2
         + (ctypes.c_void_p,) + (ctypes.c_int,) + (ctypes.c_void_p,)
         + (ctypes.c_int,) * 8 + (ctypes.c_void_p,))
_ARGS_Q8 = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 2
            + (ctypes.c_void_p,) + (ctypes.c_int,) + (ctypes.c_void_p,) * 4
            + (ctypes.c_int,) * 11 + (ctypes.c_void_p,))
_FLOATS = (torch.float32, torch.bfloat16)


def _checked(a, w_q, w_scale, bias, who, experts=False):
    """Check the operands (``experts``: each with a leading expert axis);
    return (a contiguous, the [N, K] weight, vec)."""
    dev = a.device
    named = {"a": a, "w_q": w_q, "w_scale": w_scale}
    if bias is not None:
        named["bias"] = bias
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{who}: {name} is on {t.device}, expected a "
                             f"CUDA device ({dev})")
    lead = a.shape[:1] if experts else ()
    nd = 3 if experts else 2
    if a.dtype not in _FLOATS or w_q.dtype != torch.int8 or a.ndim != nd \
            or w_q.ndim != nd or a.shape[-1] != w_q.shape[-2] \
            or w_q.shape[:-2] != lead:
        e = "E, " if experts else ""
        raise ValueError(f"{who}: want float32/bfloat16 a [{e}M, K] and "
                         f"int8 w [{e}K, N], got {tuple(a.shape)} {a.dtype} "
                         f"and {tuple(w_q.shape)} {w_q.dtype}")
    K, N = w_q.shape[-2:]
    wt = w_q.transpose(-1, -2)
    if not wt.is_contiguous():
        raise ValueError(f"{who}: w_q must be the [K, N] view of a "
                         f"contiguous [N, K] buffer (QTensor's K-major "
                         f"layout)")
    if w_scale.dtype not in _FLOATS or w_scale.shape[:-1] != lead \
            or w_scale.ndim != nd - 1 or w_scale.shape[-1] not in (1, N) \
            or not w_scale.is_contiguous():
        raise ValueError(f"{who}: w_scale must be contiguous "
                         f"float32/bfloat16 {list(lead) + [N]} or "
                         f"{list(lead) + [1]}, got {tuple(w_scale.shape)} "
                         f"{w_scale.dtype}")
    if bias is not None and (bias.dtype not in _FLOATS
                             or tuple(bias.shape) != tuple(lead) + (N,)
                             or not bias.is_contiguous()):
        raise ValueError(f"{who}: bias must be contiguous float32/bfloat16 "
                         f"{list(lead) + [N]}, got {tuple(bias.shape)} "
                         f"{bias.dtype}")
    a = a.contiguous()
    vec = int(K % 16 == 0 and a.data_ptr() % 16 == 0
              and wt.data_ptr() % 16 == 0)
    return a, wt, vec


def _epilogue_args(w_scale, bias, N):
    return (w_scale.data_ptr(), int(w_scale.shape[-1] == N),
            int(w_scale.dtype == torch.bfloat16),
            None if bias is None else bias.data_ptr(),
            int(bias is not None and bias.dtype == torch.bfloat16))


def qmatmul_w8a16_cuda(a: torch.Tensor, w_q: torch.Tensor,
                       w_scale: torch.Tensor,
                       bias: Optional[torch.Tensor] = None, *,
                       _splits: Optional[int] = None) -> torch.Tensor:
    """a [M, K] float32 | bfloat16, w_q [K, N] int8 (K-major), w_scale [N]
    or [1], bias [N] or None (float32 | bfloat16), all on the card → [M, N]
    in a's dtype; or E experts' in one launch, each operand with a leading
    expert axis (a [E, M, K] → [E, M, N])."""
    experts = a.ndim == 3
    a, wt, vec = _checked(a, w_q, w_scale, bias, "qmatmul_w8a16_cuda",
                          experts)
    dev = a.device
    E = a.shape[0] if experts else 1
    M, K = a.shape[-2:]
    N = wt.shape[-2]
    plan = gemm_plan.plan(M, N, K, splits=_splits, experts=E)
    out = torch.empty(a.shape[:-1] + (N,), dtype=a.dtype, device=dev)
    _build.call(
        "repro_qmatmul_w8a16", _ARGS, a.data_ptr(), wt.data_ptr(),
        *_epilogue_args(w_scale, bias, N), out.data_ptr(), M, N, K, E,
        plan.bm, plan.splits, int(a.dtype == torch.bfloat16), vec,
        torch.cuda.current_stream(dev).cuda_stream)
    count_launch("qmatmul_w8a16")
    return out


def qmatmul_w8a16_q8_plan(M: int, N: int, K: int,
                          a_dtype: torch.dtype = torch.bfloat16,
                          device: Optional[torch.device] = None, *,
                          splits: Optional[int] = None,
                          route: Optional[str] = None):
    """The plan ``qmatmul_w8a16_q8_cuda`` launches for a [M, K] of
    ``a_dtype`` x [K, N] on the card (the current one by default), its
    ``q8_route`` included; always ``qmatmul_w8a16_cuda``'s tile and splits,
    so that y has its float32 sums."""
    device = device or torch.device("cuda", torch.cuda.current_device())
    return q8_plan_with("repro_qmatmul_w8a16_q8_residency", M, N, K, device,
                        int(a_dtype == torch.bfloat16), splits=splits,
                        route=route, wider=False)


def qmatmul_w8a16_q8_cuda(a: torch.Tensor, w_q: torch.Tensor,
                          w_scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None, *,
                          bits: int = 8, _splits: Optional[int] = None,
                          _route: Optional[str] = None):
    """The GEMM with the quantize-out epilogue, in one launch: operands as
    ``qmatmul_w8a16_cuda`` → (q int8 [M, N], scale float32 [M]), the float32
    result (never rounded to a's dtype) quantized per row by the
    ``quantize_act`` formula at ``bits`` (1 to 8)."""
    qmax = q8_qmax(bits, "qmatmul_w8a16_q8_cuda")
    a, wt, vec = _checked(a, w_q, w_scale, bias, "qmatmul_w8a16_q8_cuda")
    dev = a.device
    M, K = a.shape
    N = wt.shape[0]
    plan = qmatmul_w8a16_q8_plan(M, N, K, a.dtype, dev, splits=_splits,
                                 route=_route)
    y, scratch = q8_operands(plan, dev)
    q = torch.empty((M, N), dtype=torch.int8, device=dev)
    s = torch.empty((M,), dtype=torch.float32, device=dev)
    _build.call(
        "repro_qmatmul_w8a16_q8", _ARGS_Q8, a.data_ptr(), wt.data_ptr(),
        *_epilogue_args(w_scale, bias, N), None if y is None else y.data_ptr(),
        scratch.data_ptr(), q.data_ptr(), s.data_ptr(), M, N, K, plan.bm,
        plan.splits, Q8_ROUTE_IDS[plan.q8_route], plan.q8_waiters, qmax,
        int(plan.q8_ticketed), int(a.dtype == torch.bfloat16), vec,
        torch.cuda.current_stream(dev).cuda_stream)
    count_launch("qmatmul_w8a16_q8")
    return q, s
