"""Launch wrappers of the CUDA W8A8 GEMM (``csrc/qmatmul_w8a8.cu``).

Replace ``qmatmul_w8a8_pallas`` and, with the quantize-out epilogue,
``qmatmul_w8a8_q8_pallas`` (``repro/kernels/qmatmul_w8a8/kernel.py``); the
quantize-in variant (``qmatmul_w8a8_qin_cuda``) also takes the place of
``quantize_act_pallas`` before it, in the same launch, wherever
``gemm_plan`` folds.
The weight must be stored K-major: ``w_q`` is the [K, N] view of an [N, K]
contiguous buffer (``w_q.t().is_contiguous()``), which is how the port's
``QTensor`` keeps every int8 weight — so the kernel reads each output
column's K bytes contiguously and no copy is made per call. The split of K
across CTAs comes from ``gemm_plan`` (shared with the W8A16 wrapper); the
private ``_splits`` keyword forces it, to sweep the reduction on the card.
The quantize-out variant's route (``GemmPlan.q8_route``) comes from
``gemm_plan.q8_plan`` and the card's residency, read once per kernel
instantiation (``q8_residency``); ``qmatmul_w8a8_q8_plan`` gives the plan a
call launches, and the private ``_route`` keyword forces a route.

The epilogue-free variant (``qmatmul_w8a8_i32_cuda``, its own launch
counter) writes the int32 accumulator and reads no scale or bias: a
row-parallel shard's partial sums, added over the ranks in int32 before the
scale epilogue (``ref.w8a8_epilogue``).

Expert-batched (the MoE block's projections): the GEMM and its quantize-in
variant take every operand with a leading expert axis — a_q or x
[E, M, K], w_q [E, K, N] (each expert's K-major), a_scale [E, M],
w_scale and bias [E, N] → [E, M, N] — in ONE launch, the expert index in
the grid (``gemm_plan.plan(..., experts=E)``); the quantize-out variant
takes no expert axis.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from .. import _build, gemm_plan
from ..dispatch import count_launch, stream_scratch

_ARGS = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,))
_ARGS_Q8 = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 10
            + (ctypes.c_void_p,))
_ARGS_QIN = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 10
             + (ctypes.c_void_p,))


#: the C interface's output kinds of repro_qmatmul_w8a8 (out_kind)
OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
#: the C interface's ids of gemm_plan.Q8_ROUTES (q8_epilogue.cuh: Route)
Q8_ROUTE_IDS = {"resident": 1, "workspace": 2}
# {(device, C function, bm, splits, ...): resident clusters}
_RESIDENCY: Dict[tuple, int] = {}


def q8_residency(fn: str, bm: int, splits: int, device: torch.device,
                 *extra: int) -> int:
    """The clusters of ``splits`` CTAs (CTAs at ``splits == 1``) of a
    quantize-out GEMM's kernels at tile ``bm`` (the fewer of its two
    routes') the card keeps resident at once, read from the card through
    ``fn`` (``fn(bm, splits, *extra, int* out)``) once per instantiation."""
    key = (device.index, fn, bm, splits) + extra
    n = _RESIDENCY.get(key)
    if n is None:
        out = ctypes.c_int(0)
        _build.call(fn, (ctypes.c_int,) * (2 + len(extra)) + (ctypes.c_void_p,),
                    bm, splits, *extra, ctypes.addressof(out))
        n = _RESIDENCY[key] = out.value
    return n


def q8_plan_with(fn: str, M: int, N: int, K: int, device: torch.device,
                 *extra: int, splits: Optional[int] = None,
                 route: Optional[str] = None,
                 wider: bool = True) -> gemm_plan.GemmPlan:
    """The plan of a quantize-out call (``gemm_plan.q8_plan``), with the
    card's residency of the kernel behind ``fn`` (``q8_residency``)."""
    return gemm_plan.q8_plan(
        M, N, K, lambda bm, s: q8_residency(fn, bm, s, device, *extra),
        splits=splits, route=route, wider=wider)


def q8_operands(p: gemm_plan.GemmPlan, device: torch.device):
    """The quantize-out epilogue's operands besides the GEMM's own
    (``csrc/q8_epilogue.cuh``): the float32 y workspace [M, N] on the
    workspace route (None on the resident route), and the stream's uint32
    scratch of the rows' max, the M tiles' counters and the ticket and
    departure counters, [M + m_tiles + 2]."""
    y = (torch.empty((p.M, p.N), dtype=torch.float32, device=device)
         if p.q8_route == "workspace" else None)
    return y, stream_scratch(p.M + p.m_tiles + 2, device)


def q8_qmax(bits: int, who: str) -> int:
    """qmax = 2^(bits-1) - 1 for ``bits`` from 1 to 8 (the payload is
    int8), as the Pallas functions' ``bits``."""
    if not 1 <= bits <= 8:
        raise ValueError(f"{who} writes int8: bits must lie in [1, 8], got "
                         f"{bits}")
    return 2 ** (bits - 1) - 1


def _checked(a, w_q, a_scale, w_scale, bias, who, a_dtypes=(torch.int8,),
             experts=False):
    """Check the operands (``a_scale`` None for the quantize-in variant,
    whose ``a`` is float; ``experts``: each with a leading expert axis);
    return (a contiguous, the [N, K] weight, vec)."""
    tensors = {"a": a, "w_q": w_q, "a_scale": a_scale,
               "w_scale": w_scale, "bias": bias}
    for name, t in tensors.items():
        if t is not None and (t.device.type != "cuda" or t.device != a.device):
            raise ValueError(f"{who}: {name} is on {t.device}, expected "
                             f"{a.device}")
    lead = tuple(a.shape[:1]) if experts else ()
    nd = 3 if experts else 2
    if a.dtype not in a_dtypes or w_q.dtype != torch.int8 or a.ndim != nd \
            or w_q.ndim != nd or a.shape[-1] != w_q.shape[-2] \
            or tuple(w_q.shape[:-2]) != lead:
        e = "E, " if experts else ""
        raise ValueError(f"{who}: want a [{e}M, K] of {a_dtypes} and int8 w "
                         f"[{e}K, N], got {tuple(a.shape)} {a.dtype} and "
                         f"{tuple(w_q.shape)} {w_q.dtype}")
    M, K = a.shape[-2:]
    N = w_q.shape[-1]
    wt = w_q.transpose(-1, -2)
    if not wt.is_contiguous():
        raise ValueError(f"{who}: w_q must be the [K, N] view of a "
                         f"contiguous [N, K] buffer (QTensor's K-major "
                         f"layout)")
    for name, t, n in (("a_scale", a_scale, M), ("w_scale", w_scale, N),
                       ("bias", bias, N)):
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != lead + (n,) \
                or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous float32 "
                             f"{list(lead) + [n]}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    a = a.contiguous()
    vec = int(K % 16 == 0 and a.data_ptr() % 16 == 0
              and wt.data_ptr() % 16 == 0)
    return a, wt, vec


def qmatmul_w8a8_cuda(a_q: torch.Tensor, w_q: torch.Tensor,
                      a_scale: torch.Tensor, w_scale: torch.Tensor,
                      bias: torch.Tensor, *, out_dtype=torch.float32,
                      _splits: Optional[int] = None):
    """a_q [M, K] int8, w_q [K, N] int8 (K-major), a_scale [M], w_scale [N],
    bias [N] float32, all on the card → [M, N] ``out_dtype``; or E experts'
    in one launch, each operand with a leading expert axis."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"qmatmul_w8a8_cuda: out_dtype {out_dtype} not "
                         f"supported (float32 | bfloat16)")
    experts = a_q.ndim == 3
    a_q, wt, vec = _checked(a_q, w_q, a_scale, w_scale, bias,
                            "qmatmul_w8a8_cuda", experts=experts)
    E = a_q.shape[0] if experts else 1
    M, K = a_q.shape[-2:]
    N = wt.shape[-2]
    dev = a_q.device
    plan = gemm_plan.plan(M, N, K, splits=_splits, experts=E)
    out = torch.empty(a_q.shape[:-1] + (N,), dtype=out_dtype, device=dev)
    _build.call("repro_qmatmul_w8a8", _ARGS, a_q.data_ptr(), wt.data_ptr(),
                a_scale.data_ptr(), w_scale.data_ptr(), bias.data_ptr(),
                out.data_ptr(), M, N, K, E, plan.bm, plan.splits,
                OUT_KINDS[out_dtype], vec,
                torch.cuda.current_stream(dev).cuda_stream)
    count_launch("qmatmul_w8a8")
    return out


def qmatmul_w8a8_i32_cuda(a_q: torch.Tensor, w_q: torch.Tensor, *,
                          _splits: Optional[int] = None):
    """The epilogue-free variant: a_q [M, K] int8, w_q [K, N] int8
    (K-major), on the card → the exact int32 accumulator [M, N] (the same
    mainloop and split as ``qmatmul_w8a8_cuda``; no scale, no bias)."""
    a_q, wt, vec = _checked(a_q, w_q, None, None, None,
                            "qmatmul_w8a8_i32_cuda")
    M, K = a_q.shape
    N = wt.shape[0]
    dev = a_q.device
    plan = gemm_plan.plan(M, N, K, splits=_splits)
    out = torch.empty((M, N), dtype=torch.int32, device=dev)
    _build.call("repro_qmatmul_w8a8", _ARGS, a_q.data_ptr(), wt.data_ptr(),
                None, None, None, out.data_ptr(), M, N, K, 1, plan.bm,
                plan.splits, OUT_KINDS[torch.int32], vec,
                torch.cuda.current_stream(dev).cuda_stream)
    count_launch("qmatmul_w8a8_i32")
    return out


def qmatmul_w8a8_q8_plan(M: int, N: int, K: int,
                         device: Optional[torch.device] = None, *,
                         splits: Optional[int] = None,
                         route: Optional[str] = None) -> gemm_plan.GemmPlan:
    """The plan ``qmatmul_w8a8_q8_cuda`` launches at [M, K] x [K, N] on the
    card (the current one by default), its ``q8_route`` included."""
    device = device or torch.device("cuda", torch.cuda.current_device())
    return q8_plan_with("repro_qmatmul_w8a8_q8_residency", M, N, K, device,
                        splits=splits, route=route)


def qmatmul_w8a8_q8_cuda(a_q: torch.Tensor, w_q: torch.Tensor,
                         a_scale: torch.Tensor, w_scale: torch.Tensor,
                         bias: torch.Tensor, *, bits: int = 8,
                         _splits: Optional[int] = None,
                         _route: Optional[str] = None):
    """The GEMM with the quantize-out epilogue, in one launch: operands as
    ``qmatmul_w8a8_cuda`` → (q int8 [M, N], scale float32 [M]), the float32
    result quantized per row by the ``quantize_act`` formula at ``bits``
    (1 to 8: scale = max(amax, 1e-8) / qmax, clip [-qmax - 1, qmax])."""
    qmax = q8_qmax(bits, "qmatmul_w8a8_q8_cuda")
    a_q, wt, vec = _checked(a_q, w_q, a_scale, w_scale, bias,
                            "qmatmul_w8a8_q8_cuda")
    M, K = a_q.shape
    N = wt.shape[0]
    dev = a_q.device
    plan = qmatmul_w8a8_q8_plan(M, N, K, dev, splits=_splits, route=_route)
    y, scratch = q8_operands(plan, dev)
    q = torch.empty((M, N), dtype=torch.int8, device=dev)
    s = torch.empty((M,), dtype=torch.float32, device=dev)
    _build.call("repro_qmatmul_w8a8_q8", _ARGS_Q8, a_q.data_ptr(),
                wt.data_ptr(), a_scale.data_ptr(), w_scale.data_ptr(),
                bias.data_ptr(), None if y is None else y.data_ptr(),
                scratch.data_ptr(), q.data_ptr(), s.data_ptr(), M, N, K,
                plan.bm, plan.splits, Q8_ROUTE_IDS[plan.q8_route],
                plan.q8_waiters, qmax, int(plan.q8_ticketed), vec,
                torch.cuda.current_stream(dev).cuda_stream)
    count_launch("qmatmul_w8a8_q8")
    return q, s


def qmatmul_w8a8_qin_cuda(x: torch.Tensor, w_q: torch.Tensor,
                          w_scale: torch.Tensor, bias: torch.Tensor, *,
                          out_dtype=torch.float32, quantized: bool = False,
                          _splits: Optional[int] = None):
    """The GEMM quantizing its own activation, in one launch: x [M, K]
    float32 | bfloat16, the other operands as ``qmatmul_w8a8_cuda`` →
    [M, N] ``out_dtype``, bit-equal to ``quantize_act_cuda(x)`` followed by
    ``qmatmul_w8a8_cuda``; ``quantized=True`` returns (y, x_q int8 [M, K],
    x_scale float32 [M]), the launch also writing out the quantized
    activation (``quantize_act_cuda(x)``'s) for other GEMMs that read x.
    E experts' in one launch: every operand with a leading expert axis (x
    [E, M, K] → y [E, M, N], x_q [E, M, K], x_scale [E, M]).
    Raises where the plan does not fold (``gemm_plan.GemmPlan.fold``): a
    tile other than the decode tile (M > 16), or an int8 slice of x over
    the kernel's shared memory."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"qmatmul_w8a8_qin_cuda: out_dtype {out_dtype} not "
                         f"supported (float32 | bfloat16)")
    experts = x.ndim == 3
    x, wt, vec = _checked(x, w_q, None, w_scale, bias, "qmatmul_w8a8_qin_cuda",
                          (torch.float32, torch.bfloat16), experts)
    E = x.shape[0] if experts else 1
    M, K = x.shape[-2:]
    N = wt.shape[-2]
    plan = gemm_plan.plan(M, N, K, splits=_splits, experts=E)
    if plan.bm not in gemm_plan.FOLD_BM:
        raise ValueError(f"qmatmul_w8a8_qin_cuda: M={M} takes {plan.bm}-row "
                         f"tiles; the GEMM quantizes its own activation only "
                         f"at the decode tile (M <= 16): quantize_act, then "
                         f"qmatmul_w8a8")
    if not plan.qin_fits:
        raise ValueError(f"qmatmul_w8a8_qin_cuda: M={M} N={N} K={K} in "
                         f"{plan.splits} split(s) needs {plan.qin_smem} bytes "
                         f"of shared memory, more than "
                         f"{gemm_plan.QIN_SMEM_MAX}: quantize_act, then "
                         f"qmatmul_w8a8")
    lead = x.shape[:-1]
    out = torch.empty(lead + (N,), dtype=out_dtype, device=x.device)
    a_q = a_s = None
    if quantized:
        a_q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        a_s = torch.empty(lead, dtype=torch.float32, device=x.device)
        vec &= int(a_q.data_ptr() % 16 == 0)
    _build.call("repro_qmatmul_w8a8_qin", _ARGS_QIN, x.data_ptr(),
                wt.data_ptr(), w_scale.data_ptr(), bias.data_ptr(),
                out.data_ptr(), None if a_q is None else a_q.data_ptr(),
                None if a_s is None else a_s.data_ptr(), M, N, K, E, plan.bm,
                plan.splits, plan.share, int(x.dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16), vec,
                torch.cuda.current_stream(x.device).cuda_stream)
    count_launch("qmatmul_w8a8_qin")
    return (out, a_q, a_s) if quantized else out
