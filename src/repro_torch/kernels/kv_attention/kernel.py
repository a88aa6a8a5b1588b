"""Launch wrapper of the CUDA decode attention kernel (``csrc/kv_attention.cu``).

Replaces ``kv_attention_pallas`` (``repro/kernels/kv_attention/kernel.py``):
single-token online-softmax attention over an int8 cache, a zero K scale
masking its position, GQA by ``h // G``, with the optional V error means
``v_err`` carried through the softmax (the V bias correction, which the JAX
package computes on XLA only). The kernel splits S across CTAs and combines
the splits in the same launch (``csrc/decode_attention.cuh``, the body the
fused decode kernel runs too); ``attention_plan`` picks the split count, and
the private ``_splits`` keyword forces it, to sweep it on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build, attention_plan
from ..dispatch import count_launch

_ARGS = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6 + (ctypes.c_float,)
         + (ctypes.c_int,) * 2 + (ctypes.c_void_p,))
#: the output types the kernels write
OUT_DTYPES = (torch.float32, torch.bfloat16)


def check_tensor(who, name, t, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.device != device:
        raise ValueError(f"{who}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} must be {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def check_attention(who, q, k_q, v_q, out_dtype, v_err, splits):
    """Check q and the cache payloads; return (B, S, Hq, Hkv, hd, the plan,
    the output type)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{who} needs CUDA tensors, got {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16) or q.ndim != 3:
        raise ValueError(f"{who}: q must be float32/bfloat16 [B, Hq, hd], "
                         f"got {q.dtype} {tuple(q.shape)}")
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"{who}: out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    B, S, Hkv, hd = k_q.shape
    Hq = q.shape[1]
    if q.shape[0] != B or q.shape[2] != hd or Hq % Hkv:
        raise ValueError(f"{who}: q {tuple(q.shape)} does not fit the cache "
                         f"{tuple(k_q.shape)}")
    check_tensor(who, "q", q, q.dtype, (B, Hq, hd), dev)
    for name, t in (("k_q", k_q), ("v_q", v_q)):
        check_tensor(who, name, t, torch.int8, (B, S, Hkv, hd), dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{who}: {name} must be 16-byte aligned")
    plan = attention_plan.plan(B, S, Hq, Hkv, hd, v_err is not None,
                               splits=splits)
    return B, S, Hq, Hkv, hd, plan, out_dtype


def kv_attention_cuda(q, k_q, k_s, v_q, v_s,
                      v_err: Optional[torch.Tensor] = None, *,
                      out_dtype: Optional[torch.dtype] = None,
                      _splits: Optional[int] = None) -> torch.Tensor:
    """q [B, Hq, hd] float32 | bfloat16; k_q/v_q [B, S, Hkv, hd] int8;
    k_s/v_s (and ``v_err``) [B, S, Hkv] float32 → [B, Hq, hd] in
    ``out_dtype`` (float32 or bfloat16; q's dtype by default)."""
    who = "kv_attention_cuda"
    B, S, Hq, Hkv, hd, plan, out_dtype = check_attention(
        who, q, k_q, v_q, out_dtype, v_err, _splits)
    named = [("k_s", k_s), ("v_s", v_s)]
    if v_err is not None:
        named.append(("v_err", v_err))
    for name, t in named:
        check_tensor(who, name, t, torch.float32, (B, S, Hkv), q.device)
    out = torch.empty((B, Hq, hd), dtype=out_dtype, device=q.device)
    _build.call("repro_kv_attention", _ARGS, q.data_ptr(), k_q.data_ptr(),
                k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(),
                None if v_err is None else v_err.data_ptr(), out.data_ptr(),
                B, S, Hq, Hkv, hd, plan.splits, 1.0 / (hd ** 0.5),
                int(q.dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16),
                torch.cuda.current_stream(q.device).cuda_stream)
    count_launch("kv_attention")
    return out
