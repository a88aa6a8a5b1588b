"""Launch wrapper of the CUDA fused decode kernel (``csrc/fused_decode.cu``).

Replaces ``fused_decode_pallas`` (``repro/kernels/fused_decode/kernel.py``):
append-quantize the new token's K/V into ring slot ``idx[b]`` of the cache
IN PLACE, online-softmax attention over the updated cache (the split-S
kernel of ``kv_attention``, ``csrc/decode_attention.cuh``, with the same
``attention_plan``), optional quantize-out of the output row. The cache
tensors are the pool's own; the kernel writes them directly (the Pallas
kernel aliases them instead).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from ..dispatch import count_launch, stream_scratch
from ..kv_attention.kernel import check_attention, check_tensor

_ARGS = ((ctypes.c_void_p,) * 13 + (ctypes.c_int,) * 6 + (ctypes.c_float,)
         + (ctypes.c_int,) * 2 + (ctypes.c_void_p,))


def fused_decode_cuda(q, k_q, k_s, v_q, v_s, k_new, v_new, idx, valid, *,
                      quantize_out: bool = False,
                      out_dtype: Optional[torch.dtype] = None,
                      _splits: Optional[int] = None):
    """q [B, Hq, hd] float32 | bfloat16; k_q/v_q [B, S, Hkv, hd] int8 and
    k_s/v_s [B, S, Hkv] float32 (updated in place); k_new/v_new [B, Hkv, hd]
    in q's dtype; idx [B] int32; valid [B, S] bool.

    Returns ``out`` [B, Hq, hd] in ``out_dtype`` (float32 or bfloat16; q's
    dtype by default), or ``(out, out_q [B, Hq·hd] int8, out_scale [B]
    float32)`` with ``quantize_out``.
    """
    who = "fused_decode_cuda"
    B, S, Hq, Hkv, hd, plan, out_dtype = check_attention(
        who, q, k_q, v_q, out_dtype, None, _splits)
    dev = q.device
    for name, t in (("k_s", k_s), ("v_s", v_s)):
        check_tensor(who, name, t, torch.float32, (B, S, Hkv), dev)
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        check_tensor(who, name, t, q.dtype, (B, Hkv, hd), dev)
    check_tensor(who, "idx", idx, torch.int32, (B,), dev)
    check_tensor(who, "valid", valid, torch.bool, (B, S), dev)
    if valid.data_ptr() % 4:       # the kernel stages it in 4-byte words
        valid = valid.clone()
    out = torch.empty((B, Hq, hd), dtype=out_dtype, device=dev)
    oq = os_ = scratch = None
    if quantize_out:
        oq = torch.empty((B, Hq * hd), dtype=torch.int8, device=dev)
        os_ = torch.empty((B,), dtype=torch.float32, device=dev)
        scratch = stream_scratch(2 * B, dev)   # per row: max |out|, heads done
    _build.call("repro_fused_decode", _ARGS, q.data_ptr(), k_q.data_ptr(),
                k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(),
                k_new.data_ptr(), v_new.data_ptr(), idx.data_ptr(),
                valid.data_ptr(), out.data_ptr(),
                *(None if t is None else t.data_ptr()
                  for t in (oq, os_, scratch)),
                B, S, Hq, Hkv, hd, plan.splits, 1.0 / (hd ** 0.5),
                int(q.dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16),
                torch.cuda.current_stream(dev).cuda_stream)
    count_launch("fused_decode")
    if quantize_out:
        return out, oq, os_
    return out
