"""Launch wrapper of the CUDA fused decode kernel (``csrc/fused_decode.cu``).

Replaces ``fused_decode_pallas`` (``repro/kernels/fused_decode/kernel.py``):
append-quantize the new token's K/V into ring slot ``idx[b]`` of the cache
IN PLACE, online-softmax attention over the updated cache (the attention
body of the ``kv_attention`` kernel, ``csrc/decode_attention.cuh``),
optional quantize-out of the output row. The cache tensors are the pool's
own; the kernel writes them directly (the Pallas kernel aliases them
instead).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..dispatch import count_launch
from ..kv_attention.kernel import check_smem, check_tensor

_ARGS = ((ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 5 + (ctypes.c_float,)
         + (ctypes.c_int,) * 2 + (ctypes.c_void_p,))


def fused_decode_cuda(q, k_q, k_s, v_q, v_s, k_new, v_new, idx, valid, *,
                      quantize_out: bool = False):
    """q [B, Hq, hd] float32 | bfloat16; k_q/v_q [B, S, Hkv, hd] int8 and
    k_s/v_s [B, S, Hkv] float32 (updated in place); k_new/v_new [B, Hkv, hd]
    in q's dtype; idx [B] int32; valid [B, S] bool.

    Returns ``out`` [B, Hq, hd] in q's dtype, or ``(out, out_q [B, Hq·hd]
    int8, out_scale [B] float32)`` with ``quantize_out``.
    """
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"fused_decode_cuda needs CUDA tensors, got {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16) or q.ndim != 3:
        raise ValueError(f"fused_decode_cuda: q must be float32/bfloat16 "
                         f"[B, Hq, hd], got {q.dtype} {tuple(q.shape)}")
    B, S, Hkv, hd = k_q.shape
    Hq = q.shape[1]
    if q.shape[0] != B or q.shape[2] != hd or Hq % Hkv:
        raise ValueError(f"fused_decode_cuda: q {tuple(q.shape)} does not "
                         f"fit the cache {tuple(k_q.shape)}")
    who = "fused_decode_cuda"
    check_tensor(who, "q", q, q.dtype, (B, Hq, hd), dev)
    for name, t in (("k_q", k_q), ("v_q", v_q)):
        check_tensor(who, name, t, torch.int8, (B, S, Hkv, hd), dev)
        if t.data_ptr() % 16:
            raise ValueError(f"fused_decode_cuda: {name} must be 16-byte "
                             f"aligned")
    for name, t in (("k_s", k_s), ("v_s", v_s)):
        check_tensor(who, name, t, torch.float32, (B, S, Hkv), dev)
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        check_tensor(who, name, t, q.dtype, (B, Hkv, hd), dev)
    check_tensor(who, "idx", idx, torch.int32, (B,), dev)
    check_tensor(who, "valid", valid, torch.bool, (B, S), dev)
    check_smem(who, Hq, Hkv, hd, False)
    out = torch.empty((B, Hq, hd), dtype=q.dtype, device=dev)
    oq = torch.empty((B, Hq * hd) if quantize_out else (1,),
                     dtype=torch.int8, device=dev)
    os_ = torch.empty((B,) if quantize_out else (1,), dtype=torch.float32,
                      device=dev)
    _build.call("repro_fused_decode", _ARGS, q.data_ptr(), k_q.data_ptr(),
                k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(),
                k_new.data_ptr(), v_new.data_ptr(), idx.data_ptr(),
                valid.data_ptr(), out.data_ptr(), oq.data_ptr(),
                os_.data_ptr(), B, S, Hq, Hkv, hd, 1.0 / (hd ** 0.5),
                int(quantize_out), int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream(dev).cuda_stream)
    count_launch("fused_decode")
    if quantize_out:
        return out, oq, os_
    return out
