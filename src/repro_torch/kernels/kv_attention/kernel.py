"""Launch wrapper of the CUDA decode attention kernel (``csrc/kv_attention.cu``).

Replaces ``kv_attention_pallas`` (``repro/kernels/kv_attention/kernel.py``):
single-token online-softmax attention over an int8 cache, a zero K scale
masking its position, GQA by ``h // G``, with the optional V error means
``v_err`` carried through the softmax (the V bias correction, which the JAX
package computes on XLA only). The attention body is the one the fused
decode kernel runs (``csrc/decode_attention.cuh``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build
from ..dispatch import count_launch

_ARGS = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5 + (ctypes.c_float,)
         + (ctypes.c_int,) + (ctypes.c_void_p,))
#: dynamic shared memory a block may use on the H100
MAX_SMEM = 227 * 1024


@functools.lru_cache(maxsize=None)
def _smem_bytes(Hq: int, Hkv: int, hd: int, with_err: bool) -> int:
    return _build.function("repro_decode_attention_smem", (ctypes.c_int,) * 4,
                           ctypes.c_longlong)(Hq, Hkv, hd, int(with_err))


def check_smem(who: str, Hq: int, Hkv: int, hd: int, with_err: bool) -> None:
    """Raise before a launch the attention body's shared memory refuses:
    it holds q, acc and a score tile per head and two int8 tiles of 64
    positions, which outgrow the card's 227 KB at large Hq·hd or Hkv·hd."""
    need = _smem_bytes(Hq, Hkv, hd, with_err)
    if need > MAX_SMEM:
        raise ValueError(
            f"{who}: Hq={Hq} Hkv={Hkv} hd={hd} needs {need} bytes of shared "
            f"memory per block, more than the {MAX_SMEM} an H100 block may use")


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


def kv_attention_cuda(q, k_q, k_s, v_q, v_s,
                      v_err: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, Hq, hd] float32 | bfloat16; k_q/v_q [B, S, Hkv, hd] int8;
    k_s/v_s (and ``v_err``) [B, S, Hkv] float32 → [B, Hq, hd] in q's dtype."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"kv_attention_cuda needs CUDA tensors, got {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16) or q.ndim != 3:
        raise ValueError(f"kv_attention_cuda: q must be float32/bfloat16 "
                         f"[B, Hq, hd], got {q.dtype} {tuple(q.shape)}")
    B, S, Hkv, hd = k_q.shape
    Hq = q.shape[1]
    if q.shape[0] != B or q.shape[2] != hd or Hq % Hkv:
        raise ValueError(f"kv_attention_cuda: q {tuple(q.shape)} does not "
                         f"fit the cache {tuple(k_q.shape)}")
    who = "kv_attention_cuda"
    check_tensor(who, "q", q, q.dtype, (B, Hq, hd), dev)
    for name, t in (("k_q", k_q), ("v_q", v_q)):
        check_tensor(who, name, t, torch.int8, (B, S, Hkv, hd), dev)
        if t.data_ptr() % 4:
            raise ValueError(f"kv_attention_cuda: {name} must be 4-byte "
                             f"aligned")
    named = [("k_s", k_s), ("v_s", v_s)]
    if v_err is not None:
        named.append(("v_err", v_err))
    for name, t in named:
        check_tensor(who, name, t, torch.float32, (B, S, Hkv), dev)
    check_smem(who, Hq, Hkv, hd, v_err is not None)
    out = torch.empty((B, Hq, hd), dtype=q.dtype, device=dev)
    _build.call("repro_kv_attention", _ARGS, q.data_ptr(), k_q.data_ptr(),
                k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(),
                None if v_err is None else v_err.data_ptr(), out.data_ptr(),
                B, S, Hq, Hkv, hd, 1.0 / (hd ** 0.5),
                int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream(dev).cuda_stream)
    count_launch("kv_attention")
    return out
