"""Launch wrapper of the CUDA quantize_act kernel (``csrc/quantize_act.cu``).

Replaces ``quantize_act_pallas`` (``repro/kernels/quantize_act/kernel.py``):
a warp a row, read once into registers, absmax by warp shuffles, then IEEE
divide and round half to even — bit-equal to ``ref.quantize_act_ref`` at
any ``bits`` from 1 to 8 (the clip at [-qmax - 1, qmax], qmax =
2^(bits-1) - 1, as the Pallas kernel). Where ``gemm_plan`` folds, the W8A8
GEMM quantizes its activation itself (``qmatmul_w8a8_qin_cuda``) and this
kernel is not launched.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..dispatch import count_launch

_ARGS = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,))


def quantize_act_cuda(x: torch.Tensor, bits: int = 8):
    """x [M, K] float32 | bfloat16 on the card → (q int8 [M, K], scale
    float32 [M]); ``bits`` from 1 to 8 (the payload is int8)."""
    if x.device.type != "cuda":
        raise ValueError(f"quantize_act_cuda needs a CUDA tensor, got {x.device}")
    if x.ndim != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quantize_act_cuda takes [M, K] float32/bfloat16, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if not 1 <= bits <= 8:
        raise ValueError(f"quantize_act_cuda writes int8: bits must lie in "
                         f"[1, 8], got {bits}")
    x = x.contiguous()
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    s = torch.empty((M,), dtype=torch.float32, device=x.device)
    vec = int(K * x.element_size() % 16 == 0 and x.data_ptr() % 16 == 0
              and q.data_ptr() % 16 == 0)
    _build.call("repro_quantize_act", _ARGS, x.data_ptr(), q.data_ptr(),
                s.data_ptr(), M, K, 2 ** (bits - 1) - 1,
                int(x.dtype == torch.bfloat16), vec,
                torch.cuda.current_stream(x.device).cuda_stream)
    count_launch("quantize_act")
    return q, s
