"""Public fused decode op: one launch from roped q/k/v to attention out.

On a CUDA tensor it runs the hand-written kernel; on a CPU tensor the plain
composition (``ref.py``). Decode always goes through this op — the port has
no fusion switch. The V bias correction (``cache_verr``) of the JAX op is not
ported yet.
"""
from __future__ import annotations

import torch

from ..dispatch import register_impl, resolve
from .kernel import fused_decode_cuda
from .ref import fused_decode_ref


@register_impl("fused_decode", "cuda", pad="zero-scale")
def _fd_cuda(q, ck, cks, cv, cvs, k_new, v_new, idx, *, valid, out_dtype,
             quantize_out):
    # the kernel tiles S by 64 itself; positions past S are masked like
    # zero-scale padding
    B, S, Hkv, hd = ck.shape
    if out_dtype != q.dtype:
        raise ValueError(f"fused_decode: the kernel writes q's dtype "
                         f"({q.dtype}), got out_dtype={out_dtype}")
    if tuple(idx.shape) != (B, 1):
        raise ValueError(f"fused_decode appends one token per row at a "
                         f"per-slot offset: idx must be ({B}, 1), got "
                         f"{tuple(idx.shape)}")
    vmask = (torch.ones((B, S), dtype=torch.bool, device=q.device)
             if valid is None else torch.broadcast_to(valid, (B, S)))
    res = fused_decode_cuda(
        q.contiguous(), ck, cks, cv, cvs,
        k_new.reshape(B, Hkv, hd).contiguous(),
        v_new.reshape(B, Hkv, hd).contiguous(),
        idx[:, 0].to(torch.int32).contiguous(),
        vmask.to(torch.bool).contiguous(), quantize_out=quantize_out)
    return res, (ck, cks, cv, cvs)


@register_impl("fused_decode", "torch", pad="zero-scale")
def _fd_torch(q, ck, cks, cv, cvs, k_new, v_new, idx, *, valid, out_dtype,
              quantize_out):
    return fused_decode_ref(q, ck, cks, cv, cvs, k_new, v_new, idx,
                            valid=valid, out_dtype=out_dtype,
                            quantize_out=quantize_out)


def fused_decode(q, cache_k, cache_ks, cache_v, cache_vs, k_new, v_new, idx,
                 *, valid=None, out_dtype=torch.float32,
                 quantize_out: bool = False):
    """Fused decode step: append-quantize the new token into the int8 cache
    IN PLACE, attend, and optionally re-quantize the output row for the W8A8
    wo projection.

    q [B, Hq, hd]; cache_k/cache_v [B, S, Hkv, hd] int8, cache_ks/cache_vs
    [B, S, Hkv] float32; k_new/v_new [B, 1, Hkv, hd]; idx [B, 1] per-slot
    ring offsets; ``valid`` [B|1, S] marks live positions
    (including the new token's). Returns ``(out, cache leaves)`` — the
    leaves are the given tensors, updated — where ``out`` is the triple
    ``(out, out_q [B, Hq·hd] int8, out_scale [B])`` under ``quantize_out``.
    """
    return resolve("fused_decode", q)(
        q, cache_k, cache_ks, cache_v, cache_vs, k_new, v_new, idx,
        valid=valid, out_dtype=out_dtype, quantize_out=quantize_out)
