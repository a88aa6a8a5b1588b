"""Public fused decode op: one launch from roped q/k/v to attention out.

On a CUDA tensor it runs the hand-written kernel; on a CPU tensor the plain
composition (``ref.py``). As in the JAX package:

  * ``fusion_enabled()`` reads ``REPRO_FUSED_DECODE`` (default on) at call
    time; ``0`` / ``false`` / ``off`` route the model's decode through the
    stepwise ops (``kv_attention_decode``, then ``quantize_act`` for a W8A8
    ``wo``) instead of this op. The flag picks a route, never a tier.
  * With ``cache_verr`` (the V bias correction) the op always takes the
    stepwise composition ``_compose``: append-quantize, then the
    ``kv_attention`` kernel, which carries ``v_err``; the fused kernel does
    not.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from ..dispatch import register_impl, register_spec, resolve
from ..kv_attention.ops import _decode_spec_args, kv_attention_decode
from ..quantize_act.ops import quantize_act
from .kernel import fused_decode_cuda
from .ref import fused_decode_ref


def fusion_enabled() -> bool:
    """The ``REPRO_FUSED_DECODE`` routing flag (default: on), read at call
    time."""
    return os.environ.get("REPRO_FUSED_DECODE", "1").lower() not in (
        "0", "false", "off")


def _compose(q, ck, cks, cv, cvs, k_new, v_new, idx, *, valid, out_dtype,
             blk, quantize_out, cache_verr=None, backend=None):
    """The stepwise composition: ``kv_attention_decode`` (+ ``quantize_act``
    of the output row under ``quantize_out``)."""
    out, updated = kv_attention_decode(
        q, ck, cks, cv, cvs, k_new, v_new, idx, valid=valid,
        out_dtype=out_dtype, blk=blk, cache_verr=cache_verr, backend=backend)
    if quantize_out:
        oq, os_ = quantize_act(out.reshape(out.shape[0], -1), backend=backend)
        return (out, oq, os_), updated
    return out, updated


@register_impl("fused_decode", "cuda", pad="zero-scale")
def _fd_cuda(q, ck, cks, cv, cvs, k_new, v_new, idx, *, valid, out_dtype,
             blk, quantize_out):
    # the kernel tiles S by 64 itself; positions past S are masked like
    # zero-scale padding
    B, S, Hkv, hd = ck.shape
    if tuple(idx.shape) == (B, 1):                     # per-slot offsets
        idx_b = idx[:, 0]
    elif idx.ndim == 1 and idx.numel() == 1:           # one shared offset
        idx_b = idx.expand(B)
    else:
        raise ValueError(f"fused_decode appends one token per row: idx must "
                         f"be ({B}, 1) per-slot or (1,) shared, got "
                         f"{tuple(idx.shape)}")
    vmask = (torch.ones((B, S), dtype=torch.bool, device=q.device)
             if valid is None else torch.broadcast_to(valid, (B, S)))
    res = fused_decode_cuda(
        q.contiguous(), ck, cks, cv, cvs,
        k_new.reshape(B, Hkv, hd).contiguous(),
        v_new.reshape(B, Hkv, hd).contiguous(),
        idx_b.to(torch.int32).contiguous(),
        vmask.to(torch.bool).contiguous(), quantize_out=quantize_out,
        out_dtype=out_dtype)
    return res, (ck, cks, cv, cvs)


@register_impl("fused_decode", "torch", pad="zero-scale")
def _fd_torch(q, ck, cks, cv, cvs, k_new, v_new, idx, *, valid, out_dtype,
              blk, quantize_out):
    return fused_decode_ref(q, ck, cks, cv, cvs, k_new, v_new, idx,
                            valid=valid, out_dtype=out_dtype, blk=blk,
                            quantize_out=quantize_out)


def fused_decode(q, cache_k, cache_ks, cache_v, cache_vs, k_new, v_new, idx,
                 *, valid=None, out_dtype=torch.float32, blk: int = 512,
                 cache_verr=None, quantize_out: bool = False,
                 backend: Optional[str] = None):
    """Fused decode step: append-quantize the new token into the int8 cache
    IN PLACE, attend, and optionally re-quantize the output row for the W8A8
    wo projection.

    q [B, Hq, hd]; cache_k/cache_v [B, S, Hkv, hd] int8, cache_ks/cache_vs
    (and ``cache_verr``) [B, S, Hkv] float32; k_new/v_new [B, 1, Hkv, hd];
    idx [B, 1] per-slot ring offsets or [1] one shared offset; ``valid`` [B|1, S] marks live
    positions (including the new token's). Returns ``(out, cache leaves)``
    — the leaves are the given tensors, updated — where ``out`` is the
    triple ``(out, out_q [B, Hq·hd] int8, out_scale [B])`` under
    ``quantize_out``. ``cache_verr`` routes to the stepwise composition.
    """
    if cache_verr is not None:
        return _compose(q, cache_k, cache_ks, cache_v, cache_vs, k_new,
                        v_new, idx, valid=valid, out_dtype=out_dtype, blk=blk,
                        quantize_out=quantize_out, cache_verr=cache_verr,
                        backend=backend)
    return resolve("fused_decode", q, backend)(
        q, cache_k, cache_ks, cache_v, cache_vs, k_new, v_new, idx,
        valid=valid, out_dtype=out_dtype, blk=blk, quantize_out=quantize_out)


@register_spec("fused_decode")
def _spec(*, device, head_dim: int = 16, n_kv_heads: int = 2,
          n_q_heads: int = 4, seq: int = 32, batch: int = 2, **_):
    return (fused_decode,
            _decode_spec_args(device, batch, seq, n_q_heads, n_kv_heads,
                              head_dim),
            {"valid": torch.ones((batch, seq), dtype=torch.bool,
                                 device=device),
             "quantize_out": True})
