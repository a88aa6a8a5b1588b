"""Plain PyTorch version of the fused decode step: the stepwise composition.

As in ``repro/kernels/fused_decode/ref.py``: append-quantize the new token
(in place here) → zero-scale masking from ``valid`` (the stored scales stay
unmasked) → the blocked online-softmax oracle → optionally ``quantize_act``
of the output row flattened to [Hq·hd].
"""
from __future__ import annotations

import torch

from ..kv_attention.ops import append_quantize
from ..kv_attention.ref import kv_attention_ref
from ..quantize_act.ref import quantize_act_ref


def fused_decode_ref(q, cache_k, cache_ks, cache_v, cache_vs, k_new, v_new,
                     idx, *, valid=None, out_dtype=torch.float32, blk=512,
                     quantize_out=False):
    ck, ks, cv, vs = append_quantize(cache_k, cache_ks, cache_v, cache_vs,
                                     k_new, v_new, idx)
    ks_eff, vs_eff = ks, vs
    if valid is not None:
        live = valid[..., None].to(torch.bool)
        ks_eff = torch.where(live, ks, torch.zeros_like(ks))
        vs_eff = torch.where(live, vs, torch.zeros_like(vs))
    out = kv_attention_ref(q, ck, ks_eff, cv, vs_eff, out_dtype, blk=blk)
    updated = (ck, ks, cv, vs)
    if quantize_out:
        B = out.shape[0]
        oq, os_ = quantize_act_ref(out.float().reshape(B, -1))
        return (out, oq, os_), updated
    return out, updated
