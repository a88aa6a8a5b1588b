"""int8 KV-cache quantization and the in-place append.

The one truth for the serving KV scheme, as in
``repro/kernels/kv_attention/ops.py``: symmetric per-token, per-head absmax
int8 with float32 scales, where scale 0 is reserved as the "position
invalid" marker the attention masking keys on. ``kv_attention_pallas`` (the
unfused decode attention kernel) is not ported yet; the serving path always
takes the fused decode kernel.
"""
from __future__ import annotations

import torch


def quantize_kv(t: torch.Tensor):
    """[..., hd] → (int8 payload, float32 scale over the last axis). The
    floor 1e-8/127 keeps real tokens off scale 0."""
    tf = t.float()
    amax = tf.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, 1e-8) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def append_quantize(cache_k, cache_ks, cache_v, cache_vs, k_new, v_new, idx):
    """Quantize the new tokens' K/V once and write them into the int8 cache
    IN PLACE (the JAX op returns updated copies).

    k_new/v_new [B, T, Hkv, hd]; idx [B, T] per-slot ring offsets or [T]
    shared ones. Returns the (same, updated) cache tensors.
    """
    k_q, k_s = quantize_kv(k_new)
    v_q, v_s = quantize_kv(v_new)
    if idx.ndim == 2:                                  # per-slot [B, T]
        row = torch.arange(k_new.shape[0], device=idx.device)[:, None]
        where = (row, idx)
    else:                                              # shared ring offsets
        where = (slice(None), idx)
    cache_k[where] = k_q
    cache_ks[where] = k_s
    cache_v[where] = v_q
    cache_vs[where] = v_s
    return cache_k, cache_ks, cache_v, cache_vs
