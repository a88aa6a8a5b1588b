"""int8 KV cache: quantize, append, and the decode attention op.

The one truth for the serving KV scheme, as in
``repro/kernels/kv_attention/ops.py``: symmetric per-token, per-head absmax
int8 with float32 scales, where scale 0 is reserved as the "position
invalid" marker the attention masking keys on.

  * ``quantize_kv`` / ``append_quantize`` — the new token's K/V quantized
    once and written into the cache IN PLACE (the JAX op returns updated
    copies), plus the per-token V error mean when the cache carries the V
    bias correction's ``v_err`` leaf.
  * ``kv_attention`` — single-token attention over the int8 cache: the
    CUDA kernel on a CUDA tensor, the blocked online-softmax oracle on a
    CPU tensor; both take the optional ``v_err``.
  * ``kv_attention_decode`` — append, mask by ``valid``, attend: the
    unfused decode route (``REPRO_FUSED_DECODE=0``) and the route of a cache
    with ``v_err``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..dispatch import register_impl, register_spec, resolve
from .kernel import kv_attention_cuda
from .ref import kv_attention_ref

#: XLA's CPU reduction sums a row sequentially in chunks of this many values
_XLA_CHUNK = 32


def quantize_kv(t: torch.Tensor):
    """[..., hd] → (int8 payload, float32 scale over the last axis). The
    floor 1e-8/127 keeps real tokens off scale 0."""
    tf = t.float()
    amax = tf.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, 1e-8) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _mean_last(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis, summed in the order of XLA's CPU reduction
    (sequentially within chunks of 32, then over the chunks), so the V
    error means equal the JAX package's bit for bit: hd + 1 elementwise ops."""
    n = x.shape[-1]
    c = n if n <= _XLA_CHUNK or n % _XLA_CHUNK else _XLA_CHUNK
    xc = x.reshape(*x.shape[:-1], n // c, c)
    part = xc[..., 0]
    for i in range(1, c):
        part = part + xc[..., i]
    total = part[..., 0]
    for j in range(1, n // c):
        total = total + part[..., j]
    return total / torch.full_like(total, n)


def append_quantize(cache_k, cache_ks, cache_v, cache_vs, k_new, v_new, idx,
                    *, cache_verr=None):
    """Quantize the new tokens' K/V once and write them into the int8 cache
    IN PLACE (the JAX op returns updated copies).

    k_new/v_new [B, T, Hkv, hd]; idx [B, T] per-slot ring offsets or [T]
    shared ones. With ``cache_verr`` [B, S, Hkv] the per-token V error mean
    ``mean(v_q · v_s − v_new)`` over hd is written there too. Returns the
    (same, updated) cache tensors, ``cache_verr`` last when given.
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
    if cache_verr is None:
        return cache_k, cache_ks, cache_v, cache_vs
    cache_verr[where] = _mean_last(v_q.float() * v_s[..., None]
                                   - v_new.float())
    return cache_k, cache_ks, cache_v, cache_vs, cache_verr


@register_impl("kv_attention", "cuda", pad="zero-scale")
def _kv_cuda(q, k_q, k_s, v_q, v_s, *, blk, out_dtype, v_err):
    # the kernel tiles S by 64 and masks the tail itself; ``blk`` is the
    # plain version's block
    return kv_attention_cuda(
        q.contiguous(), k_q.contiguous(), k_s.float().contiguous(),
        v_q.contiguous(), v_s.float().contiguous(),
        None if v_err is None else v_err.float().contiguous(),
        out_dtype=out_dtype)


@register_impl("kv_attention", "torch", pad="zero-scale")
def _kv_torch(q, k_q, k_s, v_q, v_s, *, blk, out_dtype, v_err):
    return kv_attention_ref(q, k_q, k_s, v_q, v_s, out_dtype, blk=blk,
                            v_err=v_err)


def kv_attention(q, k_q, k_s, v_q, v_s, *, blk: int = 512,
                 out_dtype=torch.float32,
                 v_err: Optional[torch.Tensor] = None,
                 backend: Optional[str] = None) -> torch.Tensor:
    """Single-token decode attention over an int8 cache.

    q [B, Hq, hd]; k_q/v_q [B, S, Hkv, hd] int8; k_s/v_s [B, S, Hkv], Hq a
    multiple of Hkv (GQA, q head h reads kv head h // G). A position whose K
    scale is 0 is masked; zero the K and V scales of invalid positions
    instead of dequantizing and masking. ``v_err`` [B, S, Hkv] subtracts the
    softmax-weighted V error means (the V bias correction); zero it where
    the scales are zero, as ``kv_attention_decode`` does, or a fully masked
    row (every weight equal) is not 0.
    """
    return resolve("kv_attention", q, backend)(
        q, k_q, k_s, v_q, v_s, blk=blk, out_dtype=out_dtype, v_err=v_err)


def kv_attention_decode(q, cache_k, cache_ks, cache_v, cache_vs, k_new, v_new,
                        idx, *, valid=None, out_dtype=torch.float32,
                        blk: int = 512, cache_verr=None,
                        backend: Optional[str] = None):
    """The unfused decode step: append-quantize the new token IN PLACE, zero
    the scales (and V error means) where ``valid`` [B|1, S] is False, then
    ``kv_attention``. Returns ``(out [B, Hq, hd], updated leaves)``; the
    stored scales stay unmasked."""
    updated = append_quantize(cache_k, cache_ks, cache_v, cache_vs, k_new,
                              v_new, idx, cache_verr=cache_verr)
    ck, ks, cv, vs = updated[:4]
    verr = updated[4] if cache_verr is not None else None
    if valid is not None:
        live = valid[..., None].to(torch.bool)
        ks = torch.where(live, ks, torch.zeros_like(ks))
        vs = torch.where(live, vs, torch.zeros_like(vs))
        if verr is not None:
            verr = torch.where(live, verr, torch.zeros_like(verr))
    out = kv_attention(q, ck, ks, cv, vs, blk=blk, out_dtype=out_dtype,
                       v_err=verr, backend=backend)
    return out, updated


def _decode_spec_args(device, batch, seq, n_q_heads, n_kv_heads, head_dim):
    B, S, Hq, Hkv, hd = batch, seq, n_q_heads, n_kv_heads, head_dim
    return (torch.zeros((B, Hq, hd), device=device),                 # q
            torch.zeros((B, S, Hkv, hd), dtype=torch.int8, device=device),
            torch.ones((B, S, Hkv), device=device),                  # k scale
            torch.zeros((B, S, Hkv, hd), dtype=torch.int8, device=device),
            torch.ones((B, S, Hkv), device=device),                  # v scale
            torch.zeros((B, 1, Hkv, hd), device=device),             # k_new
            torch.zeros((B, 1, Hkv, hd), device=device),             # v_new
            torch.zeros((B, 1), dtype=torch.int64, device=device))   # idx


@register_spec("kv_attention_decode")
def _spec(*, device, head_dim: int = 16, n_kv_heads: int = 2,
          n_q_heads: int = 4, seq: int = 32, batch: int = 2, **_):
    return (kv_attention_decode,
            _decode_spec_args(device, batch, seq, n_q_heads, n_kv_heads,
                              head_dim),
            {"valid": torch.ones((batch, seq), dtype=torch.bool,
                                 device=device)})
