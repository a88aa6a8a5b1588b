"""Blocked online-softmax oracle for int8-KV decode attention.

Mirrors ``repro/kernels/kv_attention/ref.py`` ``kv_attention_ref`` block for
block: the same block order, float32 op sequence and zero-scale masking
(scale 0 marks an invalid position; masked scores are -1e30, never -inf, so
a fully masked row comes out 0, not NaN). The fused decode plain version
composes it. With ``v_err`` (the per-position V error means of the V bias
correction) the oracle carries ``e = Σ p·v_err`` beside ``acc`` through the
same rescaling and returns ``(acc - e) / l``, as the CUDA kernel does; the
JAX package applies the correction in ``kv_attention_xla`` only.
"""
from __future__ import annotations

import torch

from ..dispatch import _pad_to

_NEG = -1e30


def pad_to_block(k_q, k_s, v_q, v_s, blk: int):
    """Pad S up to a multiple of ``min(blk, S)`` with zero-scale (= masked)
    positions. Returns the padded leaves and the effective block."""
    S = k_q.shape[1]
    blk_e = min(blk, S)
    return (_pad_to(k_q, blk_e, 1), _pad_to(k_s, blk_e, 1),
            _pad_to(v_q, blk_e, 1), _pad_to(v_s, blk_e, 1), blk_e)


def kv_attention_ref(q, k_q, k_s, v_q, v_s, out_dtype=torch.float32, *,
                     blk: int = 512, v_err=None):
    """q [B, Hq, hd]; k_q/v_q [B, S, Hkv, hd] int8; k_s/v_s (and ``v_err``)
    [B, S, Hkv] → [B, Hq, hd] ``out_dtype``."""
    B, S, Hkv, hd = k_q.shape
    Hq = q.shape[1]
    group = Hq // Hkv
    k_q, k_s, v_q, v_s, blk_e = pad_to_block(k_q, k_s, v_q, v_s, blk)
    if v_err is not None:
        v_err = _pad_to(v_err.float(), blk_e, 1)
        e_acc = torch.zeros((B, Hq), dtype=torch.float32, device=q.device)
    n_blk = k_q.shape[1] // blk_e
    scale = 1.0 / (hd ** 0.5)
    qg = q.float().reshape(B, Hkv, group, hd)
    m = torch.full((B, Hq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hq, hd), dtype=torch.float32, device=q.device)
    for j in range(n_blk):
        sl = slice(j * blk_e, (j + 1) * blk_e)
        ks_b = k_s[:, sl].float()                              # [B, blk, Hkv]
        k = k_q[:, sl].float() * ks_b[..., None]               # [B, blk, Hkv, hd]
        s = torch.einsum("bngd,bknd->bngk", qg, k) * scale     # [B, Hkv, G, blk]
        live = (ks_b > 0).permute(0, 2, 1)[:, :, None, :]
        s = torch.where(live, s, torch.full_like(s, _NEG)).reshape(B, Hq, -1)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        v = v_q[:, sl].float() * v_s[:, sl].float()[..., None]
        pv = torch.einsum("bngk,bknd->bngd", p.reshape(B, Hkv, group, -1), v)
        acc = acc * corr[..., None] + pv.reshape(B, Hq, hd)
        if v_err is not None:
            pe = torch.einsum("bngk,bkn->bng", p.reshape(B, Hkv, group, -1),
                              v_err[:, sl])
            e_acc = e_acc * corr + pe.reshape(B, Hq)
        m = m_new
    if v_err is not None:
        acc = acc - e_acc[..., None]
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(out_dtype)
