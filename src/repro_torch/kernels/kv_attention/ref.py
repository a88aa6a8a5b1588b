"""Blocked online-softmax oracle for int8-KV decode attention.

Mirrors ``repro/kernels/kv_attention/ref.py`` ``kv_attention_ref`` block for
block: the same block order, float32 op sequence and zero-scale masking
(scale 0 marks an invalid position; masked scores are -1e30, never -inf, so
a fully masked row comes out 0, not NaN). The fused decode plain version
composes it. With ``v_err`` (the per-position V error means of the V bias
correction) the oracle carries ``e = Σ p·v_err`` beside ``acc`` through the
same rescaling and returns ``(acc - e) / l``, as the CUDA kernel does; the
JAX package applies the correction in ``kv_attention_xla`` only.

``kv_attention_split_ref`` is the plain version of the CUDA kernel's
split-S scheme: per split of ``attention_plan``'s tiles a softmax state
(m, l, acc, e), then the splits combined in rank order.
"""
from __future__ import annotations

import torch

from ..attention_plan import TS, plan
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


def kv_attention_split_ref(q, k_q, k_s, v_q, v_s, out_dtype=torch.float32, *,
                           splits=None, v_err=None):
    """The kernel's split-S scheme in plain PyTorch: S padded to whole tiles
    of ``TS`` zero-scale (masked) positions, split ``s`` of the plan (or of
    ``splits``) attends over its tiles alone — its max m, sum l, ``acc`` and,
    with ``v_err``, ``e = Σ p·v_err`` — and the splits are combined in rank
    order, each rescaled by ``exp(m_s - max m)``: a split whose positions
    are all masked (m = -1e30) adds exactly nothing once any split is live.
    Returns ``(acc - e) / max(l, 1e-30)`` as ``out_dtype`` [B, Hq, hd]."""
    B, S, Hkv, hd = k_q.shape
    Hq = q.shape[1]
    group = Hq // Hkv
    p = plan(B, S, Hq, Hkv, hd, v_err is not None, splits=splits)
    k_q, k_s, v_q, v_s = (_pad_to(t, TS, 1) for t in (k_q, k_s, v_q, v_s))
    if v_err is not None:
        v_err = _pad_to(v_err.float(), TS, 1)
    scale = 1.0 / (hd ** 0.5)
    qg = q.float().reshape(B, Hkv, group, hd)
    parts = []
    for s in range(p.splits):
        first, last = p.split_tiles(s)
        sl = slice(first * TS, last * TS)
        ks_b = k_s[:, sl].float()                              # [B, n, Hkv]
        k = k_q[:, sl].float() * ks_b[..., None]
        sc = torch.einsum("bngd,bknd->bngk", qg, k) * scale    # [B, Hkv, G, n]
        live = (ks_b > 0).permute(0, 2, 1)[:, :, None, :]
        sc = torch.where(live, sc, torch.full_like(sc, _NEG))
        m = sc.amax(-1)
        pr = torch.exp(sc - m[..., None])
        v = v_q[:, sl].float() * v_s[:, sl].float()[..., None]
        acc = torch.einsum("bngk,bknd->bngd", pr, v)
        e = (torch.einsum("bngk,bkn->bng", pr, v_err[:, sl])
             if v_err is not None else None)
        parts.append((m, pr.sum(-1), acc, e))
    m_all = torch.stack([part[0] for part in parts]).amax(0)
    l = torch.zeros_like(m_all)
    acc = torch.zeros_like(parts[0][2])
    e_acc = torch.zeros_like(m_all)
    for m, l_s, acc_s, e_s in parts:                           # rank order
        f = torch.exp(m - m_all)
        l = l + l_s * f
        acc = acc + acc_s * f[..., None]
        if e_s is not None:
            e_acc = e_acc + e_s * f
    if v_err is not None:
        acc = acc - e_acc[..., None]
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, Hq, hd).to(out_dtype)
