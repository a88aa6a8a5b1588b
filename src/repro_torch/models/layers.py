"""Transformer building blocks — plain functions over parameter dicts.

The decoder subset of ``repro.models.layers``, with the same conventions:
linear weights are ``[d_in, d_out]`` applied as ``y = x @ w + b``, attention
projections are flat ``[D, n_heads*head_dim]`` (head-major), and a
``QTensor`` weight routes through the int8 kernels — an expert-stacked one
(``[E, d_in, d_out]``, the MoE block's) through one expert-batched launch.

Attention is the serving path over a per-slot (continuous batching) or a
whole-batch ring cache, int8 or fp:

  * an int8 cache (``k_scale`` among its leaves): the single-token decode
    through the fused decode kernel (with the quantize-out epilogue feeding
    a W8A8 ``wo``) or, with ``REPRO_FUSED_DECODE=0`` or the V bias
    correction's ``v_err`` leaf, through ``kv_attention_decode``, and the
    chunked prefill (append-quantize, then plain softmax attention over the
    dequantized cache);
  * an fp cache (the JAX package's default, ``kv_cache_bits=16``): the new
    K/V written into the cache rows, then plain softmax attention over the
    cache, decode and prefill alike — plain maths in the reference too,
    outside any Pallas kernel;

plus the cache-free attention of the eval and training forward (causal,
or over every position for an encoder; with ``chunk_kv`` the reference's
two-level online softmax over key and query chunks, its causal frontier
cut per query segment) and the encoder-decoder's cross attention (keys
and values from the encoder output, or from the cross cache that
``EncDecModel.warm_cache`` fills). A sliding window
(``AttnDims.window``) masks keys more than ``window - 1`` positions back,
in the eval forward and over the cache's ring alike. The cache tensors are
updated IN PLACE; the JAX layers return updated copies.

``moe_block`` is the reference's top-k token-choice MoE with capacity
(``_moe_block_local``): the float32 router softmax, the slot → token index
map that drops overflow tokens in its order, the expert FFNs as one
expert-batched GEMM a projection, the slot-by-slot combine in the
activation dtype, the shared expert, and the Switch aux loss.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.fused_decode.ops import fused_decode, fusion_enabled
from ..kernels.kv_attention.ops import append_quantize, kv_attention_decode
from ..kernels.qmatmul_w8a8.ops import qmatmul_w8a8_i32, qmatmul_w8a8_qin
from ..kernels.qmatmul_w8a8.ref import w8a8_epilogue
from ..kernels.qmatmul_w8a16.ops import qmatmul_w8a16
from ..quantized.qtensor import (
    QTensor,
    gemm_rows,
    qtensor_matmul,
    qtensor_matmul_prequant,
    quantize_input,
    quantizes_in_gemm,
)
from ..sharding import collectives as coll
from ..sharding.tp import current_shard

NEG_INF = -1e30


def linear(x, w, b=None):
    """y = x @ w + b; an int8 ``QTensor`` weight routes through the kernels."""
    if isinstance(w, QTensor):
        return qtensor_matmul(x, w, b)
    y = x @ w
    if b is not None:
        y = y + b
    return y


def _all_w8a8(*ws) -> bool:
    return all(isinstance(w, QTensor) and w.mode == "w8a8" for w in ws)


def _shared_linears(x, wbs):
    """Several W8A8 projections reading the SAME activation quantize it
    once. Where the plan folds (a decode step) the first GEMM quantizes x in
    its own launch and hands the int8 rows and scales to the others; else (a
    prefill chunk) one ``quantize_act`` launch feeds them all. Per-row
    quantization depends only on the row, so each output is bitwise what
    its own ``linear`` would give. Expert-stacked weights take x
    ``[E, ..., K]``, every expert's rows in one launch."""
    (w0, b0), rest = wbs[0], wbs[1:]
    if quantizes_in_gemm(x, *(w for w, _ in wbs)):
        y0, a_q, a_s = qmatmul_w8a8_qin(gemm_rows(x, w0), w0.q, w0.scale, b0,
                                        out_dtype=x.dtype, quantized=True)
        lead = tuple(x.shape[:-1])
        return [y0.reshape(*lead, w0.q.shape[-1])] + [
            qtensor_matmul_prequant(a_q, a_s, w, b, lead, out_dtype=x.dtype)
            for w, b in rest]
    a_q, a_s, lead = quantize_input(x)
    return [qtensor_matmul_prequant(a_q, a_s, w, b, lead, out_dtype=x.dtype)
            for w, b in wbs]


# --------------------------------------------------------------------------
# Norms and RoPE
# --------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-6):
    """Statistics in float32, data path in the compute dtype."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * weight.to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm with the population variance, statistics in float32 and
    the data path in the compute dtype (the reference's ``layer_norm``)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return ((x - mu.to(x.dtype)) * inv * weight.to(x.dtype)
            + bias.to(x.dtype))


def apply_norm(x, p, kind: str):
    if kind == "rms":
        return rms_norm(x, p["w"])
    if kind == "ln":
        return layer_norm(x, p["w"], p["b"])
    raise NotImplementedError(f"norm {kind!r}: rms or ln")


def rope_angles(positions, head_dim: int, theta: float):
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs          # [..., T, half]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [B, T, H, hd]; cos/sin [T, hd/2] or [B, T, hd/2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_q: int
    n_kv: int
    head_dim: int
    qk_norm: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    window: Optional[int] = None
    causal_segments: int = 1


class SlotWrite(NamedTuple):
    """Where a forward's T new tokens land in a per-slot ring cache, and what
    each of them may attend to. Every layer shares it (the JAX layers each
    recompute it from the same pre-write bookkeeping). A whole-batch cache
    (``per_slot=False``) drops the batch dim of idx, kpos and mask."""
    idx: torch.Tensor     # [B, T] ring write offsets ([T] whole-batch)
    kpos: torch.Tensor    # [B, S] absolute positions after the write (-1 = empty)
    mask: torch.Tensor    # [B, T, S] bool, True = attend ([T, S] whole-batch)

    @property
    def where(self) -> tuple:
        """The index of the new tokens' cache rows in a [B, S, ...] leaf."""
        if self.idx.ndim == 1:
            return (slice(None), self.idx)
        row = torch.arange(self.idx.shape[0], device=self.idx.device)[:, None]
        return (row, self.idx)

    @property
    def valid(self) -> torch.Tensor:
        """[B|1, S]: the positions a single new token attends to."""
        return self.mask[:, 0, :] if self.mask.ndim == 3 else self.mask[:1]


def slot_write(kpos: torch.Tensor, positions: torch.Tensor,
               window: Optional[int] = None) -> SlotWrite:
    """kpos [B, S] before the write and positions [B, T] of the new tokens
    (per-slot), or kpos [S] and positions [T] (whole-batch). With a sliding
    ``window`` a token attends to the keys of its last ``window``
    positions only (the reference's mask over ``kpos``)."""
    S = kpos.shape[-1]
    idx = positions % S
    kpos = kpos.clone()
    if kpos.ndim == 1:
        kpos[idx] = positions
        k, q = kpos[None, :], positions[:, None]
    else:
        row = torch.arange(kpos.shape[0], device=kpos.device)[:, None]
        kpos[row, idx] = positions
        k, q = kpos[:, None, :], positions[..., None]
    mask = (k >= 0) & (k <= q)
    if window is not None:
        mask = mask & (k > q - window)
    return SlotWrite(idx, kpos, mask)


def _repeat_kv(x, group: int):
    """Each kv head ``group`` times in a row along dim 2 (``jnp.repeat``),
    by expand and reshape: no output size to read back to the host, so a
    CUDA graph may capture it."""
    if group == 1:
        return x
    B, T, H, hd = x.shape
    return x[:, :, :, None, :].expand(B, T, H, group, hd).reshape(
        B, T, H * group, hd)


def attention_scores_softmax(q, k, v, mask, chunk_kv: Optional[int] = None,
                             chunk_q: Optional[int] = None,
                             causal_segments: int = 1):
    """softmax(q·kᵀ)·v. q [B, Tq, H, hd]; k, v [B, Tk, H, hd]; mask
    [B, Tq, Tk] (True = attend) or [Tq, Tk], or None.

    ``chunk_kv`` (Tk a multiple of it) takes the reference's two-level
    online softmax: query chunks of ``chunk_q`` (default min(Tq,
    max(chunk_kv // 4, 256)), or all of Tq where that does not divide it),
    each running over the key chunks with a float32 running max, sum and
    accumulator, so no [B, H, Tq, Tk] score tensor lives at once; under
    autograd each key chunk's step is recomputed in the backward (the
    reference's ``jax.checkpoint``). Only a 2-D mask chunks.
    ``causal_segments > 1`` (with a mask and Tq == Tk) splits the query
    chunks into that many segments, each scanning the key chunks up to its
    causal frontier only. Plain maths in the reference too, outside any
    Pallas kernel."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    B, Tk, H, hd = k.shape
    Tq = q.shape[1]
    if chunk_kv is None or Tk <= chunk_kv:
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        s = s.float()
        if mask is not None:
            m = mask[None, None] if mask.ndim == 2 else mask[:, None]
            s = torch.where(m, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", p, v)
    if mask is not None and mask.ndim == 3:
        raise NotImplementedError(
            "per-slot (3-D) masks require the unchunked attention path — "
            "call without chunk_kv (serving decode/prefill-chunk shapes are "
            "small enough that chunking buys nothing)")
    if Tk % chunk_kv:
        raise ValueError(f"chunk_kv {chunk_kv} does not divide the {Tk} keys")
    n_kv = Tk // chunk_kv
    k_b = k.reshape(B, n_kv, chunk_kv, H, hd).transpose(0, 1)
    v_b = v.reshape(B, n_kv, chunk_kv, H, hd).transpose(0, 1)
    chunk_q = chunk_q or min(Tq, max(chunk_kv // 4, 256))
    if Tq % chunk_q:
        chunk_q = Tq
    n_q = Tq // chunk_q
    q_b = q.reshape(B, n_q, chunk_q, H, hd).transpose(0, 1)
    # [n_q, chunk_q, n_kv, chunk_kv]: no batch or head dims
    mask_b = (mask.reshape(n_q, chunk_q, n_kv, chunk_kv)
              if mask is not None else None)

    def kv_step(qb, kb, vb, mb, m, l, acc):
        s = torch.einsum("bqhd,bkhd->bhqk", qb, kb).float() * scale
        if mb is not None:
            s = torch.where(mb[None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(-1)
        acc_new = acc * corr.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p.to(qb.dtype), vb).float()
        return m_new, l_new, acc_new

    remat = torch.is_grad_enabled()

    def run_block(q_part, mask_part, k_part, v_part):
        """The online softmax over the given key chunks, for each of the
        given query chunks."""
        outs = []
        for i in range(q_part.shape[0]):
            qb = q_part[i]
            m = torch.full((B, H, chunk_q), NEG_INF, dtype=torch.float32,
                           device=q.device)
            l = torch.zeros((B, H, chunk_q), dtype=torch.float32,
                            device=q.device)
            acc = torch.zeros((B, chunk_q, H, hd), dtype=torch.float32,
                              device=q.device)
            for j in range(k_part.shape[0]):
                mb = mask_part[i, :, j] if mask_part is not None else None
                args = (qb, k_part[j], v_part[j], mb, m, l, acc)
                m, l, acc = (checkpoint(kv_step, *args, use_reentrant=False)
                             if remat else kv_step(*args))
            out = acc / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
            outs.append(out.to(q.dtype))
        return torch.stack(outs)

    nseg = causal_segments
    if nseg > 1 and mask is not None and n_q % nseg == 0 and Tq == Tk:
        seg_q = n_q // nseg
        outs = []
        for si in range(nseg):
            q_hi = (si + 1) * seg_q * chunk_q
            n_kv_s = -(-q_hi // chunk_kv)                  # ceil
            rows = slice(si * seg_q, (si + 1) * seg_q)
            outs.append(run_block(q_b[rows], mask_b[rows, :, :n_kv_s],
                                  k_b[:n_kv_s], v_b[:n_kv_s]))
        out_b = torch.cat(outs, dim=0)
    else:
        out_b = run_block(q_b, mask_b, k_b, v_b)
    return out_b.transpose(0, 1).reshape(B, Tq, H, hd)


def _project_qkv(p: dict, x: torch.Tensor, dims: AttnDims, positions,
                 tp=None, local: bool = False):
    """q [B, T, Hq, hd], k and v [B, T, Hkv, hd], q and k roped. Under a
    serving shard ``tp`` the column-parallel projections write this rank's
    columns (their biases cut to match), and the heads are this rank's
    where ``local`` (head-local attention), else all of them."""
    B, T, _ = x.shape
    bq, bk, bv = p.get("bq"), p.get("bk"), p.get("bv")
    if tp is not None:
        bq, bk, bv = (tp.col_bias(bq, "wq"), tp.col_bias(bk, "wk"),
                      tp.col_bias(bv, "wv"))
    if _all_w8a8(p["wq"], p["wk"], p["wv"]):
        q, k, v = _shared_linears(
            x, [(p["wq"], bq), (p["wk"], bk), (p["wv"], bv)])
    else:
        q = linear(x, p["wq"], bq)
        k = linear(x, p["wk"], bk)
        v = linear(x, p["wv"], bv)
    if tp is not None:
        q, k, v = (tp.heads(q, "wq", local), tp.heads(k, "wk", local),
                   tp.heads(v, "wv", local))
    q = q.reshape(B, T, -1, dims.head_dim)
    k = k.reshape(B, T, -1, dims.head_dim)
    v = v.reshape(B, T, -1, dims.head_dim)
    if dims.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if dims.rope:
        cos, sin = rope_angles(positions, dims.head_dim, dims.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _record_mean(capture: Optional[dict], key: str, x: torch.Tensor) -> None:
    """E[x] over every token, per channel, in x's dtype (as ``jnp.mean``
    gives it) — bias correction's statistic for the sites reading x."""
    if capture is not None:
        capture[key] = x.reshape(-1, x.shape[-1]).mean(dim=0)


def causal_attention_block(p: dict, x: torch.Tensor, dims: AttnDims, *,
                           capture: Optional[dict] = None,
                           causal: bool = True,
                           chunk_kv: Optional[int] = None) -> torch.Tensor:
    """The cache-free attention of the eval and training forward
    (``LMModel.apply``, the encoder-decoder's stacks): fp keys and values,
    plain softmax, causal unless ``causal=False`` (an encoder attends to
    every position); ``chunk_kv`` chunks it (``attention_scores_softmax``,
    ``dims.causal_segments`` its segments). ``capture``, a dict, receives
    the means of the qkv input (``attn_in``) and of the output
    projection's input (``o_in``)."""
    B, T, _ = x.shape
    _record_mean(capture, "attn_in", x)
    positions = torch.arange(T, device=x.device)
    q, k, v = _project_qkv(p, x, dims, positions)
    group = dims.n_q // dims.n_kv
    mask = None
    if causal:
        mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
        if dims.window is not None:
            mask = mask.triu(1 - dims.window)
    attn = attention_scores_softmax(q, _repeat_kv(k, group),
                                    _repeat_kv(v, group), mask,
                                    chunk_kv=chunk_kv,
                                    causal_segments=dims.causal_segments)
    attn = attn.reshape(B, T, dims.n_q * dims.head_dim)
    _record_mean(capture, "o_in", attn)
    return linear(attn, p["wo"], p.get("bo"))


def cross_kv(p: dict, src: torch.Tensor, dims: AttnDims):
    """The cross attention's keys and values [B, S, Hkv, hd] from the
    encoder output ``src`` [B, S, D] (two separate projections, as the
    reference's ``kv_input`` route)."""
    B, S, _ = src.shape
    k = linear(src, p["wk"], p.get("bk")).reshape(B, S, dims.n_kv,
                                                  dims.head_dim)
    v = linear(src, p["wv"], p.get("bv")).reshape(B, S, dims.n_kv,
                                                  dims.head_dim)
    return k, v


def cross_attention_block(p: dict, x: torch.Tensor, dims: AttnDims, *,
                          kv: tuple,
                          capture: Optional[dict] = None) -> torch.Tensor:
    """Attention from the decoder's x [B, T, D] to every encoder position:
    ``kv`` the keys and values [B, S, Hkv, hd] (``cross_kv`` of the encoder
    output, or the cross cache), no mask, no rope. ``capture`` as
    ``causal_attention_block``'s (``attn_in`` the mean of x)."""
    B, T, _ = x.shape
    _record_mean(capture, "attn_in", x)
    q = linear(x, p["wq"], p.get("bq")).reshape(B, T, dims.n_q, dims.head_dim)
    group = dims.n_q // dims.n_kv
    k, v = (t.to(x.dtype) for t in kv)
    attn = attention_scores_softmax(q, _repeat_kv(k, group),
                                    _repeat_kv(v, group), None)
    attn = attn.reshape(B, T, dims.n_q * dims.head_dim)
    _record_mean(capture, "o_in", attn)
    return linear(attn, p["wo"], p.get("bo"))


def attention_block(p: dict, x: torch.Tensor, dims: AttnDims, *,
                    positions: torch.Tensor, cache: dict,
                    slots: SlotWrite,
                    chunk_kv: Optional[int] = None) -> torch.Tensor:
    """qkv projection → rope → cached attention → output projection.

    cache: this layer's {"k", "v" [B, S, Hkv, hd] int8, "k_scale",
    "v_scale" [B, S, Hkv] float32, and with the V bias correction "v_err"
    [B, S, Hkv] float32}, or an fp cache's {"k", "v"} alone, written in
    place. T == 1 is the decode hot path, T > 1 a prefill chunk;
    ``chunk_kv`` chunks the plain softmax attention over the cache (a
    whole-batch cache's 2-D mask only, as the reference's). Under a serving
    shard (``sharding.tp``) the heads and the cache are this rank's where
    the attention is head-local, and ``wo`` is row-parallel where the
    planner says so.
    """
    B, T, D = x.shape
    tp = current_shard()
    local = tp is not None and tp.head_local
    q, k, v = _project_qkv(p, x, dims, positions, tp, local)
    # a W8A8 wo reads the fused kernel's quantize-out epilogue where the
    # kernel sees the whole row (its scale is a max over every head)
    attn, q8 = _cached_attention(q, k, v, dims, cache, slots, chunk_kv,
                                 x.dtype, _all_w8a8(p["wo"]) and not local)
    if tp is not None:
        return _tp_project_out(attn, p["wo"], p.get("bo"), tp, "wo",
                               local=local, q8=q8)
    if q8 is not None:
        return qtensor_matmul_prequant(q8[0], q8[1], p["wo"], p.get("bo"),
                                       (B, T), out_dtype=x.dtype)
    return linear(attn, p["wo"], p.get("bo"))


def _cached_attention(q, k, v, dims: AttnDims, cache: dict,
                      slots: SlotWrite, chunk_kv, dtype, want_q8: bool):
    """The new K/V written into ``cache`` and q attended over it: returns
    (attention output [B, T, Hq·hd], and at a fused decode step with
    ``want_q8`` its quantize-out (int8 [B, Hq·hd], scale [B]), else
    None)."""
    B, T, nq, hd = q.shape
    group = nq // k.shape[2]
    if "k_scale" not in cache:
        # the fp cache: write the new rows, then attend over the whole
        # cache in the compute dtype, as the reference's plain maths
        ck, cv = cache["k"], cache["v"]
        ck[slots.where] = k.to(ck.dtype)
        cv[slots.where] = v.to(cv.dtype)
        attn = attention_scores_softmax(q, _repeat_kv(ck.to(dtype), group),
                                        _repeat_kv(cv.to(dtype), group),
                                        slots.mask, chunk_kv=chunk_kv,
                                        causal_segments=dims.causal_segments)
        return attn.reshape(B, T, nq * hd), None
    verr = cache.get("v_err")

    if T == 1:
        valid = slots.valid
        if fusion_enabled() and verr is None:
            # ONE launch from roped q/k/v to the attention output (and its
            # quantize-out epilogue)
            out, _ = fused_decode(
                q[:, 0], cache["k"], cache["k_scale"], cache["v"],
                cache["v_scale"], k, v, slots.idx, valid=valid,
                out_dtype=dtype, quantize_out=want_q8)
            if want_q8:
                return out[0].reshape(B, T, nq * hd), (out[1], out[2])
        else:
            # the stepwise route (REPRO_FUSED_DECODE=0, or a cache with the
            # V bias correction): append-quantize, mask, the kv_attention
            # kernel; a W8A8 wo quantizes its input itself (in its GEMM,
            # where the plan folds)
            out, _ = kv_attention_decode(
                q[:, 0], cache["k"], cache["k_scale"], cache["v"],
                cache["v_scale"], k, v, slots.idx, valid=valid,
                out_dtype=dtype, cache_verr=verr)
        return out.reshape(B, T, nq * hd), None

    # chunked prefill: append-quantize once, then attend over the
    # dequantized cache in the compute dtype
    leaves = append_quantize(cache["k"], cache["k_scale"], cache["v"],
                             cache["v_scale"], k, v, slots.idx,
                             cache_verr=verr)
    ck, ks, cv, vs = leaves[:4]
    kd = ck.to(dtype) * ks.to(dtype)[..., None]
    vd = cv.to(dtype) * vs.to(dtype)[..., None]
    if verr is not None:
        # Σ p (ṽ − e) == Σ p ṽ − Σ p e: the decode route's correction
        vd = vd - verr.to(dtype)[..., None]
    # one KV head's group of q heads at a time: each call's shapes are then
    # the same on one device and on a head-local serving shard (which holds
    # whole groups), and so are the bits — the batched GEMMs' algorithm on
    # the card depends on the batch (7 heads and 14 round differently)
    attn = torch.cat([attention_scores_softmax(
        q[:, :, j * group:(j + 1) * group].contiguous(),
        _repeat_kv(kd[:, :, j:j + 1], group),
        _repeat_kv(vd[:, :, j:j + 1], group), slots.mask, chunk_kv=chunk_kv,
        causal_segments=dims.causal_segments) for j in range(kd.shape[2])],
        dim=2)
    return attn.reshape(B, T, nq * hd), None


def _tp_project_out(h: torch.Tensor, w, b, tp, name: str, *, local: bool,
                    q8=None) -> torch.Tensor:
    """The output projection ``name`` (wo, wd) of ``h`` [..., K] under a
    serving shard: ``h`` is this rank's K block where ``local``, else whole
    (``q8``: its whole rows quantized, from the fused decode). A
    row-parallel projection takes this rank's block; otherwise the whole
    rows are gathered and the projection runs as on one device."""
    if tp.row[name]:
        return _row_linear(h if local else tp.block(h), w, b, tp,
                           whole=None if local else h, q8=q8)
    if local:
        h = tp.gather(h)
    if q8 is not None:
        return qtensor_matmul_prequant(q8[0], q8[1], w, b,
                                       tuple(h.shape[:-1]), out_dtype=h.dtype)
    return linear(h, w, b)


def _row_linear(x: torch.Tensor, w, b, tp, *, whole=None,
                q8=None) -> torch.Tensor:
    """A row-parallel projection: this rank's K block ``x`` [..., K/M]
    times its rows of ``w``, the partial sums added over "model", the bias
    once.

    W8A8: the activation is quantized against its WHOLE row's scale (a max
    over every rank's block): ``q8`` where the caller has it, else
    ``quantize_act`` of ``whole`` (gathered where not given); this rank's
    K block of the int8 row goes through the epilogue-free GEMM, whose
    int32 partials are summed exactly, then the scale epilogue — the
    single-device W8A8 bits. W8A16 and float weights sum float32
    partials (the bias after the sum), a reordered reduction; on a model
    axis of 1 the rank holds whole rows and runs the single-device
    projection (its sum over the one rank changes nothing). An
    expert-stacked ``w`` ([E, K/M, N], the MoE down projection) takes x
    [E, rows, K/M] and runs every expert in the same one launch."""
    lead, dtype = tuple(x.shape[:-1]), x.dtype
    if isinstance(w, QTensor) and w.mode == "w8a8":
        if q8 is None:
            a_q, a_s, _ = quantize_input(tp.gather(x) if whole is None
                                         else whole)
        else:
            a_q, a_s = q8
        # an expert-stacked w: every expert's rows in one launch
        acc = qmatmul_w8a8_i32(gemm_rows(tp.block(a_q), w).contiguous(), w.q)
        coll.all_reduce_sum(acc, tp.model_group)
        y = w8a8_epilogue(acc, a_s.reshape(acc.shape[:-1]), w.scale, b, dtype)
        return y.reshape(*lead, y.shape[-1])
    if tp.model_n == 1:
        return coll.all_reduce_sum(linear(x, w, b), tp.model_group)
    if isinstance(w, QTensor):
        # the kernel writes its activation's dtype: float32 partials from
        # the activation in float32 (exact for bf16)
        y = qmatmul_w8a16(gemm_rows(x, w).float(), w.q, w.scale, None)
    else:
        y = (x @ w).float()
    coll.all_reduce_sum(y, tp.model_group)
    if b is not None:
        y = y + b.float()
    return y.to(dtype).reshape(*lead, y.shape[-1])


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    """The reference's activations: silu, gelu (``jax.nn.gelu``'s default,
    the tanh form) and relu."""
    if name == "silu":
        return x * torch.sigmoid(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    raise NotImplementedError(f"mlp activation {name!r}: silu, gelu or relu")


def mlp_block(p: dict, x: torch.Tensor, act: str, *,
              capture: Optional[dict] = None, key: str = "") -> torch.Tensor:
    """The MLP, act ∈ {silu_glu, gelu_glu, gelu, relu}: gated
    ``wd(act(wg·x) * wu·x)`` or plain ``wd(act(wu·x))``. ``capture`` (the
    eval forward's only; the serving path passes none) receives the means
    of the gate/up input (``mlp_in``) and of the down projection's input
    (``down_in``). ``key`` names the subtree's placement under a serving
    shard ("shared/" for an MoE block's shared expert)."""
    tp = current_shard()
    if tp is not None:
        # column-parallel gate/up (their biases cut to this rank's
        # columns), then the down projection of this rank's block, its
        # bias added once after the sum
        cut = {n: tp.col_bias(p[n], key + "w" + n[1]) for n in ("bg", "bu")
               if n in p}
        h = _mlp_hidden({**p, **cut}, x, act)
        return _tp_project_out(h, p["wd"], p.get("bd"), tp, key + "wd",
                               local=tp.col[key + "wu"])
    _record_mean(capture, "mlp_in", x)
    h = _mlp_hidden(p, x, act)
    _record_mean(capture, "down_in", h)
    return linear(h, p["wd"], p.get("bd"))


def _mlp_hidden(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """The down projection's input: ``act(wg·x) * wu·x`` or ``act(wu·x)``.
    With the MoE block's expert-stacked weights x is [E, M, D] and each
    projection one expert-batched launch."""
    if act.endswith("_glu"):
        if _all_w8a8(p["wg"], p["wu"]):
            g, u = _shared_linears(x, [(p["wg"], p.get("bg")),
                                       (p["wu"], p.get("bu"))])
        else:
            g = linear(x, p["wg"], p.get("bg"))
            u = linear(x, p["wu"], p.get("bu"))
        return _act(act[:-4], g) * u
    return _act(act, linear(x, p["wu"], p.get("bu")))


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

def top_k(probs: torch.Tensor, k: int):
    """The k largest along the last dim, ties to the lower index first, as
    ``jax.lax.top_k`` (``torch.topk`` leaves the order of ties open): a
    stable descending sort. Returns (values, indices)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The MoE router's logits [..., E] in float32 (whole on every rank of
    a serving shard, so a top-k choice never depends on the mesh)."""
    return linear(x, p["router"], p.get("router_b")).float()


def moe_block(p: dict, x: torch.Tensor, cfg, *,
              capture: Optional[dict] = None, drops: Optional[list] = None):
    """Top-k token-choice MoE with capacity (the reference's
    ``_moe_block_local``); expert params are stacked on a leading E axis.
    x [B, T, D] → (y [B, T, D], the Switch load-balancing aux loss).

    Each batch row gives every expert C = max(1, int(T·K/E·capacity_factor))
    slots, filled in token order, every token's first choice before any
    second choice; a choice past C is dropped (gate 0). The slot → token map
    sends a dropped choice to bin C, sliced off before the gather, so no
    result rests on which of several writes to one index wins. The combine
    adds each choice's gated expert output slot by slot in x's dtype, then
    the shared expert. ``capture`` receives ``mlp_in`` [D], ``down_in_moe``
    [E, F] (each expert's mean down-projection input over its slots) and
    ``router_probs`` [E]; ``drops``, a list, the choices each batch row
    dropped for capacity ([B] int64 on x's device, no host sync).

    Under a serving shard (``sharding.tp``; the reference serves through
    this same block, GSPMD partitioning it) the router is whole on every
    rank and the dispatch and combine run on this rank's batch rows (the
    capacity is a row's, so they are the single-device ones); the expert
    gate/up write this rank's F columns and the down projection sums the
    ranks' partials (W8A8: int32, then the scale epilogue — the
    single-device bits), and the shared expert runs ``mlp_block``'s
    tensor-parallel path, its bias added once after the sum."""
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = max(1, int(T * K / E * cfg.capacity_factor))
    dev = x.device
    _record_mean(capture, "mlp_in", x)

    logits = router_logits(p, x)                                  # [B, T, E]
    ex = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = ex / ex.sum(dim=-1, keepdim=True)
    gate_vals, gate_idx = top_k(probs, K)                         # [B, T, K]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)

    # the slot → token map, T the sentinel (a zero row); dropped choices
    # land in bin C
    slot_token = torch.full((B, E, C + 1), T, dtype=torch.int64, device=dev)
    used = torch.zeros((B, E), dtype=torch.int64, device=dev)
    rows = torch.arange(B, device=dev)[:, None].expand(B, T)
    toks = torch.arange(T, device=dev)[None, :].expand(B, T)
    experts = torch.arange(E, device=dev)
    choices = []
    for slot in range(K):
        e = gate_idx[..., slot]                                   # [B, T]
        onehot = (e[..., None] == experts).to(torch.int64)        # [B, T, E]
        pos = onehot.cumsum(dim=1) - 1 + used[:, None, :]
        pos_sel = pos.gather(-1, e[..., None])[..., 0]
        keep = pos_sel < C
        write_pos = torch.where(keep, pos_sel, C)
        slot_token[rows, e, write_pos] = toks
        choices.append((e, write_pos, keep))
        used = used + (onehot * (pos < C)).sum(dim=1)

    if drops is not None:
        drops.append(sum((~keep).sum(dim=1) for _, _, keep in choices))
    slot_token = slot_token[..., :C].reshape(B, E * C)
    x_pad = torch.cat([x, x.new_zeros((B, 1, D))], dim=1)
    ex_in = torch.gather(x_pad, 1, slot_token[..., None].expand(B, E * C, D))
    # every expert's B·C rows, in (row, slot) order, as the vmapped linear
    xin = ex_in.reshape(B, E, C, D).transpose(0, 1).reshape(E, B * C, D)
    h = _mlp_hidden(p["experts"], xin, cfg.act)
    tp = current_shard()
    if tp is None:
        out = linear(h, p["experts"]["wd"])
    else:
        # h is this rank's F block where gate/up are column-parallel; the
        # down projection sums the ranks' partials before the combine
        out = _tp_project_out(h, p["experts"]["wd"], None, tp, "experts/wd",
                              local=tp.col["experts/wu"])
    out = out.reshape(E, B, C, D).transpose(0, 1).reshape(B, E * C, D)

    y = torch.zeros_like(x)
    for slot, (e, write_pos, keep) in enumerate(choices):
        flat = e * C + torch.clamp_max(write_pos, C - 1)          # [B, T]
        picked = torch.gather(out, 1, flat[..., None].expand(B, T, D))
        w_k = torch.where(keep, gate_vals[..., slot],
                          torch.zeros_like(gate_vals[..., slot])).to(x.dtype)
        y = y + picked * w_k[..., None]
    if cfg.n_shared_experts:
        y = y + mlp_block(p["shared"], x, cfg.act, key="shared/")

    probs_flat = probs.reshape(-1, E)
    if capture is not None:
        capture["down_in_moe"] = h.mean(dim=1)                   # [E, F]
        capture["router_probs"] = probs_flat.mean(dim=0)
    me = probs_flat.mean(dim=0)
    ce = (gate_idx[..., 0].reshape(-1, 1) == experts).float().mean(dim=0)
    return y, E * (me * ce).sum()
