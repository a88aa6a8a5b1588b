"""Cross-layer range equalization (paper §4.1, appendix A) — port of
``repro.core.cle``: the transformer pairs and the CNN's conv chains.

For two weight tensors connected through a positive-scaling-equivariant
map, the optimal diagonal rescaling S (paper eq. 9) is the closed form of
eq. 11:

    s_i = (1 / r_i^(2)) * sqrt(r_i^(1) * r_i^(2))

after which r_i^(1) = r_i^(2) for every channel i. The fp32 function is
preserved exactly: W1 ← S⁻¹ W1, b1 ← S⁻¹ b1, W2 ← W2 S.

Dense weights are ``[..., d_in, d_out]`` (applied as ``y = x @ W + b``);
leading dims (layer-stacked ``[L, ...]``) broadcast through every function.
Conv kernels are HWIO, as the JAX package keeps them.
Each function is the JAX one's arithmetic in the same order — abs, max,
sqrt, multiply and divide, each correctly rounded — so the results are
bit-equal to the JAX package's on the same inputs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

_EPS = 1e-12


def equalization_scales(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Paper eq. 11. Dead channels (r1·r2 ≈ 0) get s = 1 (no-op) — they
    carry no signal (§5.1.1)."""
    r2c = torch.clamp_min(r2, _EPS)
    prod = torch.clamp_min(r1, _EPS) * r2c
    # PyTorch's vectorized float32 sqrt on the CPU is not always correctly
    # rounded (1 ulp off XLA's and numpy's on some inputs); the float64
    # sqrt rounded to float32 is, since 53 >= 2 * 24 + 2 bits
    s = torch.sqrt(prod.to(torch.float64)).to(prod.dtype) / r2c
    return torch.where(r1 * r2 > _EPS, s, torch.ones_like(s))


class PairResult(NamedTuple):
    w1: torch.Tensor
    b1: Optional[torch.Tensor]
    w2: torch.Tensor
    scales: torch.Tensor


def equalize_dense_pair(w1: torch.Tensor, b1: Optional[torch.Tensor],
                        w2: torch.Tensor) -> PairResult:
    """Equalize ``y = f(x @ W1 + b1) @ W2`` where f is ReLU (paper eq. 5-7)
    or the up→down path of a gated MLP (exactly linear in W1's output).
    W1: [..., d_in, n], W2: [..., n, d_out]."""
    r1 = w1.abs().amax(dim=-2)                       # [..., n] over d_in
    r2 = w2.abs().amax(dim=-1)                       # [..., n]
    s = equalization_scales(r1, r2)
    w1_new = w1 / s[..., None, :]
    b1_new = None if b1 is None else b1 / s
    w2_new = w2 * s[..., :, None]
    return PairResult(w1_new, b1_new, w2_new, s)


def equalize_vo(wv: torch.Tensor, bv: Optional[torch.Tensor],
                wo: torch.Tensor, *, n_q: int, n_kv: int,
                head_dim: int) -> PairResult:
    """Equalize value-projection output channels against the output
    projection's input channels through attention.

    Exact: ``softmax(QKᵀ)·V`` is linear in V, so a per-channel scale on V
    commutes to O's input. With GQA, V channel (kv, d) feeds the o-proj rows
    of every query head in kv's group.

    wv: [..., d_model, n_kv·head_dim], wo: [..., n_q·head_dim, d_model].
    """
    group = n_q // n_kv
    lead_o = wo.shape[:-2]
    d_model_out = wo.shape[-1]
    r1 = wv.abs().amax(dim=-2)                       # [..., n_kv*hd]
    wo_g = wo.reshape(*lead_o, n_kv, group, head_dim, d_model_out)
    r2 = wo_g.abs().amax(dim=(-3, -1))               # [..., n_kv, hd]
    r2 = r2.reshape(*lead_o, n_kv * head_dim)
    s = equalization_scales(r1, r2)                  # [..., n_kv*hd]
    wv_new = wv / s[..., None, :]
    bv_new = None if bv is None else bv / s
    s_g = s.reshape(*lead_o, n_kv, 1, head_dim, 1)
    wo_new = (wo_g * s_g).reshape(wo.shape)
    return PairResult(wv_new, bv_new, wo_new, s)


class QKResult(NamedTuple):
    wq: torch.Tensor
    bq: Optional[torch.Tensor]
    wk: torch.Tensor
    bk: Optional[torch.Tensor]
    scales: torch.Tensor


def equalize_qk(wq: torch.Tensor, bq: Optional[torch.Tensor],
                wk: torch.Tensor, bk: Optional[torch.Tensor], *, n_q: int,
                n_kv: int, head_dim: int, rope: bool = True) -> QKResult:
    """Equalize Q against K. Logits ⟨q_h, k_g(h)⟩ are preserved when Q
    channel (h, d) is divided by s and K channel (g(h), d) multiplied by s.
    Constraints:

      * GQA: every query head of a group shares the K head, so s is indexed
        by (kv_head, d) and broadcast over the group;
      * RoPE (rotate-half: dims d and d + head_dim/2 form one rotation pair)
        mixes the pair, so s is shared within it.

    wq: [..., d_model, n_q·head_dim], wk: [..., d_model, n_kv·head_dim].
    """
    group = n_q // n_kv
    lead = wq.shape[:-2]
    d_model = wq.shape[-2]
    half = head_dim // 2

    wq_g = wq.reshape(*lead, d_model, n_kv, group, head_dim)
    wk_g = wk.reshape(*lead, d_model, n_kv, head_dim)
    rq = wq_g.abs().amax(dim=(-4, -2))               # [..., n_kv, hd]
    rk = wk_g.abs().amax(dim=-3)                     # [..., n_kv, hd]
    if rope:
        # share within rotation pairs (d, d+half): the pairwise max
        def pair_max(r):
            m = torch.maximum(r[..., :half], r[..., half:])
            return torch.cat([m, m], dim=-1)

        rq, rk = pair_max(rq), pair_max(rk)
    s = equalization_scales(rq, rk)
    if rope:
        s = torch.cat([s[..., :half], s[..., :half]], dim=-1)

    # Q ← Q / s ; K ← K · s (per grouped channel): logits invariant, and
    # r_q' = r_k' = sqrt(r_q · r_k) per eq. 11
    wk_new = (wk_g * s[..., None, :, :]).reshape(wk.shape)
    wq_new = (wq_g / s[..., None, :, None, :]).reshape(wq.shape)
    bq_new = bk_new = None
    if bq is not None:
        bq_new = (bq.reshape(*lead, n_kv, group, head_dim)
                  / s[..., :, None, :]).reshape(bq.shape)
    if bk is not None:
        bk_new = (bk.reshape(*lead, n_kv, head_dim) * s).reshape(bk.shape)
    return QKResult(wq_new, bq_new, wk_new, bk_new,
                    s.reshape(*lead, n_kv * head_dim))


def fold_norm(norm_w: torch.Tensor, consumers: Sequence[torch.Tensor],
              norm_b: Optional[torch.Tensor] = None,
              consumer_biases: Optional[Sequence[Optional[torch.Tensor]]] = None):
    """Fold a norm's elementwise scale γ (and shift β, if LayerNorm) into
    the linears consuming its output — the transformer analogue of the
    paper's BatchNorm folding (§5): W·(γ⊙x̂ + β) = (W·diag(γ))·x̂ + W·β.

    norm_w: [..., d]; consumers: [..., d, out] each. Returns
    (ones_like(norm_w), zeros β or None, new consumers, new biases).
    """
    new_ws, new_bs = [], []
    if consumer_biases is None:
        consumer_biases = [None] * len(consumers)
    for w, b in zip(consumers, consumer_biases):
        w_new = w * norm_w[..., :, None]
        if norm_b is not None:
            shift = torch.einsum("...d,...do->...o",
                                 norm_b * torch.ones_like(norm_w), w)
            b_new = shift if b is None else b + shift
        else:
            b_new = b
        new_ws.append(w_new)
        new_bs.append(b_new)
    ones = torch.ones_like(norm_w)
    zeros = None if norm_b is None else torch.zeros_like(norm_b)
    return ones, zeros, new_ws, new_bs


# ----------------------------------------------------------------------------
# CNN chain equalization (the paper's own experimental setting).
# ----------------------------------------------------------------------------

class ConvLayer(NamedTuple):
    """HWIO conv kernel + bias + structural kind.

    kind: "conv" (dense conv / 1x1), "depthwise" ([kh,kw,1,C], groups = C),
    or "dense" ([in,out]).
    """

    w: torch.Tensor
    b: Optional[torch.Tensor]
    kind: str = "conv"


def _out_ranges(layer: ConvLayer) -> torch.Tensor:
    if layer.kind == "dense":
        return layer.w.abs().amax(dim=-2)
    return layer.w.abs().amax(dim=(0, 1, 2))        # HWIO → per O


def _in_ranges(layer: ConvLayer) -> torch.Tensor:
    if layer.kind == "dense":
        return layer.w.abs().amax(dim=-1)
    if layer.kind == "depthwise":
        return layer.w.abs().amax(dim=(0, 1, 2))    # channel == O axis
    return layer.w.abs().amax(dim=(0, 1, 3))        # per I


def _scale_out(layer: ConvLayer, s: torch.Tensor) -> ConvLayer:
    """Divide output channels by s (and bias)."""
    if layer.kind == "dense":
        w = layer.w / s[None, :]
    else:
        w = layer.w / s[None, None, None, :]
    b = None if layer.b is None else layer.b / s
    return layer._replace(w=w, b=b)


def _scale_in(layer: ConvLayer, s: torch.Tensor) -> ConvLayer:
    """Multiply input channels by s (compensating an upstream 1/s)."""
    if layer.kind == "dense":
        w = layer.w * s[:, None]
    elif layer.kind == "depthwise":
        w = layer.w * s[None, None, None, :]
    else:
        w = layer.w * s[None, None, :, None]
    return layer._replace(w=w)


class ChainResult(NamedTuple):
    layers: list
    cum: list        # per interface: the product of its scales over passes
    passes: int      # passes run before the early stop (or ``iterations``)


def equalize_conv_chain(layers: Sequence[ConvLayer], iterations: int = 20,
                        tol: float = 1e-4) -> ChainResult:
    """Iterate pairwise equalization over a chain of layers connected
    without splits (paper §4.1.2: "we iterate this process for pairs of
    layers ... until convergence"), stopping after the first pass whose
    largest |log s| is below ``tol``. Returns the new layers, the
    cumulative per-interface scales and the number of passes run (the JAX
    function returns the first two). The stop test takes the log in
    float64, so the card and the CPU run the same passes."""
    layers = list(layers)
    n_if = len(layers) - 1
    cum = [torch.ones_like(_out_ranges(layers[i])) for i in range(n_if)]
    passes = 0
    for _ in range(iterations):
        passes += 1
        max_log_change = []
        for i in range(n_if):
            s = equalization_scales(_out_ranges(layers[i]),
                                    _in_ranges(layers[i + 1]))
            layers[i] = _scale_out(layers[i], s)
            layers[i + 1] = _scale_in(layers[i + 1], s)
            cum[i] = cum[i] * s
            max_log_change.append(s.double().log().abs().max())
        if not max_log_change or float(torch.stack(max_log_change).max()) < tol:
            break
    return ChainResult(layers, cum, passes)
