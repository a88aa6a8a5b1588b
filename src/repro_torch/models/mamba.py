"""Mamba2 (state-space duality, arXiv:2405.21060) mixer — port of
``repro.models.mamba``: the chunked SSD formulation in plain PyTorch.

Within chunks of length Q the selective scan is an attention-like masked
``(C·Bᵀ ⊙ decay) · X`` product; across chunks a short loop carries the
[H, P, S] state. Decode is the O(1) single-step recurrence. No Pallas kernel
lies on this path in the reference: the SSD's products stay ``einsum``s, and
only ``in_proj`` / ``out_proj`` (``layers.linear``) reach the int8 GEMMs
once the model is packed.

Param layout per layer (leading stacked dims broadcast):
  in_proj  [D, 2·din + 2·G·S + H]   → z, x, B, C, dt
  in_bias  [2·din + 2·G·S + H]
  conv_w   [W, din + 2·G·S]         depthwise causal conv over (x, B, C)
  conv_b   [din + 2·G·S]
  A_log    [H]      (A = −exp(A_log), scalar per head)
  D        [H]      skip
  dt_bias  [H]
  norm_w   [din]    gated RMSNorm before out_proj
  out_proj [din, D]
  out_bias [D]

Numerics as the reference's: ``dt`` is ``softplus`` in float32 through
``logaddexp(x, 0)`` (``F.softplus`` turns into the identity above its
threshold, ``jax.nn.softplus`` does not), the decays and the state are
float32 whatever the compute dtype, heads repeat their group's B and C
head by head (``repeat_interleave``, ``jnp.repeat``), and the causal conv
sums its taps in order from tap 0.

Over a training mesh the reference arms no attention mode for an SSM (no
heads: ``attn_seq=False``) and GSPMD partitions the mixer by the planner's
specs; the port's sharded train step (``sharding.train``) gathers every
mixer leaf whole where the layer runs (``in_proj``'s mixed segments are
never cut over "model"), each rank on its own batch rows, and this block
runs as on one device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .layers import linear, rms_norm


def ssm_dims(cfg):
    """(d_inner, heads, groups, state, in_proj width, conv channels)."""
    din = cfg.d_inner
    H = cfg.ssm_heads
    G, S = cfg.ssm_n_groups, cfg.ssm_state
    return din, H, G, S, 2 * din + 2 * G * S + H, din + 2 * G * S


def _split_proj(proj, cfg):
    din, H, G, S, _, _ = ssm_dims(cfg)
    z = proj[..., :din]
    xbc = proj[..., din: din + din + 2 * G * S]
    dt = proj[..., -H:]
    return z, xbc, dt


def _silu(x):
    return x * torch.sigmoid(x)


def _softplus(x):
    """``jax.nn.softplus``: log(1 + eᵡ) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(xbc, conv_w, conv_b, conv_state: Optional[torch.Tensor]):
    """Depthwise causal conv1d of width W over xbc [B, T, C]. conv_state
    [B, W-1, C]: the past inputs (decode), or None (prefill, zero-padded on
    the left). Returns (silu(conv + b), the new state: the last W-1
    inputs)."""
    W = conv_w.shape[0]
    if conv_state is None:
        pad = xbc.new_zeros((xbc.shape[0], W - 1, xbc.shape[-1]))
    else:
        pad = conv_state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)                   # [B, T+W-1, C]
    T = xbc.shape[1]
    out = full[:, 0:T, :] * conv_w[0]
    for i in range(1, W):
        out = out + full[:, i: i + T, :] * conv_w[i]
    return _silu(out + conv_b), full[:, -(W - 1):, :]


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """Chunked SSD scan from a zero state.

    x [b, T, H, P]; dt [b, T, H] (post-softplus, float32); A [H] (negative);
    B, C [b, T, G, S]; T a multiple of ``min(chunk, T)``. Returns y
    [b, T, H, P] and the final state [b, H, P, S] float32.
    """
    b, T, H, P = x.shape
    G, S = B.shape[-2], B.shape[-1]
    Q = min(chunk, T)
    n = T // Q
    hpg = H // G

    xb = x.reshape(b, n, Q, H, P)
    dtb = dt.reshape(b, n, Q, H)
    Bb = B.reshape(b, n, Q, G, S)
    Cb = C.reshape(b, n, Q, G, S)

    dA = dtb * A                                           # [b,n,Q,H] (≤ 0)
    cum = torch.cumsum(dA, dim=2)                          # within-chunk
    total = cum[:, :, -1, :]                               # [b,n,H]

    # intra-chunk: masked decay kernel L[q,k] = exp(cum_q − cum_k), q ≥ k
    CB = torch.einsum("bnqgs,bnkgs->bngqk", Cb, Bb)       # [b,n,G,Q,Q]
    CB = CB.repeat_interleave(hpg, dim=2)                 # [b,n,H,Q,Q]
    cum_h = cum.permute(0, 1, 3, 2)                       # [b,n,H,Q]
    logL = cum_h[..., :, None] - cum_h[..., None, :]      # [b,n,H,Q,K]
    qk_mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.where(qk_mask, torch.exp(logL), torch.zeros_like(logL))
    dt_k = dtb.permute(0, 1, 3, 2)[:, :, :, None, :]      # [b,n,H,1,K]
    M = CB * (L * dt_k).to(CB.dtype)
    y_intra = torch.einsum("bnhqk,bnkhp->bnqhp", M.to(x.dtype), xb)

    # chunk-local end states: S_loc = Σ_k exp(total − cum_k) dt_k B_k ⊗ x_k
    w_end = torch.exp(total[:, :, None, :] - cum) * dtb   # [b,n,Q,H]
    B_h = Bb.repeat_interleave(hpg, dim=3)                # [b,n,Q,H,S]
    S_loc = torch.einsum("bnqhs,bnqhp->bnhps",
                         (B_h * w_end[..., None]).to(x.dtype), xb)

    # inter-chunk scan: S_n = exp(total_n)·S_{n−1} + S_loc_n
    s = torch.zeros((b, H, P, S), dtype=torch.float32, device=x.device)
    prevs = []
    decay = torch.exp(total)
    for c in range(n):
        prevs.append(s)
        s = decay[:, c, :, None, None] * s + S_loc[:, c].float()
    s_prevs = torch.stack(prevs, dim=1)                   # [b,n,H,P,S]

    # inter-chunk contribution: y_inter_q = exp(cum_q) · C_q · S_prev
    C_h = Cb.repeat_interleave(hpg, dim=3)                # [b,n,Q,H,S]
    y_inter = torch.einsum("bnqhs,bnhps->bnqhp", C_h, s_prevs.to(x.dtype))
    y_inter = y_inter * torch.exp(cum)[..., None].to(x.dtype)

    y = (y_intra + y_inter).reshape(b, T, H, P)
    return y, s


def mamba_block(p: dict, x: torch.Tensor, cfg, *,
                state: Optional[dict] = None,
                capture: Optional[dict] = None):
    """The Mamba2 block: x [B, T, D] → (out [B, T, D], new state).

    ``state`` (cached prefill / decode): {"ssm" [B, H, P, S] float32,
    "conv" [B, W-1, d_conv]}. A step with T == 1 takes the O(1) recurrence
    from it; T > 1 runs the chunked scan from a zero state (the reference's
    prefill), the conv from the given one. The new state is returned, None
    without one. ``capture``, a dict, receives the means of the block's
    input (``ssm_in``) and of out_proj's input (``ssm_out_in``).
    """
    bsz, T, D = x.shape
    din, H, G, S, _, _ = ssm_dims(cfg)
    P = cfg.ssm_head_dim
    if capture is not None:
        capture["ssm_in"] = x.reshape(-1, D).mean(dim=0)

    proj = linear(x, p["in_proj"], p.get("in_bias"))
    z, xbc, dt_raw = _split_proj(proj, cfg)
    conv_state = None if state is None else state["conv"]
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)

    xs = xbc[..., :din].reshape(bsz, T, H, P)
    B = xbc[..., din: din + G * S].reshape(bsz, T, G, S)
    C = xbc[..., din + G * S:].reshape(bsz, T, G, S)
    dt = _softplus(dt_raw.float() + p["dt_bias"])        # [b,T,H] float32
    A = -torch.exp(p["A_log"].float())                    # [H]

    if state is None or T > 1:
        # pad T to a chunk multiple; padded steps get dt = 0 (decay
        # exp(0·A) = 1 and increment dt·Bx = 0: state and outputs are
        # exactly unaffected)
        Q = min(cfg.ssm_chunk, max(T, 1))
        pad = (-T) % Q
        if pad:
            def padT(t):
                return torch.cat([t, t.new_zeros((bsz, pad) + t.shape[2:])],
                                 dim=1)
            y, s_final = ssd_chunked(padT(xs), padT(dt), A, padT(B), padT(C), Q)
            y = y[:, :T]
        else:
            y, s_final = ssd_chunked(xs, dt, A, B, C, Q)
    else:
        # the O(1) decode recurrence (float32 state; the bf16 operands
        # promoted exactly, as the reference's mixed-dtype einsum)
        dt0 = dt[:, 0]                                    # [b,H]
        dA = torch.exp(dt0 * A)
        B_h = B[:, 0].repeat_interleave(H // G, dim=1)    # [b,H,S]
        inc = torch.einsum("bhs,bhp->bhps", B_h * dt0[..., None],
                           xs[:, 0].float())
        s_final = dA[:, :, None, None] * state["ssm"] + inc
        C_h = C[:, 0].repeat_interleave(H // G, dim=1)
        y = torch.einsum("bhps,bhs->bhp", s_final.to(x.dtype), C_h)[:, None]

    y = y + xs * p["D"][:, None].to(x.dtype)
    y = y.reshape(bsz, T, din)
    y = rms_norm(y * _silu(z), p["norm_w"])
    if capture is not None:
        capture["ssm_out_in"] = y.reshape(-1, din).mean(dim=0)
    out = linear(y, p["out_proj"], p.get("out_bias"))
    new_state = None
    if state is not None:
        new_state = {"ssm": s_final,
                     "conv": new_conv.to(state["conv"].dtype)}
    return out, new_state


def init_mamba_params(normal, uniform, L: int, cfg, dtype, device) -> dict:
    """Seeded Mamba2 parameters for L stacked layers, in the reference's
    scales: in_proj normal · D^-1/2, conv normal · 0.1, out_proj normal ·
    din^-1/2, dt drawn log-uniform in [1e-3, 1e-1] and stored as its
    inverse softplus, A_log = log(linspace(1, 16, H)), D = 1, zero biases,
    unit gains. ``normal(shape, scale)`` (in ``dtype``) and
    ``uniform(shape)`` (float32) draw in the caller's generator."""
    din, H, G, S, d_proj, d_conv = ssm_dims(cfg)
    D = cfg.d_model

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    lo, hi = math.log(0.001), math.log(0.1)
    dt = torch.exp(uniform((L, H)) * (hi - lo) + lo)
    dt_bias = dt + torch.log(-torch.expm1(-dt))           # inverse softplus
    a_log = torch.log(torch.linspace(1.0, 16.0, H, device=device))
    return {
        "in_proj": normal((L, D, d_proj), D ** -0.5),
        "in_bias": zeros(L, d_proj),
        "conv_w": normal((L, cfg.ssm_conv_width, d_conv), 0.1),
        "conv_b": zeros(L, d_conv),
        "A_log": a_log.expand(L, H).clone(),
        "D": torch.ones((L, H), dtype=torch.float32, device=device),
        "dt_bias": dt_bias.float(),
        "norm_w": torch.ones((L, din), dtype=dtype, device=device),
        "out_proj": normal((L, din, D), din ** -0.5),
        "out_bias": zeros(L, D),
    }
