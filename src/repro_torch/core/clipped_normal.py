"""Closed-form moments of the clipped normal distribution (paper appendix C)
— port of ``repro.core.clipped_normal``.

Given X ~ N(μ, σ²) and a clipped-linear activation f(x) = clip(x, a, b),
``clipped_normal_mean`` is E[f(X)] (eq. 38) and ``clipped_normal_var`` is
Var[f(X)] (eq. 44): with batch normalization the pre-activations are
N(β, γ²), so the post-activation mean E[x] of bias correction (§4.2.1) is
available without data. ReLU is a = 0, b = ∞ (eq. 19); ReLU6 is a = 0,
b = 6.

``gaussian_expect`` covers activations that are not clipped-linear (GELU,
SiLU): E[f(X)] under the same Gaussian assumption by 64-point
Gauss–Hermite quadrature, on the JAX package's nodes.

These are host-side stage maths, not a hot path: plain tensor expressions,
φ as exp(−x²/2)/√(2π) and Φ as ``torch.special.ndtr``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Union

import numpy as np
import torch

_SQRT_2PI = math.sqrt(2.0 * math.pi)
Bound = Union[float, torch.Tensor]


def _phi(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * x * x) / _SQRT_2PI


def _Phi(x: torch.Tensor) -> torch.Tensor:
    return torch.special.ndtr(x)


def clipped_normal_mean(mu: torch.Tensor, sigma: torch.Tensor,
                        a: Bound = 0.0,
                        b: Optional[Bound] = None) -> torch.Tensor:
    """E[clip(X, a, b)], paper eq. 38. ``b=None`` means b = +∞."""
    sigma = torch.clamp_min(sigma, 1e-12)
    alpha = (a - mu) / sigma
    if b is None:
        # b → ∞: Φ(β) → 1, φ(β) → 0, b·(1 − Φ(β)) → 0
        return (sigma * _phi(alpha) + mu * (1.0 - _Phi(alpha))
                + a * _Phi(alpha))
    beta = (b - mu) / sigma
    return (sigma * (_phi(alpha) - _phi(beta))
            + mu * (_Phi(beta) - _Phi(alpha))
            + a * _Phi(alpha)
            + b * (1.0 - _Phi(beta)))


def clipped_normal_var(mu: torch.Tensor, sigma: torch.Tensor,
                       a: Bound = 0.0,
                       b: Optional[Bound] = None) -> torch.Tensor:
    """Var[clip(X, a, b)], paper eq. 44."""
    sigma = torch.clamp_min(sigma, 1e-12)
    m = clipped_normal_mean(mu, sigma, a, b)
    alpha = (a - mu) / sigma
    phi_a = _phi(alpha)
    if b is None:
        z = 1.0 - _Phi(alpha)
        phi_b = torch.zeros_like(alpha)
        b_phi_b = torch.zeros_like(alpha)    # lim b·φ(β) = 0
        tail_b = torch.zeros_like(alpha)     # lim (b − m)²(1 − Φ(β)) = 0
    else:
        beta = (b - mu) / sigma
        z = _Phi(beta) - _Phi(alpha)
        phi_b = _phi(beta)
        b_phi_b = b * phi_b
        tail_b = (b - m) ** 2 * (1.0 - _Phi(beta))
    var = (z * (mu ** 2 + sigma ** 2 + m ** 2 - 2.0 * m * mu)
           + sigma * (a * phi_a - b_phi_b)
           + sigma * (mu - 2.0 * m) * (phi_a - phi_b)
           + (a - m) ** 2 * _Phi(alpha)
           + tail_b)
    return torch.clamp_min(var, 0.0)


def relu_normal_mean(beta: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Paper eq. 19: E[ReLU(X)] for X ~ N(β, γ²)."""
    gamma = torch.clamp_min(gamma.abs(), 1e-12)
    z = -beta / gamma
    return gamma * _phi(z) + beta * (1.0 - _Phi(z))


# --------------------------------------------------------------------------
# Gauss–Hermite quadrature for activations that are not clipped-linear
# --------------------------------------------------------------------------

_GH_POINTS = 64
_GH_X, _GH_W = np.polynomial.hermite_e.hermegauss(_GH_POINTS)  # probabilists'
_GH_W = _GH_W / np.sqrt(2.0 * np.pi)


def gaussian_expect(fn: Callable[[torch.Tensor], torch.Tensor],
                    mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """E[fn(X)] for X ~ N(μ, σ²) by 64-point Gauss–Hermite quadrature (the
    nodes and weights in float64, cast to μ's dtype as the JAX package
    does)."""
    nodes = torch.as_tensor(_GH_X, dtype=mu.dtype, device=mu.device)
    weights = torch.as_tensor(_GH_W, dtype=mu.dtype, device=mu.device)
    x = mu[..., None] + sigma[..., None] * nodes
    return (fn(x) * weights).sum(dim=-1)
