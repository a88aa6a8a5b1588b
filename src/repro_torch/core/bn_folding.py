"""BatchNorm folding (paper §5: "Batch normalization is folded in the
adjacent layer before quantization") — port of ``repro.core.bn_folding``.

For y = BN(conv(x; W, b)) with BN statistics (μ, σ²) and affine (γ, β):

    W' = W · γ/√(σ²+ε)   (per output channel)
    b' = (b − μ) · γ/√(σ²+ε) + β

After folding, the layer's pre-activation distribution still has the BN
moments: mean β and std |γ| — what the data-free bias absorption (§4.1.3)
and bias correction (§4.2.1) consume downstream, so they are returned
beside the folded parameters.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class BNParams(NamedTuple):
    gamma: torch.Tensor
    beta: torch.Tensor
    mean: torch.Tensor
    var: torch.Tensor
    eps: float = 1e-5


class FoldedLayer(NamedTuple):
    w: torch.Tensor
    b: torch.Tensor
    # data-free pre-activation moments for downstream DFQ stages:
    act_mean: torch.Tensor   # = β
    act_std: torch.Tensor    # = |γ|


def fold_bn_conv(w: torch.Tensor, b: Optional[torch.Tensor],
                 bn: BNParams) -> FoldedLayer:
    """w: HWIO conv kernel (or [in, out] dense — last axis is the channel).
    The square root is taken in float64 and rounded once to float32, the
    correctly rounded float32 root XLA gives (PyTorch's CPU float32 sqrt
    is not always)."""
    var_eps = bn.var + bn.eps
    inv_std = bn.gamma / torch.sqrt(var_eps.double()).to(var_eps.dtype)
    w_new = w * inv_std  # broadcasts over the trailing output-channel axis
    b0 = torch.zeros_like(bn.beta) if b is None else b
    b_new = (b0 - bn.mean) * inv_std + bn.beta
    return FoldedLayer(w_new, b_new, bn.beta, bn.gamma.abs())
