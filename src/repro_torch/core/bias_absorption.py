"""High-bias absorption (paper §4.1.3) and exact value-bias absorption —
port of ``repro.core.bias_absorption``.

After CLE, channels with s_i < 1 get inflated biases b⁽¹⁾, which inflates
the activation range. The paper absorbs c = max(0, β − 3γ) from layer 1
into layer 2:

    b⁽¹⁾ ← b⁽¹⁾ − c,     b⁽²⁾ ← b⁽²⁾ + W⁽²⁾ c

exact for inputs where W⁽¹⁾x + b⁽¹⁾ > c. The value-projection bias passes
through attention exactly (softmax rows sum to one), so b_v is absorbed
fully into the o-projection bias: c = b_v, no 3σ rule.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def absorption_amount(beta: torch.Tensor, gamma: torch.Tensor,
                      n_sigma: float = 3.0) -> torch.Tensor:
    """c = max(0, β − n·γ) (paper §4.1.3; n = 3 ⇒ exact on 99.865 % of x)."""
    return torch.clamp_min(beta - n_sigma * gamma.abs(), 0.0)


class AbsorbResult(NamedTuple):
    b1: torch.Tensor
    b2: torch.Tensor
    c: torch.Tensor


def absorb_dense(b1: torch.Tensor, w2: torch.Tensor,
                 b2: Optional[torch.Tensor], c: torch.Tensor) -> AbsorbResult:
    """Absorb c from a dense layer's bias into the next dense layer.
    w2: [..., n, d_out]; b1, c: [..., n]."""
    b1_new = b1 - c
    shift = torch.einsum("...n,...no->...o", c, w2)
    b2_new = shift if b2 is None else b2 + shift
    return AbsorbResult(b1_new, b2_new, c)


def absorb_conv(b1: torch.Tensor, w2: torch.Tensor,
                b2: Optional[torch.Tensor], c: torch.Tensor,
                depthwise: bool = False) -> AbsorbResult:
    """Conv variant: the absorbed constant is spatially uniform, so it folds
    through the kernel's spatial sum — exact away from the padding borders,
    the approximation the paper makes (a window that overlaps the zero
    padding sums fewer taps of c). w2 HWIO."""
    b1_new = b1 - c
    if depthwise:
        shift = c * w2[..., 0, :].sum(dim=(0, 1))
    else:
        shift = torch.einsum("i,hwio->o", c, w2)
    b2_new = shift if b2 is None else b2 + shift
    return AbsorbResult(b1_new, b2_new, c)


def absorb_v_bias(bv: torch.Tensor, wo: torch.Tensor,
                  bo: Optional[torch.Tensor], *, n_q: int, n_kv: int,
                  head_dim: int) -> AbsorbResult:
    """Fully absorb the value bias through attention into the output bias.

    attn_out_h = Σ_t softmax(...)_t · (v_t + b_v) = (Σ softmax · v_t) + b_v
    because attention weights sum to one — exact for every input. With GQA,
    b_v broadcasts over the query heads of each group.

    bv: [..., n_kv·hd]; wo: [..., n_q·hd, d_model].
    """
    group = n_q // n_kv
    lead = wo.shape[:-2]
    c_g = bv.reshape(*lead, n_kv, head_dim)
    c_full = torch.broadcast_to(
        c_g[..., :, None, :], (*lead, n_kv, group, head_dim)
    ).reshape(*lead, n_q * head_dim)
    shift = torch.einsum("...n,...no->...o", c_full, wo)
    bo_new = shift if bo is None else bo + shift
    return AbsorbResult(torch.zeros_like(bv), bo_new, bv)
