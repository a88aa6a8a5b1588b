"""Public dynamic-quantize op, dispatched on the input's device."""
from __future__ import annotations

from typing import Optional

import torch

from ..dispatch import register_impl, register_spec, resolve
from .kernel import quantize_act_cuda
from .ref import quantize_act_ref


@register_impl("quantize_act", "cuda")
def _qact_cuda(x, *, bits):
    return quantize_act_cuda(x, bits)


@register_impl("quantize_act", "torch")
def _qact_torch(x, *, bits):
    return quantize_act_ref(x, bits)


def quantize_act(x: torch.Tensor, *, bits: int = 8,
                 backend: Optional[str] = None):
    """Per-row symmetric absmax quantization. x [M, K] → (q int8 [M, K],
    scale float32 [M]); the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    return resolve("quantize_act", x, backend)(x, bits=bits)


@register_spec("quantize_act")
def _spec(*, device, d_in: int = 64, **_):
    return (quantize_act, (torch.zeros((8, d_in), device=device),), {})
