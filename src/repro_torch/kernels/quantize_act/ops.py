"""Public dynamic-quantize op, dispatched on the input's device."""
from __future__ import annotations

import torch

from ..dispatch import register_impl, resolve
from .kernel import quantize_act_cuda
from .ref import quantize_act_ref


@register_impl("quantize_act", "cuda")
def _qact_cuda(x, *, bits):
    return quantize_act_cuda(x, bits)


@register_impl("quantize_act", "torch")
def _qact_torch(x, *, bits):
    return quantize_act_ref(x, bits)


def quantize_act(x: torch.Tensor, *, bits: int = 8):
    """Per-row symmetric absmax quantization. x [M, K] → (q int8 [M, K],
    scale float32 [M]); the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    return resolve("quantize_act", x)(x, bits=bits)
