"""Post-training quantization → serving parameters (the ``pack`` stage).

``quantize_for_serving`` is DFQ's deployment output: after the
function-preserving rewrites (norm folding, CLE, bias absorption — the
pipeline's earlier stages), every ``WeightSite``'s fp weight is replaced by
an int8 ``QTensor`` (per-tensor scale by default — the paper's
hardware-friendly setting); the model then serves through the int8 kernels
with no code change.
"""
from __future__ import annotations

from typing import Mapping

import torch

from ..core.graph import DFQPlan
from ..core.tree import get_path, set_path
from .qtensor import QTensor, quantize_param


def quantize_for_serving(params: Mapping, plan: DFQPlan, *,
                         mode: str = "w8a16",
                         per_channel: bool = False) -> dict:
    """Replace each site's weight with an int8 ``QTensor``."""
    for site in plan.sites:
        params = set_path(params, site.w, quantize_param(
            get_path(params, site.w), per_channel=per_channel, mode=mode))
    return params


def quantize_shapes(params_shape: Mapping, plan: DFQPlan, *,
                    mode: str = "w8a16", per_channel: bool = False) -> dict:
    """Shape-level mirror of ``quantize_for_serving`` for the dry-run:
    every site weight (a ``device="meta"`` tensor) becomes a ``QTensor`` of
    a meta int8 payload of its shape and a meta float32 scale of
    ``w.shape[:-2] + (N,)`` (per channel) or ``+ (1,)`` — no allocation."""
    for site in plan.sites:
        w = get_path(params_shape, site.w)
        scale_shape = tuple(w.shape[:-2]) + ((w.shape[-1],) if per_channel
                                             else (1,))
        qt = QTensor(
            torch.empty(w.shape, dtype=torch.int8, device="meta"),
            torch.empty(scale_shape, dtype=torch.float32, device="meta"),
            mode)
        params_shape = set_path(params_shape, site.w, qt)
    return params_shape


def dequantize_params(params: Mapping) -> dict:
    """Undo for validation: every ``QTensor`` replaced by its float32 image
    ``q · scale`` (the fake-quant weights), every other leaf kept."""
    if isinstance(params, Mapping):
        return {k: dequantize_params(v) for k, v in params.items()}
    if isinstance(params, QTensor):
        return params.dequant()
    return params


def serving_summary(params: Mapping) -> dict:
    """Bytes accounting: fp32 vs int8 parameter payload."""
    fp_bytes = q_bytes = 0

    def walk(node):
        nonlocal fp_bytes, q_bytes
        if isinstance(node, Mapping):
            for v in node.values():
                walk(v)
        elif isinstance(node, QTensor):
            q_bytes += node.q.numel() + node.scale.numel() * 4
            fp_bytes += node.q.numel() * 4
        else:
            fp_bytes += node.numel() * node.element_size()
            q_bytes += node.numel() * node.element_size()

    walk(params)
    return {"fp32_bytes": int(fp_bytes), "int8_bytes": int(q_bytes),
            "compression": fp_bytes / max(q_bytes, 1)}
