"""Post-training quantization → serving parameters (the ``pack`` stage).

``quantize_for_serving`` replaces every weight site's fp weight with an int8
``QTensor`` (per-tensor scale by default — the paper's hardware-friendly
setting). The function-preserving DFQ rewrites that the JAX package runs
before it (norm folding, CLE, bias absorption) are a later slice of the
port: weights packed here went through none of them.
"""
from __future__ import annotations

from typing import Mapping, Sequence

from .qtensor import QTensor, quantize_param


def get_path(tree: Mapping, path: Sequence[str]):
    for key in path:
        tree = tree[key]
    return tree


def set_path(tree: Mapping, path: Sequence[str], value) -> dict:
    """A copy of ``tree`` with ``value`` at ``path`` (dicts copied along the
    path, leaves shared)."""
    out = dict(tree)
    if len(path) == 1:
        out[path[0]] = value
    else:
        out[path[0]] = set_path(tree[path[0]], path[1:], value)
    return out


def quantize_for_serving(params: Mapping, sites: Sequence[Sequence[str]], *,
                         mode: str = "w8a16", per_channel: bool = False) -> dict:
    """Replace the weight at each path in ``sites`` (``LMModel.weight_sites``)
    with an int8 ``QTensor``."""
    for path in sites:
        params = set_path(params, path, quantize_param(
            get_path(params, path), per_channel=per_channel, mode=mode))
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
