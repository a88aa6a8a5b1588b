"""Carry parameters across from the JAX package, through numpy only.

``from_jax_numpy`` takes the JAX parameter tree converted to nested dicts of
numpy arrays — each ``QTensor`` given as ``{"q", "scale", "mode"}``, block
leaves stacked ``[L, ...]`` — and returns the port's tree in the same layout,
on ``device``. The conversion on the JAX side belongs to the caller (the
tests); this module imports no JAX.
"""
from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np
import torch

from .device import resolve_device
from .models.config import ModelConfig
from .quantized.qtensor import QTensor


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bfloat16: reinterpret
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def from_jax_numpy(params_np: Mapping, cfg: ModelConfig,
                   device: Optional[Union[str, torch.device]] = "cuda") -> dict:
    """The port's parameter tree for ``cfg`` from a numpy copy of the JAX
    tree. Checks the embedding and the layer count against ``cfg``."""
    device = resolve_device(device)

    def walk(node, path):
        if isinstance(node, Mapping):
            if set(node) == {"q", "scale", "mode"}:
                return QTensor(_tensor(node["q"], device),
                               _tensor(node["scale"], device), str(node["mode"]))
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return _tensor(node, device)

    params = walk(params_np, ())
    emb = tuple(params["embed"].shape)
    if emb != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed {emb} does not match {cfg.name} "
                         f"({cfg.vocab_size}, {cfg.d_model})")
    L = params["blocks"]["attn_norm"]["w"].shape[0]
    if L != cfg.n_layers:
        raise ValueError(f"{L} stacked blocks, {cfg.name} has {cfg.n_layers}")
    return params
