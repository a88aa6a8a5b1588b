"""Carry parameters across from the JAX package, through numpy only.

``from_jax_numpy`` takes the JAX parameter tree converted to nested dicts of
numpy arrays — each ``QTensor`` given as ``{"q", "scale", "mode"}``, block
leaves stacked ``[L, ...]``: an MoE block's experts ``[L, E, ...]`` beside
its router and shared expert, a Mamba2 block's ``mixer``, the hybrid's
``shared_blocks``, the encoder-decoder's ``enc_blocks`` / ``dec_blocks``
(with their ``cross`` attention) — and returns the port's tree in the same
layout, on ``device``. ``cnn_from_jax_numpy`` does the same for the CNN's params or
folded tree (lists of blocks, ``FoldedLayer`` leaves, ``stride`` ints). The
conversion on the JAX side belongs to the caller (the tests); this module
imports no JAX.
"""
from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np
import torch

from .device import resolve_device
from .core.bn_folding import FoldedLayer
from .models.cnn import CNNConfig
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
    tree. Checks the embedding, the layer counts (the encoder's too, the
    hybrid's shared blocks) and (MoE) the expert count against ``cfg``."""
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
    if cfg.is_encdec:
        stacks = {"enc_blocks": cfg.n_enc_layers, "dec_blocks": cfg.n_layers}
    else:
        stacks = {"blocks": cfg.n_layers}
        if cfg.family == "hybrid":
            stacks["shared_blocks"] = cfg.hybrid_n_shared_blocks
    for stack, n in stacks.items():
        norm = params[stack].get("norm", params[stack].get("attn_norm"))
        L = norm["w"].shape[0]
        if L != n:
            raise ValueError(f"{L} stacked {stack}, {cfg.name} has {n}")
    if "mlp" not in params.get("blocks", {}):
        return params
    experts = params["blocks"]["mlp"].get("experts")
    if (experts is not None) != bool(cfg.n_experts):
        raise ValueError(f"{cfg.name} has {cfg.n_experts} experts; the tree "
                         + ("stacks experts" if experts is not None
                            else "has none"))
    if experts is not None:
        wd = experts["wd"]
        E = (wd.q if isinstance(wd, QTensor) else wd).shape[1]
        if E != cfg.n_experts:
            raise ValueError(f"{E} stacked experts, {cfg.name} has "
                             f"{cfg.n_experts}")
    return params


def cnn_from_jax_numpy(tree_np, cfg: CNNConfig,
                       device: Optional[Union[str, torch.device]] = "cuda"):
    """The port's CNN params or folded tree for ``cfg`` from a numpy copy of
    the JAX one (``jax.device_get`` of it: numpy leaves, the JAX package's
    ``FoldedLayer`` named tuples, ``stride`` ints). Checks the stem, the
    block count and the head against ``cfg``."""
    device = resolve_device(device)

    def walk(node):
        if getattr(node, "_fields", None) == FoldedLayer._fields:
            return FoldedLayer(*(walk(v) for v in node))
        if isinstance(node, Mapping):
            return {k: int(v) if k == "stride" else walk(v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _tensor(node, device)

    tree = walk(tree_np)
    stem = tree["stem"]
    stem_w = stem.w if isinstance(stem, FoldedLayer) else stem["w"]
    want = (3, 3, cfg.in_channels, cfg.width)
    if tuple(stem_w.shape) != want:
        raise ValueError(f"stem kernel {tuple(stem_w.shape)} does not match "
                         f"{cfg.name} {want}")
    if len(tree["blocks"]) != len(cfg.blocks):
        raise ValueError(f"{len(tree['blocks'])} blocks, {cfg.name} has "
                         f"{len(cfg.blocks)}")
    head = tuple(tree["head"]["w"].shape)
    if head != (cfg.blocks[-1][1], cfg.num_classes):
        raise ValueError(f"head {head} does not match {cfg.name} "
                         f"({cfg.blocks[-1][1]}, {cfg.num_classes})")
    return tree
