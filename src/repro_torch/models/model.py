"""Model construction and the input and cache specs of a shape cell (port
of ``repro.models.model``). The specs are ``device="meta"`` tensors: their
shapes and dtypes, no memory — what the JAX package's
``jax.ShapeDtypeStruct`` stand-ins give."""
from __future__ import annotations

import torch

from .config import ModelConfig, ShapeConfig
from .lm import LMModel


def build_model(cfg: ModelConfig) -> LMModel:
    return LMModel(cfg)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Stand-ins for every model input of a cell: tokens (and labels for a
    train cell) [B, T], or a decode cell's one new token [B, 1]."""
    B, T = shape.global_batch, shape.seq_len

    def ids(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")

    if shape.kind == "train":
        return {"tokens": ids(B, T), "labels": ids(B, T)}
    if shape.kind == "prefill":
        return {"tokens": ids(B, T)}
    return {"token": ids(B, 1)}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """The whole-batch KV cache of a decode cell, at ``cfg.kv_cache_bits``
    (an fp cache in ``dtype``)."""
    return build_model(cfg).init_cache(shape.global_batch, shape.seq_len,
                                       device="meta", per_slot=False,
                                       dtype=dtype)
