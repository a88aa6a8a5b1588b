"""Model construction and the input and cache specs of a shape cell (port
of ``repro.models.model``): ``build_model`` gives an ``EncDecModel`` for an
encoder-decoder config and an ``LMModel`` otherwise. The specs are
``device="meta"`` tensors: their shapes and dtypes, no memory — what the
JAX package's ``jax.ShapeDtypeStruct`` stand-ins give."""
from __future__ import annotations

import torch

from typing import Union

from .config import ModelConfig, ShapeConfig
from .encdec import EncDecModel
from .lm import LMModel


def build_model(cfg: ModelConfig) -> Union[LMModel, EncDecModel]:
    if cfg.is_encdec:
        return EncDecModel(cfg)
    return LMModel(cfg)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Stand-ins for every model input of a cell: tokens (and labels for a
    train cell) [B, T] and, for an encoder-decoder, the frames [B, enc_seq,
    D] bfloat16; or a decode cell's one new token [B, 1]."""
    B, T = shape.global_batch, shape.seq_len

    def ids(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")

    if shape.kind == "decode":
        return {"token": ids(B, 1)}
    specs = {"tokens": ids(B, T)}
    if shape.kind == "train":
        specs["labels"] = ids(B, T)
    if cfg.is_encdec:
        specs["frames"] = torch.empty((B, cfg.enc_seq, cfg.d_model),
                                      dtype=torch.bfloat16, device="meta")
    return specs


def cache_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """The whole-batch cache of a decode cell: the KV cache at
    ``cfg.kv_cache_bits`` (an fp cache in ``dtype``), the SSM families'
    states, or the encoder-decoder's self and cross caches."""
    return build_model(cfg).init_cache(shape.global_batch, shape.seq_len,
                                       device="meta", per_slot=False,
                                       dtype=dtype)
