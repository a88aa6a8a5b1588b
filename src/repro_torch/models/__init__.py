"""Decoder-only dense LM in PyTorch (port of ``repro.models``)."""
from .config import ModelConfig
from .lm import LMModel


def build_model(cfg: ModelConfig) -> LMModel:
    return LMModel(cfg)


__all__ = ["LMModel", "ModelConfig", "build_model"]
