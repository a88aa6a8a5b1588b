"""Synthetic data (port of ``repro.data``): the training token stream, the
data-free flow's calibration ids and the CNN's images."""
from .synthetic import (
    TokenStream,
    calibration_tokens,
    synthetic_image_batch,
    token_batch,
)

__all__ = ["TokenStream", "calibration_tokens", "synthetic_image_batch",
           "token_batch"]
