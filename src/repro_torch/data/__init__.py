"""Synthetic data for the data-free flow (port of ``repro.data``'s
calibration ids and the CNN's images)."""
from .synthetic import calibration_tokens, synthetic_image_batch

__all__ = ["calibration_tokens", "synthetic_image_batch"]
