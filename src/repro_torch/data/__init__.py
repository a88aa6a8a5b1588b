"""Synthetic data for the data-free flow (port of the calibration half of
``repro.data``)."""
from .synthetic import calibration_tokens

__all__ = ["calibration_tokens"]
