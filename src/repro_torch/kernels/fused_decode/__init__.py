"""Fused decode: append-quantize + int8 attention (+ quantize-out)."""
from .ops import fused_decode, fusion_enabled
from .ref import fused_decode_ref

__all__ = ["fused_decode", "fused_decode_ref", "fusion_enabled"]
