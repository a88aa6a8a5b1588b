"""int8 KV cache: quantize, append, and the blocked attention oracle."""
from .ops import append_quantize, quantize_kv
from .ref import kv_attention_ref, pad_to_block

__all__ = ["append_quantize", "kv_attention_ref", "pad_to_block",
           "quantize_kv"]
