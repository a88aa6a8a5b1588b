"""int8 KV cache: quantize, append, and decode attention (kernel + oracle)."""
from .ops import (
    append_quantize,
    kv_attention,
    kv_attention_decode,
    quantize_kv,
)
from .ref import kv_attention_ref, kv_attention_split_ref, pad_to_block

__all__ = ["append_quantize", "kv_attention", "kv_attention_decode",
           "kv_attention_ref", "kv_attention_split_ref",
           "pad_to_block", "quantize_kv"]
