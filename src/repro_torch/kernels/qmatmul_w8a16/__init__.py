"""W8A16 GEMM: bf16 / f32 activations x int8 weights, float32 accumulation."""
from .ops import qmatmul_w8a16
from .ref import qmatmul_w8a16_q8_ref, qmatmul_w8a16_ref

__all__ = ["qmatmul_w8a16", "qmatmul_w8a16_q8_ref", "qmatmul_w8a16_ref"]
