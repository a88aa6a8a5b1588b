"""W8A8 GEMM: int8 activations x int8 weights, int32 accumulation."""
from .ops import qmatmul_w8a8, qmatmul_w8a8_i32, qmatmul_w8a8_qin
from .ref import (
    qmatmul_w8a8_acc,
    qmatmul_w8a8_i32_ref,
    qmatmul_w8a8_q8_ref,
    qmatmul_w8a8_qin_ref,
    qmatmul_w8a8_ref,
    w8a8_epilogue,
)

__all__ = ["qmatmul_w8a8", "qmatmul_w8a8_acc", "qmatmul_w8a8_i32",
           "qmatmul_w8a8_i32_ref", "qmatmul_w8a8_q8_ref", "qmatmul_w8a8_qin",
           "qmatmul_w8a8_qin_ref", "qmatmul_w8a8_ref", "w8a8_epilogue"]
