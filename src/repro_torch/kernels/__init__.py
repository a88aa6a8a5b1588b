"""The port's kernels: a CUDA kernel and its plain PyTorch version per op,
resolved by the input's device (``dispatch``)."""
from . import (  # noqa: F401  (register)
    fused_decode,
    kv_attention,
    qmatmul_w8a8,
    qmatmul_w8a16,
    quantize_act,
)
from .dispatch import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts"]
