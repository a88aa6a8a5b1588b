"""The port's kernels: a CUDA kernel and its plain PyTorch version per op,
resolved by the input's device (``dispatch``)."""
from . import fused_decode, qmatmul_w8a8, quantize_act  # noqa: F401  (register)
from .dispatch import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts"]
