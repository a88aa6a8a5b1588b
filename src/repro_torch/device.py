"""Device selection for the port's entry points.

Every entry point (``serve``, ``ServingEngine``, ``LMModel.init``) runs on
the card unless the caller passes ``device="cpu"``: on a host without CUDA
a default or explicit CUDA device raises here instead of quietly running
the plain PyTorch versions on the CPU. ``meta`` builds shapes without
memory (``models.cache_specs``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = "cuda"
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on an NVIDIA GPU by default, but torch sees no "
            "CUDA device; pass device='cpu' to run the plain PyTorch "
            "versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}: cuda or cpu (meta for "
                         f"shape specs)")
    return dev
