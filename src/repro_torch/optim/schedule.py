"""Learning-rate schedules — port of ``repro.optim.schedule``."""
from __future__ import annotations

import numpy as np
import torch

from ..data.libm import cosf


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_ratio · peak_lr`` at ``total``: a float32 tensor on the
    step's device (the CPU for a Python int).

    Bit-equal to the JAX function: the float32 operations run in its order
    (divisions as divisions, each Python constant rounded to float32 where
    JAX's weak typing rounds it, ``(1 - min_ratio) · 0.5`` folded in
    float64 first), on the host in numpy float32, with the C library's
    ``cosf`` (``data.libm``) — the cosine the JAX package's CPU backend
    takes. One host read of ``step`` a call; a training step already
    reads its loss."""
    f32 = np.float32
    device = step.device if isinstance(step, torch.Tensor) else None
    if isinstance(step, torch.Tensor):
        step = step.detach().cpu().numpy()
    s = np.asarray(step).astype(f32)
    warm = f32(peak_lr) * s / f32(max(warmup, 1))
    frac = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)),
                   f32(0), f32(1)).astype(f32)
    cos = f32(peak_lr) * (f32(min_ratio) + f32((1 - min_ratio) * 0.5)
                          * (f32(1) + cosf(f32(np.pi) * frac)))
    lr = np.where(s < f32(warmup), warm, cos).astype(f32)
    return torch.from_numpy(np.array(lr)).to(device or "cpu")
