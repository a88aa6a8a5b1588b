"""Adversarial channel rescaling — the inverse of CLE (port of
``repro.core.adversarial``).

Uses the same positive-scaling equivariance DFQ exploits to inject random
per-channel scales into a model's exact equalization pairs: the fp32
function is unchanged (up to float rounding) but per-tensor INT8
collapses. This reproduces the paper's hard-to-quantize MobileNetV2
starting point for models initialized here, so that the recovery
experiments are honest: DFQ must undo arbitrary hostile scalings.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data import prng
from .graph import DFQPlan, DensePairOp
from .tree import get_path, set_path


def hostile_rescale(params, plan: DFQPlan, *, seed: int = 0,
                    decades: float = 1.5):
    """Randomly rescale every exact DensePair (up↔down) in the plan:
    log-normal scales spanning ~``decades`` orders of magnitude, one a
    channel of every leading index (each layer's, and each expert's of an
    MoE block's stacked ``[L, E, ...]`` pairs). The scales
    are the JAX package's draws for the seed (``prng.normal``, within 4
    ulp), exponentiated in numpy float32 on the host."""
    key = prng.PRNGKey(seed)
    for op in plan.ops:
        if isinstance(op, DensePairOp) and op.exact:
            w1 = get_path(params, op.w1)
            w2 = get_path(params, op.w2)
            key, k = prng.split(key)
            n = prng.normal(k, tuple(w1.shape[:-2]) + tuple(w1.shape[-1:]))
            s = torch.from_numpy(np.exp(n * np.float32(decades))).to(w1.device)
            params = set_path(params, op.w1, w1 * s[..., None, :])
            params = set_path(params, op.w2, w2 / s[..., :, None])
    return params
