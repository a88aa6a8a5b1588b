"""Synthetic calibration inputs — port of ``repro.data.synthetic.
calibration_tokens``.

Empirical bias correction (paper appendix D) needs E[x] at each weight
site's input; with uniformly random token ids as the calibration source the
flow stays data-free.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def calibration_tokens(seed: int, batch: int, seq: int, vocab: int, *,
                       device: Optional[Union[str, torch.device]] = "cpu"
                       ) -> torch.Tensor:
    """[batch, seq] int64 ids, uniform in [0, vocab), drawn on the host from
    a ``torch.Generator`` seeded with ``seed`` and moved to ``device`` — so
    the card and the CPU calibrate on the same ids. They are not the ids of
    the JAX package's ``calibration_tokens`` (``jax.random.randint`` draws
    differently); parity tests pass the JAX ids in instead."""
    gen = torch.Generator().manual_seed(int(seed))
    toks = torch.randint(0, vocab, (batch, seq), generator=gen)
    return toks.to(device)
