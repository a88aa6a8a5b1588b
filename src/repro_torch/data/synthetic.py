"""Synthetic calibration inputs — port of ``repro.data.synthetic.
calibration_tokens``.

Empirical bias correction (paper appendix D) needs E[x] at each weight
site's input; with uniformly random token ids as the calibration source the
flow stays data-free. The ids are the JAX package's, bit for bit: they are
drawn on the host with the threefry generator of ``prng`` (numpy ``uint32``
arithmetic, as ``jax.random.randint`` draws them) and moved to the device,
so the card, the CPU and the JAX package calibrate on the same tokens.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..device import resolve_device
from . import prng


def _fold(seed: int, *salts: int):
    key = prng.PRNGKey(seed)
    for s in salts:
        key = prng.fold_in(key, s)
    return key


def calibration_tokens(seed: int, batch: int, seq: int, vocab: int, *,
                       device: Optional[Union[str, torch.device]] = "cuda"
                       ) -> torch.Tensor:
    """[batch, seq] int64 ids, uniform in [0, vocab): the ids of
    ``repro.data.synthetic.calibration_tokens(seed, batch, seq, vocab)``, on
    ``device`` (the card unless the caller asks for the CPU)."""
    ids = prng.randint(_fold(seed, 777), (batch, seq), 0, vocab)
    return torch.from_numpy(ids.astype("int64")).to(resolve_device(device))
