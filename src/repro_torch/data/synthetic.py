"""Synthetic data for the data-free flow — port of ``repro.data.synthetic``'s
``calibration_tokens`` and ``synthetic_image_batch``.

Empirical bias correction (paper appendix D) needs E[x] at each weight
site's input; with uniformly random token ids as the calibration source the
flow stays data-free. The ids are the JAX package's, bit for bit: they are
drawn on the host with the threefry generator of ``prng`` (numpy ``uint32``
arithmetic, as ``jax.random.randint`` draws them) and moved to the device,
so the card, the CPU and the JAX package calibrate on the same tokens. The
CNN's images are drawn the same way: their labels are the JAX package's bit
for bit, their pixels within 1e-6 (numpy's float32 ``sin``, ``cos`` and
``prng.normal`` round other than XLA's).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
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


def synthetic_image_batch(seed: int, step: int, batch: int, size: int,
                          channels: int, classes: int, *,
                          device: Optional[Union[str, torch.device]] = "cuda"
                          ) -> dict:
    """{"x": [batch, size, size, channels] float32 NHWC, "y": [batch] int64}:
    class-conditional 2-D frequency gratings plus noise, the batch of
    ``repro.data.synthetic.synthetic_image_batch`` with the same arguments,
    on ``device``. Each float32 operation runs in the JAX function's order;
    the noise is added with one rounding, as XLA's CPU backend fuses
    ``base + 0.3 · noise``."""
    k1, k2, k3 = prng.split(_fold(seed, step), 3)
    y = prng.randint(k1, (batch,), 0, classes)
    xx, yy = np.meshgrid(np.arange(size, dtype=np.int32),
                         np.arange(size, dtype=np.int32))
    f32 = np.float32
    freq = (y[:, None, None] + 1).astype(f32) * f32(0.5)
    phase = prng.uniform(k3, (batch, 1, 1)) * f32(2) * f32(np.pi)

    def wave(grid):
        return freq * grid[None].astype(f32) * f32(2) * f32(np.pi) / f32(size)

    base = np.sin(wave(xx) + phase) * np.cos(wave(yy))
    noise = prng.normal(k2, (batch, size, size, channels))
    x = (base[..., None].astype(np.float64)
         + np.float64(f32(0.3)) * noise.astype(np.float64)).astype(f32)
    dev = resolve_device(device)
    return {"x": torch.from_numpy(x).to(dev),
            "y": torch.from_numpy(y.astype(np.int64)).to(dev)}
