"""Synthetic data — port of ``repro.data.synthetic``: the training stream
(``token_batch``, ``TokenStream``), the data-free flow's calibration ids
(``calibration_tokens``) and the CNN's images (``synthetic_image_batch``).

Every batch is a pure function of (seed, step, shard), so a replayed or
resumed step reads the same data, whatever the world size.

Empirical bias correction (paper appendix D) needs E[x] at each weight
site's input; with uniformly random token ids as the calibration source the
flow stays data-free. The ids are the JAX package's, bit for bit: they are
drawn on the host with the threefry generator of ``prng`` (numpy ``uint32``
arithmetic, as ``jax.random.randint`` draws them) and moved to the device,
so the card, the CPU and the JAX package calibrate on the same tokens.
The training ids are the JAX package's bit for bit as well (see
``token_batch`` for the one hazard). The CNN's images are drawn the same way: their labels are the JAX package's bit
for bit, their pixels within 1e-6 (numpy's float32 ``sin``, ``cos`` and
``prng.normal`` round other than XLA's).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from . import prng
from .libm import powf


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


def token_batch(seed: int, step: int, shard: int, batch: int, seq: int,
                vocab: int, *,
                device: Optional[Union[str, torch.device]] = "cuda") -> dict:
    """One shard's {"tokens", "labels"} [batch, seq] int64 for a step, on
    ``device``: the ids of ``repro.data.synthetic.token_batch`` with the
    same arguments, bit for bit. A Zipf marginal — ``int32(u^(-1/1.1) - 1)``
    of u uniform on [1e-6, 1), clipped to the vocabulary — and at every odd
    position, with probability 1/2 (``bernoulli``: a uniform draw below
    0.5), a repeat of the previous position's id (the ``roll``), so the
    bigrams are learnable; the labels are the tokens shifted by one.

    Hazard: the float32 ``pow`` decides the truncation wherever
    ``u^(-1/1.1) - 1`` lies within an ulp of an integer. numpy's float32
    ``power`` differs from the JAX package's in the last place for one
    value in five, PyTorch's for one in fifty, float64 rounded to float32
    for one in two thousand; the C library's ``powf`` (``data.libm``),
    which the JAX package's CPU backend calls, agrees with it on every
    value, so the ids are drawn with it, on the host."""
    k1, k2, _ = prng.split(_fold(seed, step, shard), 3)
    u = prng.uniform(k1, (batch, seq + 1), 1e-6, 1.0)
    zipf = np.clip((powf(u, -1.0 / 1.1) - np.float32(1)).astype(np.int32),
                   0, vocab - 1)
    rep = prng.uniform(k2, (batch, seq + 1)) < np.float32(0.5)
    odd = np.arange(seq + 1) % 2 == 1
    toks = np.where(rep & odd, np.roll(zipf, 1, axis=1), zipf)
    t = torch.from_numpy(toks.astype(np.int64)).to(resolve_device(device))
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


@dataclasses.dataclass
class TokenStream:
    """A shard's stateless stream (the train launcher's data): ``batch(step)``
    is ``token_batch`` of this shard at that step, on ``device``."""

    seed: int
    shard: int
    n_shards: int
    batch_per_shard: int
    seq: int
    vocab: int
    device: Optional[Union[str, torch.device]] = "cuda"

    def batch(self, step: int) -> dict:
        return token_batch(self.seed, step, self.shard, self.batch_per_shard,
                           self.seq, self.vocab, device=self.device)
