"""JAX's default PRNG (threefry2x32) in numpy ``uint32`` arithmetic.

The port draws its synthetic calibration ids exactly as the JAX package
does, with no JAX import: ``PRNGKey``, ``fold_in``, ``split``,
``random_bits`` and ``randint`` below reproduce ``jax.random``'s results
bit for bit under jax's defaults (the ``threefry2x32`` implementation,
``jax_threefry_partitionable=True``, 32-bit integers). Every step is an
exact integer operation on ``uint32`` words, wrapping modulo 2**32.

A key is a ``uint32`` array of shape (2,), as ``jax.random.key_data``
gives it. ``uniform`` and ``normal`` are not here: they are not on the
calibration path, and ``normal``'s ``erf_inv`` would not be bit-equal.
"""
from __future__ import annotations

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = _U32(0x1BD11BDA)


def _rotl(v: np.ndarray, d: int) -> np.ndarray:
    return (v << _U32(d)) | (v >> _U32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the word pairs (x0, x1) under
    ``key``, as ``jax._src.prng._threefry2x32_lowering``."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def _seed_words(value: int) -> np.ndarray:
    """``threefry_seed`` of a 32-bit integer: (0, value mod 2**32)."""
    value = int(value)
    if not -2 ** 31 <= value < 2 ** 32:
        raise ValueError(f"seed {value} does not fit 32 bits (jax's default "
                         f"integers are 32-bit)")
    return np.array([0, value & 0xFFFFFFFF], _U32)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s key data."""
    return _seed_words(seed)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of (0, data) under key."""
    words = _seed_words(data)
    y0, y1 = threefry2x32(key, words[:1], words[1:])
    return np.concatenate([y0, y1])


def _iota_2x32(shape) -> tuple:
    """The row-major flat index over ``shape`` as (high, low) words."""
    n = int(np.prod(shape, dtype=np.int64))
    flat = np.arange(n, dtype=np.uint64).reshape(shape)
    return ((flat >> np.uint64(32)).astype(_U32),
            (flat & np.uint64(0xFFFFFFFF)).astype(_U32))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``'s key data [num, 2] (the partitionable
    form: key i is the hash of the counter i)."""
    hi, lo = _iota_2x32((num,))
    b0, b1 = threefry2x32(key, hi, lo)
    return np.stack([b0, b1], axis=-1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)``: each element hashes its flat
    index, and the two output words are XOR-ed."""
    hi, lo = _iota_2x32(tuple(shape))
    b0, b1 = threefry2x32(key, hi, lo)
    return b0 ^ b1


def randint(key: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` as int32: two draws
    of 32 bits, reduced modulo the span with ``2**32 mod span`` carried
    between them (``jax._src.random._randint``), in wrapping uint32."""
    lo_i, hi_i = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    minval = int(np.clip(minval, lo_i, hi_i))
    maxval_in = int(maxval)
    maxval = int(np.clip(maxval_in, lo_i, hi_i))
    k1, k2 = split(key, 2)
    higher = random_bits(k1, shape)
    lower = random_bits(k2, shape)
    span = _U32((maxval - minval) & 0xFFFFFFFF)
    if maxval <= minval:
        span = _U32(1)
    elif maxval_in > hi_i:
        span = _U32((int(span) + 1) & 0xFFFFFFFF)
    with np.errstate(over="ignore", divide="ignore"):
        mult = _U32(2 ** 16) % span if span else _U32(2 ** 16)
        mult = (mult * mult) % span if span else mult * mult
        if span:
            off = (higher % span) * mult + lower % span
            off = off % span
        else:                     # span 2**32 wrapped to 0: rem is a no-op
            off = higher * mult + lower
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)
