"""JAX's default PRNG (threefry2x32) in numpy ``uint32`` arithmetic.

The port draws its synthetic calibration ids, its synthetic images and the
CNN's initial weights as the JAX package does, with no JAX import:
``PRNGKey``, ``fold_in``, ``split``, ``random_bits`` and ``randint`` below
reproduce ``jax.random``'s results bit for bit under jax's defaults (the ``threefry2x32`` implementation,
``jax_threefry_partitionable=True``, 32-bit integers). Every step is an
exact integer operation on ``uint32`` words, wrapping modulo 2**32.

A key is a ``uint32`` array of shape (2,), as ``jax.random.key_data``
gives it. ``uniform`` is ``jax.random.uniform``'s float32 result bit for
bit (the bits as a mantissa, then one fused multiply-add). ``normal`` is
``jax.random.normal``'s float32 result within 4 ulp: √2 · erf⁻¹(u) with
XLA's float32 ``erf_inv`` evaluated in numpy float32, whose ``log1p`` and
``sqrt`` may round other than XLA's.
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


def uniform(key: np.ndarray, shape, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` as the
    JAX package computes it on the CPU: 23 random bits as the mantissa of a
    float in [1, 2), minus 1, scaled to the span and clamped below at
    ``minval`` (``jax._src.random._uniform``)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(_U32)
    floats = ((bits >> _U32(32 - 23)) | one).view(np.float32) - np.float32(1)
    # XLA's CPU backend contracts the scale and shift into one fused
    # multiply-add: the float64 product of two float32 values is exact, so
    # one rounding of the float64 sum to float32 is the fused result
    scaled = floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)
    return np.maximum(lo, scaled.astype(np.float32))


# XLA's float32 erf_inv (Giles, "Approximating the erfinv function"): the
# coefficients of the polynomials in w - 2.5 (w < 5) and sqrt(w) - 3
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv`` (its chlo decomposition), in numpy float32:
    w = -log1p(-x²), a degree-8 polynomial in w - 2.5 or sqrt(w) - 3, times
    x; ±inf at |x| = 1."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(x * -x)
        lt = w < np.float32(5)
        w = np.where(lt, w - np.float32(2.5),
                     np.sqrt(w) - np.float32(3)).astype(np.float32)
        p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
        for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
            p = np.where(lt, np.float32(a), np.float32(b)) + p * w
        return np.where(np.abs(x) < np.float32(1), p * x,
                        x * np.float32(np.inf)).astype(np.float32)


def normal(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)`` within 4 ulp: √2 · erf⁻¹(u), u
    uniform on (nextafter(-1, 0), 1) (``jax._src.random._normal_real``)."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erf_inv(u)).astype(np.float32)
