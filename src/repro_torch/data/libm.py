"""The C library's float32 ``powf`` and ``cosf``, element by element.

The JAX package's CPU backend evaluates float32 ``pow`` and ``cos`` through
the C library's ``powf`` / ``cosf``; numpy's and PyTorch's float32
versions (SIMD polynomials) round other than they do in the last place,
and so does float64 rounded to float32 (in about one value of 2,000 for
``pow``). Where a port needs those bits — the Zipf ids of ``token_batch``,
whose truncation flips wherever ``u^(-1/1.1) - 1`` lies within an ulp of
an integer, and the cosine learning-rate schedule — it calls these. The
library is loaded at the first call, not at import.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np


@functools.lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for name, n in (("powf", 2), ("cosf", 1)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_float] * n
        fn.restype = ctypes.c_float
    return lib


def powf(x: np.ndarray, y: float) -> np.ndarray:
    """``powf(x, y)`` of every element of the float32 array ``x``, the
    float32 exponent ``y`` (as a JAX weak-typed scalar rounds to)."""
    x = np.asarray(x, np.float32)
    fn, e = _lib().powf, float(np.float32(y))
    out = np.fromiter((fn(v, e) for v in x.ravel().tolist()), np.float32,
                      count=x.size)
    return out.reshape(x.shape)


def cosf(x: np.ndarray) -> np.ndarray:
    """``cosf`` of every element of the float32 array ``x``."""
    x = np.asarray(x, np.float32)
    fn = _lib().cosf
    out = np.fromiter((fn(v) for v in x.ravel().tolist()), np.float32,
                      count=x.size)
    return out.reshape(x.shape)
