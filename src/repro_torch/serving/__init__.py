"""Continuous-batching serving over a contiguous int8-KV slot pool (port of
``repro.serving``): the fast path (batched prefill, decode horizons, CUDA
graphs on the card) and the stepwise reference.

    engine = ServingEngine.from_quantized(qm, num_slots=8, max_len=128)
    engine.warmup()
    results = engine.run(synthetic_trace(0, 20, vocab_size=qm.cfg.vocab_size))
"""
from .cache_pool import CachePool
from .engine import RequestResult, ServingEngine, required_cache_len
from .errors import (
    PoolExhausted,
    QueueFull,
    RequestTooLarge,
    ServingError,
)
from .scheduler import FIFOScheduler, Request
from .trace import synthetic_trace

__all__ = ["CachePool", "FIFOScheduler", "PoolExhausted", "QueueFull",
           "Request", "RequestResult", "RequestTooLarge", "ServingEngine",
           "ServingError", "required_cache_len", "synthetic_trace"]
