"""Continuous-batching serving: the stepwise engine over a contiguous
int8-KV slot pool (port of ``repro.serving``)."""
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
