"""Continuous-batching serving over a contiguous or paged int8/fp KV pool
(port of ``repro.serving``): the fast path (batched prefill, decode
horizons, CUDA graphs on the card) and the stepwise reference; the paged
pool's copy-on-write prefix reuse; deadlines, cancellation, preemption,
drain and quarantine; and the chaos harness.

    engine = ServingEngine.from_quantized(qm, num_slots=8, max_len=128,
                                          page_size=32)
    engine.warmup()
    results = engine.run(synthetic_trace(0, 20, vocab_size=qm.cfg.vocab_size))
"""
from .cache_pool import CachePool
from .chaos import (
    ChaosReport,
    FaultInjector,
    FaultPlan,
    assert_unfaulted_parity,
    count_leaked_pages,
    run_chaos,
)
from .engine import RequestResult, ServingEngine, required_cache_len
from .errors import (
    CircuitOpen,
    DeadlineExceeded,
    PoolExhausted,
    QueueFull,
    RequestCancelled,
    RequestTooLarge,
    ServerOverloaded,
    ServingError,
    taxonomy,
)
from .scheduler import FIFOScheduler, PrefixIndex, Request
from .trace import synthetic_trace

__all__ = ["CachePool", "ChaosReport", "CircuitOpen", "DeadlineExceeded",
           "FIFOScheduler", "FaultInjector", "FaultPlan", "PoolExhausted",
           "PrefixIndex", "QueueFull", "Request", "RequestCancelled",
           "RequestResult", "RequestTooLarge", "ServerOverloaded",
           "ServingEngine", "ServingError", "assert_unfaulted_parity",
           "count_leaked_pages", "required_cache_len", "run_chaos",
           "synthetic_trace", "taxonomy"]
