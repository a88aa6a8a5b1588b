"""Continuous-batching serving over a contiguous or paged int8/fp KV pool
(port of ``repro.serving``): the fast path (batched prefill, decode
horizons, CUDA graphs on the card) and the stepwise reference; the paged
pool's copy-on-write prefix reuse; deadlines, cancellation, preemption,
drain and quarantine; the chaos harness; and the overload-safe async
front-end (circuit breaker, shedding ladder, client retry with backoff and
jitter, open-loop Poisson load and its SLO view).

    engine = ServingEngine.from_quantized(qm, num_slots=8, max_len=128,
                                          page_size=32)
    engine.warmup()
    results = engine.run(synthetic_trace(0, 20, vocab_size=qm.cfg.vocab_size))

Or stream per request through the async front-end:

    server = AsyncServer(engine)
    client = AsyncClient(server, RetryPolicy(), seed=0)
    outcomes = asyncio.run(run_open_loop(server, client, trace))
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
from .client import AsyncClient, ClientOutcome, RetryPolicy
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
from .loadgen import SLO, open_loop_trace, run_open_loop, summarize
from .scheduler import FIFOScheduler, PrefixIndex, Request
from .server import AsyncServer, CircuitBreaker, RequestStream, ShedPolicy
from .trace import synthetic_trace

__all__ = ["AsyncClient", "AsyncServer", "CachePool", "ChaosReport",
           "CircuitBreaker", "CircuitOpen", "ClientOutcome",
           "DeadlineExceeded", "FIFOScheduler", "FaultInjector", "FaultPlan",
           "PoolExhausted", "PrefixIndex", "QueueFull", "Request",
           "RequestCancelled", "RequestResult", "RequestStream",
           "RequestTooLarge", "RetryPolicy", "SLO", "ServerOverloaded",
           "ServingEngine", "ServingError", "ShedPolicy",
           "assert_unfaulted_parity", "count_leaked_pages", "open_loop_trace",
           "required_cache_len", "run_chaos", "run_open_loop", "summarize",
           "synthetic_trace", "taxonomy"]
