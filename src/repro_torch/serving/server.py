"""Overload-safe asyncio streaming front-end over ``ServingEngine`` (port
of ``repro.serving.server``: the same classes, counters and order of
decisions, over the port's engine).

``AsyncServer`` owns the engine's step loop inside an asyncio event loop and
streams tokens per request as the engine produces them (the engine's
``set_stream_callbacks`` surface — callbacks fire at host syncs the engine
performs anyway, so streaming costs zero extra round trips). Admission is
wrapped in a real resilience stack, applied in a **documented degradation
order** per submission:

  1. **circuit breaker** (``CircuitBreaker``) — a sliding window over recent
     engine admissions; when the failure fraction crosses the threshold the
     breaker OPENS and the server sheds at its own door (``CircuitOpen``,
     retryable) instead of hammering the engine queue. After a cooldown it
     half-opens: the next submission is a probe whose outcome closes or
     re-opens it. The breaker sheds BEFORE the queue does — that is its job.
  2. **priority-aware load shedding** (``ShedPolicy``) — queue pressure
     (queue depth / bound) climbs three rungs:
     ``shed_pressure``: reject the lowest priority class
     (``priority < shed_priority_below``) with the retryable
     ``ServerOverloaded``; ``tighten_pressure``: still admit, but shrink the
     accepted deadline to at most ``tightened_slack`` ticks (expired work is
     cut early instead of occupying slots past its usefulness);
     ``refuse_pressure``: refuse EVERY new request (retryable — pressure is
     re-measured per attempt). Shutdown reuses the engine's
     ``request_drain()`` (the SIGTERM contract): admission closes for good,
     in-flight and parked requests finish.
  3. **engine back-pressure** — whatever survives the rungs reaches
     ``engine.submit``, whose bounded queue raises the retryable
     ``QueueFull``; those rejections (and rung-3 refusals) feed the
     breaker's window.

Per-request **timeouts** are wired to the engine's own ``deadline``
enforcement: ``submit(request, timeout=T)`` caps the deadline at
``max(clock, arrival) + T``, and the engine reaps it tick-exactly on both
serve paths — the server never needs a second timer.

**Determinism.** The server uses NO wall-clock timers: time is the engine
tick (``engine.clock``), client sleeps (`wait_until`/`wait_ticks`) are
released by the step loop in ``(tick, submission order)`` order, and the
step loop advances the engine even when only sleepers remain (an idle step
moves the clock 1 tick and launches nothing: with no slot in flight neither
serve path dispatches, so no CUDA graph is replayed). Given a seeded trace
and seeded retry jitter, a full open-loop run — retries, breaker state,
shed decisions, streamed tokens and their ticks — is bit-reproducible,
which is what lets the SLO bench assert chaos-under-load parity.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import heapq
import itertools
import math
from typing import Callable, Optional, Sequence

from .engine import RequestResult, ServingEngine
from .errors import CircuitOpen, ServerOverloaded, ServingError
from .scheduler import Request


class CircuitBreaker:
    """Sliding-window circuit breaker over engine admission outcomes.

    closed → (failure fraction over the last ``window`` admissions >=
    ``failure_threshold``, with at least ``min_volume`` samples) → open →
    (``cooldown`` ticks pass) → half_open → one probe admission: success
    closes, failure re-opens. Opening clears the window so a recovered
    engine starts from a clean slate.
    """

    def __init__(self, window: int = 32, failure_threshold: float = 0.5,
                 min_volume: int = 8, cooldown: float = 16.0):
        if not 0.0 < failure_threshold <= 1.0:
            raise ValueError(
                f"failure_threshold must be in (0, 1], got {failure_threshold}")
        if window < 1 or min_volume < 1 or cooldown <= 0:
            raise ValueError("window/min_volume must be >= 1, cooldown > 0")
        self.window = window
        self.failure_threshold = failure_threshold
        self.min_volume = min_volume
        self.cooldown = cooldown
        self.state = "closed"                    # closed | open | half_open
        self.opens = 0
        self._events: collections.deque = collections.deque(maxlen=window)
        self._opened_at = 0.0

    def allow(self, now: float) -> bool:
        """Whether a submission may proceed at tick ``now``. In the open
        state this transitions to half_open once the cooldown has elapsed —
        the allowed submission is the probe."""
        if self.state == "open":
            if now - self._opened_at >= self.cooldown:
                self.state = "half_open"
                return True
            return False
        return True

    def record(self, ok: bool, now: float) -> None:
        """Feed an admission outcome. Must follow a permitted ``allow``."""
        if self.state == "half_open":
            if ok:
                self.state = "closed"
                self._events.clear()
            else:
                self._open(now)
            return
        self._events.append(ok)
        if (self.state == "closed"
                and len(self._events) >= self.min_volume):
            failures = sum(1 for e in self._events if not e)
            if failures / len(self._events) >= self.failure_threshold:
                self._open(now)

    def _open(self, now: float) -> None:
        self.state = "open"
        self._opened_at = now
        self.opens += 1
        self._events.clear()


@dataclasses.dataclass
class ShedPolicy:
    """Priority-aware load-shedding rungs, keyed on queue pressure =
    queue depth / bound (the engine's ``max_queue`` when set, else
    ``soft_queue``, else ``4 * num_slots``). The rungs degrade in order:
    shed the lowest priority class, then tighten accepted deadlines, then
    refuse everything — each retryable, so clients back off and the system
    recovers instead of collapsing."""

    shed_pressure: float = 0.5       # rung 1 trigger
    shed_priority_below: int = 1     # rung 1 victim classes (priority < this)
    tighten_pressure: float = 0.75   # rung 2 trigger
    tightened_slack: float = 64.0    # rung 2 deadline cap (ticks from now)
    refuse_pressure: float = 1.0     # rung 3 trigger
    soft_queue: Optional[int] = None  # pressure bound for unbounded queues

    def __post_init__(self):
        if not (0.0 < self.shed_pressure <= self.tighten_pressure
                <= self.refuse_pressure):
            raise ValueError(
                "shed rungs must satisfy 0 < shed <= tighten <= refuse "
                f"(got {self.shed_pressure}/{self.tighten_pressure}/"
                f"{self.refuse_pressure})")
        if self.tightened_slack <= 0:
            raise ValueError("tightened_slack must be > 0 ticks")


class RequestStream:
    """Async iterator over one request's generated tokens.

    Yields ``(tick, token)`` pairs as the engine materializes them;
    iteration ends when the request reaches a terminal status, after which
    ``.result`` holds its ``RequestResult`` (any status — ok / expired /
    cancelled / quarantined). Tokens already streamed are always a prefix
    of ``result.tokens``.
    """

    def __init__(self, rid: int):
        self.rid = rid
        self.result: Optional[RequestResult] = None
        self._pending: collections.deque = collections.deque()
        self._wake = asyncio.Event()

    def _push(self, tick: float, token: int) -> None:
        self._pending.append((tick, token))
        self._wake.set()

    def _finish(self, result: RequestResult) -> None:
        self.result = result
        self._wake.set()

    def __aiter__(self) -> "RequestStream":
        return self

    async def __anext__(self):
        while True:
            if self._pending:
                return self._pending.popleft()
            if self.result is not None:
                raise StopAsyncIteration
            self._wake.clear()
            await self._wake.wait()

    async def drain(self) -> RequestResult:
        """Consume the remaining tokens and return the terminal result."""
        async for _ in self:
            pass
        return self.result


class AsyncServer:
    """Asyncio front-end over one ``ServingEngine`` (module docstring).

    Lifecycle::

        server = AsyncServer(engine)
        server.start()                 # spawns the step-loop task
        stream = server.submit(req, timeout=64.0)
        async for tick, tok in stream: ...
        await server.aclose()          # request_drain + finish in flight

    ``pre_step`` / ``post_step`` hooks receive the step index (number of
    ``engine.step()`` calls) and run inside the loop — the chaos harness
    injects faults and audits pool invariants through them.
    """

    def __init__(self, engine: ServingEngine, *,
                 breaker: Optional[CircuitBreaker] = None,
                 shed: Optional[ShedPolicy] = None,
                 pre_step: Sequence[Callable[[int], None]] = (),
                 post_step: Sequence[Callable[[int], None]] = ()):
        self.engine = engine
        self.breaker = CircuitBreaker() if breaker is None else breaker
        self.shed = ShedPolicy() if shed is None else shed
        self.pre_step = list(pre_step)
        self.post_step = list(post_step)
        self.steps = 0
        self.stats = {
            "submitted": 0,           # submission attempts seen
            "accepted": 0,            # reached the engine queue
            "shed_breaker": 0,        # rejected while the breaker was open
            "shed_priority": 0,       # rung 1: lowest-class shed
            "shed_refused": 0,        # rung 3: refuse-all shed
            "shed_queue": 0,          # engine-level retryable rejections
            "deadlines_tightened": 0,  # rung 2 applications
            "results": collections.Counter(),  # terminal status → count
        }
        self._streams: dict[int, RequestStream] = {}
        self._waiters: list = []      # heap of (tick, seq, future)
        self._seq = itertools.count()
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._closed = False
        engine.set_stream_callbacks(self._on_token, self._on_result)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._task is not None:
            raise RuntimeError("server already started")
        self._task = asyncio.ensure_future(self._loop())

    def drain(self) -> None:
        """Close admission for good — the engine's ``request_drain()``
        (SIGTERM semantics): queued-but-unadmitted requests stay unserved,
        in-flight and parked requests finish. New submissions shed with the
        retryable ``QueueFull``."""
        self.engine.request_drain()
        self._wake.set()

    async def aclose(self) -> None:
        """Drain, finish everything in flight, release every sleeper, and
        stop the step loop."""
        self.drain()
        self._closed = True
        self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None

    @property
    def clock(self) -> float:
        return self.engine.clock

    # ------------------------------------------------------------ admission
    def _pressure(self) -> float:
        bound = self.engine.scheduler.max_queue or self.shed.soft_queue \
            or 4 * self.engine.num_slots
        return self.engine.scheduler.pending() / bound

    def submit(self, request: Request, *,
               timeout: Optional[float] = None) -> RequestStream:
        """Run one submission through the full resilience ladder (module
        docstring order) and return its token stream. Raises the typed
        taxonomy: retryable ``CircuitOpen`` / ``ServerOverloaded`` /
        ``QueueFull`` (back off and resubmit), non-retryable
        ``RequestTooLarge`` (never resubmit). ``timeout`` caps the
        engine-enforced deadline at ``max(clock, arrival) + timeout``."""
        self.stats["submitted"] += 1
        if request.rid in self._streams:
            raise ValueError(f"request {request.rid} is already in flight")
        now = self.engine.clock
        if not self.breaker.allow(now):
            self.stats["shed_breaker"] += 1
            raise CircuitOpen(
                f"request {request.rid}: circuit breaker is open "
                f"(cooldown {self.breaker.cooldown} ticks) — back off"
            )
        pressure = self._pressure()
        if pressure >= self.shed.refuse_pressure:
            # rung 3 — the queue is effectively full for everyone; this IS
            # queue pressure, so it feeds the breaker's window
            self.stats["shed_refused"] += 1
            self.breaker.record(False, now)
            raise ServerOverloaded(
                f"request {request.rid}: queue pressure {pressure:.2f} >= "
                f"{self.shed.refuse_pressure} — refusing all new requests"
            )
        if (pressure >= self.shed.shed_pressure
                and request.priority < self.shed.shed_priority_below):
            self.stats["shed_priority"] += 1
            raise ServerOverloaded(
                f"request {request.rid}: queue pressure {pressure:.2f} — "
                f"shedding priority < {self.shed.shed_priority_below}"
            )
        base = max(now, request.arrival)
        deadline = request.deadline
        if timeout is not None:
            deadline = min(deadline if deadline is not None else math.inf,
                           base + timeout)
        if pressure >= self.shed.tighten_pressure:
            tightened = base + self.shed.tightened_slack
            if deadline is None or tightened < deadline:
                deadline = tightened
                self.stats["deadlines_tightened"] += 1
        if deadline != request.deadline:
            request = dataclasses.replace(request, deadline=deadline)
        try:
            self.engine.submit(request)
        except ServingError as e:
            if e.retryable:
                self.stats["shed_queue"] += 1
                self.breaker.record(False, now)
            raise
        self.breaker.record(True, now)
        self.stats["accepted"] += 1
        stream = RequestStream(request.rid)
        self._streams[request.rid] = stream
        self._wake.set()
        return stream

    async def serve(self, request: Request, *,
                    timeout: Optional[float] = None) -> RequestResult:
        """Submit and consume to completion (no per-token streaming)."""
        return await self.submit(request, timeout=timeout).drain()

    # ------------------------------------------------------------- sleeping
    async def wait_until(self, tick: float) -> None:
        """Sleep until ``engine.clock >= tick`` — released by the step loop
        in (tick, registration) order, so wakeups are deterministic."""
        if self.engine.clock >= tick:
            return
        fut = asyncio.get_running_loop().create_future()
        heapq.heappush(self._waiters, (tick, next(self._seq), fut))
        self._wake.set()
        await fut

    async def wait_ticks(self, n: float) -> None:
        await self.wait_until(self.engine.clock + n)

    # ------------------------------------------------------------- step loop
    def _engine_busy(self) -> bool:
        e = self.engine
        return bool(e._inflight or e._parked
                    or (not e.draining and e.scheduler.pending()))

    async def _loop(self) -> None:
        while True:
            busy = self._engine_busy() or bool(self._waiters)
            if not busy:
                if self._closed:
                    return
                self._wake.clear()
                if self._engine_busy() or self._waiters or self._closed:
                    continue
                await self._wake.wait()
                continue
            for hook in self.pre_step:
                hook(self.steps)
            self.engine.step()
            self.steps += 1
            for hook in self.post_step:
                hook(self.steps)
            self._release_waiters()
            # one cooperative yield per engine step: every coroutine woken
            # by this step's tokens/results/sleeps runs before the next step
            await asyncio.sleep(0)

    def _release_waiters(self) -> None:
        clock = self.engine.clock
        while self._waiters and self._waiters[0][0] <= clock:
            _, _, fut = heapq.heappop(self._waiters)
            if not fut.done():
                fut.set_result(None)

    # ----------------------------------------------------- engine callbacks
    def _on_token(self, rid: int, tokens: list, tick: float) -> None:
        stream = self._streams.get(rid)
        if stream is None:
            return
        for i, tok in enumerate(tokens):
            stream._push(tick + i, int(tok))

    def _on_result(self, result: RequestResult) -> None:
        self.stats["results"][result.status] += 1
        stream = self._streams.pop(result.rid, None)
        if stream is not None:
            stream._finish(result)
