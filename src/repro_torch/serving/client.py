"""Async client for ``AsyncServer``: bounded retry with backoff + jitter
(port of ``repro.serving.client``; the jitter draws are the reference's, bit
for bit, since both seed ``np.random.RandomState`` per ``(seed, rid)``).

The client is the other half of the ``errors.py`` contract: every rejection
the server raises carries a ``retryable`` flag, and the client branches on
NOTHING else — retryable errors (``QueueFull``, ``PoolExhausted``,
``CircuitOpen``, ``ServerOverloaded``) are retried with exponential backoff
and full jitter up to ``max_attempts``; non-retryable ones
(``RequestTooLarge``, ``RequestCancelled``, ``DeadlineExceeded``) fail
fast on the first raise. A request that is ADMITTED but expires inside the
engine is terminal too (the deadline doesn't reset), so an "expired" result
is never resubmitted.

Backoff sleeps ride ``server.wait_ticks`` — engine-tick time, not wall
clock — and the jitter RNG is seeded per ``(seed, rid)``, so a retry
schedule depends only on the trace and the seed, never on coroutine
interleaving. That determinism is what the chaos-under-load bench leans on.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .errors import ServingError
from .scheduler import Request
from .server import AsyncServer


@dataclasses.dataclass
class RetryPolicy:
    """Exponential backoff with full jitter, in engine ticks.

    Attempt ``k`` (0-based) failing retryably sleeps
    ``uniform(0, min(base * mult**k, max_backoff))`` ticks before attempt
    ``k+1`` — "full jitter" (AWS-style): the whole interval is randomized,
    which decorrelates a thundering herd far better than +/-epsilon jitter.
    """

    max_attempts: int = 4
    base_backoff: float = 4.0    # ticks
    multiplier: float = 2.0
    max_backoff: float = 64.0    # ticks, cap per sleep

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_backoff <= 0 or self.multiplier < 1 or self.max_backoff <= 0:
            raise ValueError("backoff parameters must be positive "
                             "(multiplier >= 1)")

    def backoff(self, attempt: int, rng: np.random.RandomState) -> float:
        cap = min(self.base_backoff * self.multiplier ** attempt,
                  self.max_backoff)
        return float(rng.uniform(0.0, cap))


@dataclasses.dataclass
class ClientOutcome:
    """What one request's full client-side lifecycle amounted to."""

    rid: int
    status: str                  # ok | expired | cancelled | quarantined |
    #                              shed (retries exhausted) | rejected
    #                              (non-retryable admission error)
    tokens: List[int]
    attempts: int                # submission attempts made (>= 1)
    arrival: float               # trace arrival tick
    first_token_tick: Optional[float]   # engine tick of token 0 (TTFT base)
    finished_tick: Optional[float]      # engine tick at terminal result
    token_ticks: List[float]     # engine tick per streamed token
    error: Optional[str] = None  # terminal error class name, if any

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token, in ticks from arrival."""
        if self.first_token_tick is None:
            return None
        return self.first_token_tick - self.arrival


class AsyncClient:
    """Per-request retry loop over one ``AsyncServer``.

    ``run(request)`` waits for the request's arrival tick (open-loop: the
    arrival never depends on other requests' completions), then attempts
    admission under the ``RetryPolicy``, streaming tokens once admitted.
    """

    def __init__(self, server: AsyncServer,
                 policy: Optional[RetryPolicy] = None, *,
                 seed: int = 0):
        self.server = server
        self.policy = policy if policy is not None else RetryPolicy()
        self.seed = seed

    def _rng(self, rid: int) -> np.random.RandomState:
        # per-rid stream: jitter is independent of which coroutine runs first
        return np.random.RandomState((self.seed * 1000003 + rid) % 2**31)

    async def run(self, request: Request, *,
                  timeout: Optional[float] = None) -> ClientOutcome:
        await self.server.wait_until(request.arrival)
        rng = self._rng(request.rid)
        attempts = 0
        last_error: Optional[ServingError] = None
        while attempts < self.policy.max_attempts:
            # resubmission happens at the current clock, which may be past
            # the trace arrival — reflect that or engine admission
            # (arrival <= clock) would hold the request forever
            req = request
            if self.server.clock > req.arrival:
                new_arrival = self.server.clock
                deadline = req.deadline
                if deadline is not None and deadline <= new_arrival:
                    # the original deadline already passed while backing off;
                    # submitting would be rejected at validation — give up
                    break
                req = dataclasses.replace(req, arrival=new_arrival)
            try:
                stream = self.server.submit(req, timeout=timeout)
            except ServingError as e:
                attempts += 1
                last_error = e
                if not e.retryable or attempts >= self.policy.max_attempts:
                    break
                await self.server.wait_ticks(
                    self.policy.backoff(attempts - 1, rng))
                continue
            attempts += 1
            tokens: List[int] = []
            ticks: List[float] = []
            async for tick, tok in stream:
                tokens.append(tok)
                ticks.append(tick)
            result = stream.result
            return ClientOutcome(
                rid=request.rid, status=result.status, tokens=tokens,
                attempts=attempts, arrival=request.arrival,
                first_token_tick=ticks[0] if ticks else None,
                finished_tick=result.finished_at,
                token_ticks=ticks,
            )
        status = ("shed" if last_error is not None and last_error.retryable
                  else "rejected")
        return ClientOutcome(
            rid=request.rid, status=status, tokens=[], attempts=attempts,
            arrival=request.arrival, first_token_tick=None,
            finished_tick=self.server.clock, token_ticks=[],
            error=type(last_error).__name__ if last_error else None,
        )
