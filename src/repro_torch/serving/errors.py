"""Typed error taxonomy for serving admission and fault handling (port of
``repro.serving.errors``). Every error derives from ``ServingError`` and
carries a ``retryable`` flag — the contract a client branches on: a
retryable rejection is back-pressure, to be retried after a delay; a
non-retryable one is a hard client error. ``RequestTooLarge`` IS-A
``ValueError`` and ``QueueFull`` / ``PoolExhausted`` ARE ``RuntimeError``s,
as in the JAX package, so handlers written against the bare exceptions
keep working."""
from __future__ import annotations


class ServingError(Exception):
    """Base of the serving taxonomy. ``retryable`` tells the client whether
    the same request can succeed later without modification."""

    retryable = False


class RequestTooLarge(ServingError, ValueError):
    """The request can never be admitted: its ring or page demand exceeds
    the engine's capacity outright. Not retryable."""


class QueueFull(ServingError, RuntimeError):
    """The bounded scheduler queue is full, or the engine is draining —
    back-pressure. Retryable."""

    retryable = True


class PoolExhausted(ServingError, RuntimeError):
    """No free slot (or, paged, not enough free pages) right now. Retryable;
    the engine normally absorbs it (head-of-line blocking, LRU eviction,
    preemption)."""

    retryable = True


class RequestCancelled(ServingError):
    """The client cancelled the request (``engine.cancel``); it was removed
    at the next step boundary. Not retryable."""


class DeadlineExceeded(ServingError):
    """The request's ``deadline`` passed before it completed: shed from the
    queue or cut short in flight. Retryable only with a new deadline, so
    ``retryable`` stays False."""


class CircuitOpen(ServingError, RuntimeError):
    """The async front-end's circuit breaker is open. Retryable: the
    breaker half-opens after its cooldown."""

    retryable = True


class ServerOverloaded(ServingError, RuntimeError):
    """The async front-end's priority-aware load shedder refused the
    request. Retryable after backoff."""

    retryable = True


def taxonomy() -> dict:
    """{class name: retryable flag} for every error in the serving taxonomy
    (all transitive ``ServingError`` subclasses), in the JAX package's
    order."""
    out = {}
    stack = [ServingError]
    while stack:
        cls = stack.pop()
        out[cls.__name__] = bool(cls.retryable)
        stack.extend(cls.__subclasses__())
    return out
