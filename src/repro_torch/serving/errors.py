"""Typed error taxonomy for serving admission (port of
``repro.serving.errors``). Every error derives from ``ServingError`` and
carries a ``retryable`` flag; ``RequestTooLarge`` IS-A ``ValueError`` and
``QueueFull`` / ``PoolExhausted`` ARE ``RuntimeError``s, as in the JAX
package."""
from __future__ import annotations


class ServingError(Exception):
    """Base of the serving taxonomy."""

    retryable = False


class RequestTooLarge(ServingError, ValueError):
    """The request can never be admitted: its ring demand exceeds the
    engine's capacity. Not retryable."""


class QueueFull(ServingError, RuntimeError):
    """The bounded scheduler queue is full — back-pressure. Retryable."""

    retryable = True


class PoolExhausted(ServingError, RuntimeError):
    """No free slot right now. Retryable."""

    retryable = True
