"""Request model + FIFO admission scheduler (port of
``repro.serving.scheduler``; the paged pool's ``PrefixIndex`` is a later
slice). A request is admitted only at the head of the queue, once it has
arrived and a cache slot is free — later requests never jump an earlier
one."""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Sequence

from .errors import QueueFull


@dataclasses.dataclass
class Request:
    """One generation request.

    prompt: token ids, length >= 1. max_new_tokens: tokens to generate
    (>= 1); the first comes from the final prefill logits. arrival:
    engine-clock step before which admission does not see it. deadline /
    priority are carried for parity with the JAX request; the stepwise
    engine of this slice does not act on them.
    """

    rid: int
    prompt: Sequence[int]
    max_new_tokens: int
    arrival: float = 0.0
    deadline: Optional[float] = None
    priority: int = 0

    def __post_init__(self):
        if len(self.prompt) < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens must be >= 1")
        if self.deadline is not None and self.deadline <= self.arrival:
            raise ValueError(f"request {self.rid}: deadline {self.deadline} "
                             f"is not after arrival {self.arrival}")


class FIFOScheduler:
    def __init__(self, max_queue: Optional[int] = None):
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self._queue: collections.deque[Request] = collections.deque()
        # admission order, bounded so a long-lived engine does not grow
        self.admitted_order: collections.deque[int] = collections.deque(
            maxlen=4096)

    def submit(self, request: Request) -> None:
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            raise QueueFull(f"request {request.rid}: queue is at max_queue="
                            f"{self.max_queue} — retry after the engine drains")
        self._queue.append(request)

    def pending(self) -> int:
        return len(self._queue)

    def peek_arrival(self) -> Optional[float]:
        """Arrival time of the queue head (None when empty): the fast
        path's decode horizon stops at it."""
        return self._queue[0].arrival if self._queue else None

    def pop_ready(self, now: float) -> Optional[Request]:
        """Admit the head request iff it has arrived."""
        if self._queue and self._queue[0].arrival <= now:
            req = self._queue.popleft()
            self.admitted_order.append(req.rid)
            return req
        return None
