"""Request model + FIFO admission scheduler (port of
``repro.serving.scheduler``). A request is admitted only at the head of the
queue, once it has arrived and a cache slot (paged: enough free pages) is
free — later requests never jump an earlier one. Page-aware admission peeks
the head (``peek_ready``), sizes its page demand against the pool, and only
then pops.

``PrefixIndex`` is the shared-prefix half of the paged pool: a flattened
trie, one entry per page-aligned token prefix, from prompt prefixes to
resident, refcounted pages. Prefill completion publishes each fully covered
prompt page; admission walks the index page by page and maps every hit into
the new slot's page table instead of recomputing it. Entries are evicted
LRU when admission runs short of fresh pages.
"""
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
    engine-clock step before which admission does not see it. deadline:
    engine-clock step at or after which the request is expired — shed from
    the queue, or cut short in flight at the next step boundary (its
    partial tokens returned with status "expired"); None = no deadline.
    priority: preemption class (higher = more important). FIFO admission
    ignores it; it only picks preemption victims: when the paged pool
    cannot cover the head, a strictly-lower-priority request in flight may
    be preempted (pages released, request parked on the host).
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

    def peek_ready(self, now: float) -> Optional[Request]:
        """The head request iff it has arrived, WITHOUT admitting it: the
        paged engine sizes the head's page demand first, then commits with
        ``pop_ready``."""
        if self._queue and self._queue[0].arrival <= now:
            return self._queue[0]
        return None

    def pop_ready(self, now: float) -> Optional[Request]:
        """Admit the head request iff it has arrived."""
        if self._queue and self._queue[0].arrival <= now:
            req = self._queue.popleft()
            self.admitted_order.append(req.rid)
            return req
        return None

    def drop_head(self) -> Optional[Request]:
        """Remove the head WITHOUT recording an admission (an expired or
        cancelled head is shed here; it never ran)."""
        return self._queue.popleft() if self._queue else None

    def remove(self, rid: int) -> Optional[Request]:
        """Remove a queued request by id (cancellation before admission)."""
        for req in self._queue:
            if req.rid == rid:
                self._queue.remove(req)
                return req
        return None


class PrefixIndex:
    """Prompt-prefix → page index for copy-on-write prefix reuse.

    A flattened trie: the key for depth ``i`` is the FULL token prefix
    through page boundary ``i+1`` (``tuple(prompt[: (i + 1) * page_size])``),
    so a page's K/V is a function of its key alone (K/V at position j
    depend on every token <= j). ``publish`` pins each indexed page with a
    pool reference, so entries stay resident until evicted; ``lookup``
    walks hits page by page and stops at the first miss. Eviction is LRU
    over lookups and publishes, skipping the pages the admission at hand
    is about to share.
    """

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = int(page_size)
        self._map: collections.OrderedDict[tuple, int] = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._map)

    def pages(self) -> list:
        """Page ids pinned by the index, one per entry — the external pins
        ``ServingEngine.check_invariants`` audits refcounts against."""
        return list(self._map.values())

    def lookup(self, prompt: Sequence[int]) -> list:
        """Resident pages covering the longest indexed page-aligned prefix
        of ``prompt`` (possibly none). Touches every hit for LRU."""
        pg = self.page_size
        toks = tuple(int(t) for t in prompt)
        pages: list = []
        while (len(pages) + 1) * pg <= len(toks):
            key = toks[: (len(pages) + 1) * pg]
            page = self._map.get(key)
            if page is None:
                break
            self._map.move_to_end(key)
            pages.append(page)
        if pages:
            self.hits += 1
        else:
            self.misses += 1
        return pages

    def publish(self, prompt: Sequence[int], pool, slot: int) -> int:
        """Index every page of ``slot`` that ``prompt`` covers completely
        (a partial last page is not shareable). Published pages are never
        written again by their owner: pad and decode writes land at
        positions >= len(prompt). A key already indexed is skipped (the
        first donor wins). Returns the number of newly indexed pages."""
        pg = self.page_size
        toks = tuple(int(t) for t in prompt)
        added = 0
        for i in range(len(toks) // pg):
            key = toks[: (i + 1) * pg]
            if key in self._map:
                self._map.move_to_end(key)
                continue
            page = pool.slot_page(slot, i)
            pool.ref_page(page)
            self._map[key] = page
            added += 1
        return added

    def evict_lru(self, pool, protect=()) -> bool:
        """Drop the least-recently-used entry whose page is not in
        ``protect`` and release its pool reference. Returns False when
        nothing is evictable."""
        protect = set(protect)
        for key, page in self._map.items():
            if page in protect:
                continue
            del self._map[key]
            pool.deref_page(page)
            self.evictions += 1
            return True
        return False

    def clear(self, pool) -> None:
        """Drop every entry and release its page reference."""
        while self._map:
            _, page = self._map.popitem(last=False)
            pool.deref_page(page)
