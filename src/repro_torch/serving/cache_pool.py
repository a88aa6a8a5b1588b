"""Slot-based KV-cache pool for continuous batching — contiguous or paged
(port of ``repro.serving.cache_pool``).

**Contiguous** (``page_size=None``): the pool owns ONE per-slot cache
(``LMModel.init_cache``), int8 (payload, scales and the V error means) or
fp (the payload in the compute dtype): every batch row is a serving slot
with its own write offset (``pos[i]``) and absolute positions
(``kpos[i]``). Allocation hands out the lowest free slot and resets only
the slot's bookkeeping (kpos → -1, pos → 0), in place: stale K/V payload
stays, since every masked key contributes an exact 0, so recycled slots
behave exactly like fresh ones. The engine's fast path defers that reset
into its first prefill chunk (``allocate(reset=False)``); the pool tracks
the pending reset and repairs it if the slot is released first.

**Paged** (``page_size=pg``): every payload leaf (the int8 payload, its
scales and ``v_err`` page together — one page id covers a position's whole
quantized state) is laid out as a page pool ``[L, num_pages, pg, ...]``,
plus a ``page_table [num_slots, S/pg]`` that maps a slot's ring positions
onto pages (-1: unmapped). Slots allocate and release in page units, and
pages are refcounted: the scheduler's ``PrefixIndex`` pins published
prompt pages and hands them to later requests; a shared page is copied
before its new owner writes into it (``ensure_writable``). ``kpos`` /
``pos`` stay dense: they are the validity oracle in both layouts. The
free pages are a ``heapq`` and slots come from ``min`` of a set, as in the
JAX pool, so page ids come out in its order.

Each page leaf's storage holds one page more than ``pool.cache`` shows —
``[L, num_pages + 1, pg, ...]``, the view ``[:, :num_pages]`` in the cache —
and the page table never maps that last page: the engine routes the
writes a dispatch must drop there (``sink_page``), since PyTorch has no
scatter that drops out-of-range indices. ``cache_bytes`` counts the view,
so it stays the JAX pool's number.

No leaf is ever rebound: the fast path's CUDA graphs hold the leaves'
addresses, and every admission, copy-on-write and reset writes in place
on the caller's stream.
"""
from __future__ import annotations

import heapq
from typing import Optional, Sequence

import torch

from .errors import PoolExhausted

#: bookkeeping leaves (everything else is K/V payload, its scales or the V
#: error means); an integer leaf that is neither int8 payload nor listed
#: here is refused by ``cache_bytes``
KNOWN_BOOKKEEPING = frozenset({"kpos", "pos", "page_table"})


class CachePool:
    def __init__(self, model, num_slots: int, max_len: int, *, device,
                 kv_bits: Optional[int] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None, shard=None):
        """``kv_bits``: 8 (int8) or 16 (fp); None follows the model's
        ``cfg.kv_cache_bits``. ``page_size`` switches to the paged layout;
        ``num_pages`` sizes it (default: every slot can map a full ring,
        ``num_slots * ceil(ring / page_size)``). ``shard`` (a
        ``sharding.tp.ServeShard``): the device leaves hold this rank's
        slots and KV heads (``serve_cache_pspecs``), while the host
        bookkeeping — free slots, pages, refcounts — stays the whole pool's,
        the same on every rank; a slot's bookkeeping write lands only on
        the rank that holds it."""
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = num_slots
        self._rows = (None if shard is None or not shard.slots_sharded
                      else (shard.slot_lo, shard.slot_hi))
        rows = num_slots if self._rows is None else self._rows[1] - self._rows[0]
        cache = model.init_cache(rows, max_len, device=device,
                                 per_slot=True, kv_bits=kv_bits,
                                 kv_heads=None if shard is None
                                 else shard.kv_heads)
        self.kv_bits = 8 if "k_scale" in cache else 16
        self.max_len = int(cache["kpos"].shape[-1])
        self.page_size = None if page_size is None else int(page_size)
        self.num_pages = 0
        self.pages_per_slot = 0
        if self.page_size is not None:
            pg = self.page_size
            if not 1 <= pg <= self.max_len:
                raise ValueError(f"page_size must be in [1, ring="
                                 f"{self.max_len}], got {pg}")
            self.pages_per_slot = -(-self.max_len // pg)
            self.num_pages = (num_slots * self.pages_per_slot
                              if num_pages is None else int(num_pages))
            if self.num_pages < 1:
                raise ValueError(f"num_pages must be >= 1, got "
                                 f"{self.num_pages}")
            # [L, num_pages + 1, pg, ...]: the last page is the sink
            self.storage = {
                name: torch.zeros((leaf.shape[0], self.num_pages + 1, pg)
                                  + tuple(leaf.shape[3:]), dtype=leaf.dtype,
                                  device=leaf.device)
                for name, leaf in cache.items()
                if name not in KNOWN_BOOKKEEPING}
            paged = {"kpos": cache["kpos"], "pos": cache["pos"]}
            paged.update({name: store[:, :self.num_pages]
                          for name, store in self.storage.items()})
            paged["page_table"] = torch.full(
                (num_slots, self.pages_per_slot), -1, dtype=torch.int64,
                device=cache["kpos"].device)
            cache = paged
            self._free_pages: list = list(range(self.num_pages))
            heapq.heapify(self._free_pages)
            self._page_ref = [0] * self.num_pages
            self._slot_pages: dict[int, list] = {}
            # pages withheld from allocation (chaos fault injection): ref 0,
            # not in the free heap, owned by the reserver
            self._reserved: set = set()
            self.cow_copies = 0
            self._ring = torch.arange(self.max_len, device=cache["kpos"].device)
        self.cache: dict = cache
        self._free = set(range(num_slots))
        self._allocated: set = set()
        # slots whose bookkeeping reset was deferred (allocate(reset=False))
        # and has not yet committed inside a prefill dispatch
        self._pending_reset: set = set()

    # ------------------------------------------------------------- queries
    @property
    def paged(self) -> bool:
        return self.page_size is not None

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_allocated(self) -> int:
        return len(self._allocated)

    @property
    def n_free_pages(self) -> int:
        return len(self._free_pages) if self.paged else 0

    @property
    def sink_page(self) -> int:
        """The storage page no table entry maps (dropped writes land
        there)."""
        return self.num_pages

    def is_allocated(self, slot: int) -> bool:
        return slot in self._allocated

    def page_ref(self, page: int) -> int:
        return self._page_ref[page]

    def slot_page(self, slot: int, idx: int) -> int:
        """Page backing ring positions [idx*pg, (idx+1)*pg) of ``slot``."""
        return self._slot_pages[slot][idx]

    def slot_pages(self, slot: int) -> list:
        return list(self._slot_pages.get(slot, ()))

    def all_free(self) -> bool:
        return not self._allocated and len(self._free) == self.num_slots

    def cache_bytes(self) -> int:
        """Resident payload bytes of the pool (bookkeeping and the sink
        page excluded), as the JAX pool counts them."""
        total = 0
        for name, leaf in self.cache.items():
            if name in KNOWN_BOOKKEEPING:
                continue
            if not leaf.dtype.is_floating_point and leaf.dtype != torch.int8:
                raise ValueError(
                    f"cache leaf {name!r} has bookkeeping-like dtype "
                    f"{leaf.dtype} but is not a recognized bookkeeping leaf "
                    f"({sorted(KNOWN_BOOKKEEPING)}); add it to "
                    f"KNOWN_BOOKKEEPING or give it a payload dtype")
            total += leaf.numel() * leaf.element_size()
        return total

    def bytes_per_slot(self) -> int:
        """KV bytes one full-length slot owns (bookkeeping excluded); paged,
        the worst case, a slot mapping its whole ring."""
        total = self.cache_bytes()
        if self.paged:
            return (total // self.num_pages) * self.pages_per_slot
        return total // self.num_slots

    def pages_needed(self, need: int, reuse_len: int = 0) -> int:
        """Fresh pages an admission must find for a request spanning
        ``need`` ring positions with its first ``reuse_len`` on shared
        pages: the unshared span, plus one spare when ``reuse_len`` splits a
        page (that page is copied before the first prefill chunk writes
        into it)."""
        pg = self.page_size
        n_pages = -(-need // pg)
        n_shared = -(-reuse_len // pg)
        return n_pages - n_shared + (1 if reuse_len % pg else 0)

    # ----------------------------------------------------------- lifecycle
    def allocate(self, reset: bool = True) -> int:
        """Claim the lowest free slot and reset its bookkeeping in place.

        ``reset=False`` leaves the slot's stale kpos/pos; the caller owns
        the reset (the engine's fast path folds it into the first prefill
        chunk through a ``fresh`` row mask) and reports it with
        ``note_reset_committed``. Until then the slot may only ride along
        as a masked row, and a release repairs it, so the next claimant
        never inherits stale bookkeeping."""
        if self.paged:
            raise RuntimeError("paged pools allocate in page units — use "
                               "allocate_pages()")
        if not self._free:
            raise PoolExhausted(f"all {self.num_slots} slots allocated — "
                                f"admit after release()")
        slot = min(self._free)
        self._free.remove(slot)
        self._allocated.add(slot)
        if reset:
            self._reset_slot(slot)
        else:
            self._pending_reset.add(slot)
        return slot

    def _reset_slot(self, slot: int) -> None:
        row = self.local_row(slot)
        if row is not None:
            self.cache["kpos"][row] = -1
            self.cache["pos"][row] = 0
        self._pending_reset.discard(slot)

    def local_row(self, slot: int) -> Optional[int]:
        """``slot``'s row in the device leaves (None: another rank holds
        it)."""
        if self._rows is None:
            return slot
        lo, hi = self._rows
        return slot - lo if lo <= slot < hi else None

    def note_reset_committed(self, slot: int) -> None:
        """A deferred (fresh-mask) reset committed inside a prefill
        dispatch: the slot's bookkeeping is clean from here on."""
        self._pending_reset.discard(slot)

    def allocate_pages(self, need: int, shared: Sequence[int] = (),
                       reuse_len: int = 0) -> int:
        """Paged admission: claim the lowest free slot, map ``shared`` pages
        (refcounted; they carry the request's first ``reuse_len``
        positions) and then fresh pages up to ``ceil(need / page_size)``,
        write the page-table row and seed the bookkeeping (``kpos[:reuse]``
        = 0..reuse-1, the rest -1; ``pos = reuse``), and copy the boundary
        page when ``reuse_len`` splits it. Atomic: a ``PoolExhausted`` (no
        slot, too few fresh pages) leaves the pool untouched."""
        if not self.paged:
            raise RuntimeError("allocate_pages() needs a paged pool "
                               "(construct with page_size=...)")
        pg = self.page_size
        if not 0 <= reuse_len < need:
            raise ValueError(f"reuse_len must be in [0, need={need}), "
                             f"got {reuse_len}")
        n_pages = -(-need // pg)
        n_shared = -(-reuse_len // pg)
        if len(shared) != n_shared:
            raise ValueError(f"reuse_len={reuse_len} (page_size {pg}) maps "
                             f"{n_shared} shared pages but {len(shared)} "
                             f"were given")
        if n_pages > self.pages_per_slot:
            raise ValueError(f"request needs {n_pages} pages but a slot table "
                             f"holds {self.pages_per_slot} (ring "
                             f"{self.max_len}, page {pg})")
        if not self._free:
            raise PoolExhausted(f"all {self.num_slots} slots allocated — "
                                f"admit after release()")
        fresh_needed = self.pages_needed(need, reuse_len)
        if fresh_needed > len(self._free_pages):
            raise PoolExhausted(
                f"need {fresh_needed} fresh pages but only "
                f"{len(self._free_pages)} of {self.num_pages} are free — "
                f"release slots or evict prefix-index pages first")
        slot = min(self._free)
        self._free.remove(slot)
        self._allocated.add(slot)
        pages = list(shared)
        for p in pages:
            self._page_ref[p] += 1
        for _ in range(n_pages - n_shared):
            p = heapq.heappop(self._free_pages)
            self._page_ref[p] = 1
            pages.append(p)
        self._slot_pages[slot] = pages
        row = torch.full((self.pages_per_slot,), -1, dtype=torch.int64)
        row[:n_pages] = torch.tensor(pages, dtype=torch.int64)
        table = self.cache["page_table"]
        table[slot].copy_(row.to(table.device, non_blocking=True))
        self.cache["kpos"][slot] = torch.where(self._ring < reuse_len,
                                               self._ring, -1)
        self.cache["pos"][slot] = reuse_len
        self._pending_reset.discard(slot)
        if reuse_len % pg:
            # the first prefill chunk starts at reuse_len, inside the last
            # shared page: copy it now (the spare pages_needed reserved)
            self.ensure_writable(slot, reuse_len, reuse_len + 1)
        return slot

    def ensure_writable(self, slot: int, start: int, stop: int) -> int:
        """Copy-on-write: every page of ``slot`` overlapping ring positions
        [start, stop) that is shared (refcount > 1) is copied into a fresh
        page — payload, scales and ``v_err`` together — and the slot's table
        entry repointed. Returns the number of pages copied. After
        admission the engine only ever writes pages it owns alone."""
        pg = self.page_size
        pages = self._slot_pages[slot]
        copied = 0
        for idx in range(start // pg, min(-(-stop // pg), len(pages))):
            src = pages[idx]
            if self._page_ref[src] <= 1:
                continue
            if not self._free_pages:
                raise PoolExhausted(
                    f"copy-on-write of slot {slot} page {idx} needs a free "
                    f"page but all {self.num_pages} are in use")
            dst = heapq.heappop(self._free_pages)
            for store in self.storage.values():
                store[:, dst].copy_(store[:, src])
            self.cache["page_table"][slot, idx] = dst
            self._page_ref[src] -= 1
            self._page_ref[dst] = 1
            pages[idx] = dst
            self.cow_copies += 1
            copied += 1
        return copied

    def ref_page(self, page: int) -> None:
        """Take a reference on a live page (the prefix index pinning a
        published prompt page)."""
        if self._page_ref[page] < 1:
            raise ValueError(f"page {page} is free — cannot pin it")
        self._page_ref[page] += 1

    def deref_page(self, page: int) -> None:
        self._page_ref[page] -= 1
        if self._page_ref[page] < 0:
            raise ValueError(f"page {page} over-released")
        if self._page_ref[page] == 0:
            heapq.heappush(self._free_pages, page)

    def release(self, slot: int) -> None:
        if slot not in self._allocated:
            raise ValueError(f"slot {slot} is not allocated (double free, or "
                             f"never claimed)")
        if slot in self._pending_reset:
            # released before its deferred reset committed: the slot still
            # carries the previous occupant's kpos/pos
            self._reset_slot(slot)
        self._allocated.remove(slot)
        self._free.add(slot)
        if self.paged:
            for p in self._slot_pages.pop(slot, ()):
                self.deref_page(p)

    # --------------------------------------------- fault injection support
    def reserve_pages(self, n: int) -> list:
        """Withhold up to ``n`` free pages from allocation (the chaos
        harness's pool-exhaustion fault): they leave the free heap without
        any slot or refcount owning them. Returns their ids, for
        ``release_reserved``; fewer than ``n`` (even none) is no error."""
        if not self.paged:
            raise RuntimeError("reserve_pages() needs a paged pool")
        got = []
        while self._free_pages and len(got) < n:
            p = heapq.heappop(self._free_pages)
            self._reserved.add(p)
            got.append(p)
        return got

    def release_reserved(self, pages: Sequence[int]) -> None:
        """Return pages taken by ``reserve_pages`` to the free heap."""
        for p in pages:
            if p not in self._reserved:
                raise ValueError(f"page {p} is not reserved")
            self._reserved.remove(p)
            heapq.heappush(self._free_pages, p)

    # ------------------------------------------------------------ auditing
    def check_invariants(self, external_refs=None) -> None:
        """Audit the pool's host bookkeeping; raises AssertionError on the
        first violation. Host state only (no device sync), so the chaos
        harness runs it after every engine step and ``REPRO_POOL_CHECK=1``
        after every step of any engine.

        Checked: free and allocated slots partition the slot range, and
        only allocated slots have a pending reset; paged, every page is
        exactly one of free (ref 0, once in the free heap), reserved (ref
        0, held by the chaos harness) or live, and a live page's refcount
        equals its slot-table mappings plus its external pins
        (``external_refs``: page → pin count, e.g. the prefix index's
        entries); no slot maps a freed page."""
        def check(ok, msg):
            if not ok:
                raise AssertionError(msg)

        n = self.num_slots
        check(self._free | self._allocated == set(range(n)),
              f"slots leaked: free={sorted(self._free)} allocated="
              f"{sorted(self._allocated)} don't cover 0..{n - 1}")
        check(not self._free & self._allocated,
              f"slots both free and allocated: "
              f"{sorted(self._free & self._allocated)}")
        check(self._pending_reset <= self._allocated,
              f"pending resets on non-allocated slots: "
              f"{sorted(self._pending_reset - self._allocated)}")
        if not self.paged:
            return
        check(set(self._slot_pages) == self._allocated,
              f"slot-page tables {sorted(self._slot_pages)} != allocated "
              f"slots {sorted(self._allocated)}")
        free_counts: dict[int, int] = {}
        for p in self._free_pages:
            free_counts[p] = free_counts.get(p, 0) + 1
        expected = dict(external_refs or {})
        for pages in self._slot_pages.values():
            for p in pages:
                expected[p] = expected.get(p, 0) + 1
        for p in range(self.num_pages):
            ref = self._page_ref[p]
            in_free = free_counts.get(p, 0)
            holders = expected.get(p, 0)
            if p in self._reserved:
                check(ref == 0 and in_free == 0,
                      f"reserved page {p} has ref {ref}, free-heap count "
                      f"{in_free}")
                check(holders == 0, f"reserved page {p} is mapped/pinned "
                                    f"({holders} holders)")
            elif ref == 0:
                check(in_free == 1, f"page {p} has ref 0 but appears "
                                    f"{in_free} times in the free heap "
                                    f"(want exactly 1)")
                check(holders == 0, f"freed page {p} is still mapped/pinned "
                                    f"({holders} holders)")
            else:
                check(in_free == 0, f"live page {p} (ref {ref}) is in the "
                                    f"free heap")
                check(ref == holders,
                      f"page {p} refcount {ref} != {holders} (slot mappings "
                      f"+ external pins) — refcount leak")
