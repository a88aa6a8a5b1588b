"""Slot-based KV-cache pool for continuous batching — the contiguous layout.

Port of the contiguous half of ``repro.serving.cache_pool``: the pool owns
ONE per-slot cache (``LMModel.init_cache``), int8 (payload, scales and the
V error means) or fp (the payload in the compute dtype): every batch row is
a serving slot with its own write offset (``pos[i]``) and absolute positions
(``kpos[i]``). Allocation hands out the lowest free slot and resets only the
slot's bookkeeping (kpos → -1, pos → 0), in place: stale K/V payload stays,
since every masked key contributes an exact 0, so recycled slots behave
exactly like fresh ones. The engine's fast path defers that reset into its
first prefill chunk (``allocate(reset=False)``); the pool tracks the pending
reset and repairs it if the slot is released first. No leaf is ever
rebound: the fast path's CUDA graphs hold the leaves' addresses. The paged
layout is a later slice.
"""
from __future__ import annotations

from typing import Optional

from .errors import PoolExhausted

#: bookkeeping leaves (everything else is K/V payload, its scales or the V
#: error means)
KNOWN_BOOKKEEPING = frozenset({"kpos", "pos"})


class CachePool:
    def __init__(self, model, num_slots: int, max_len: int, *, device,
                 kv_bits: Optional[int] = None):
        """``kv_bits``: 8 (int8) or 16 (fp); None follows the model's
        ``cfg.kv_cache_bits``."""
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = num_slots
        self.cache: dict = model.init_cache(num_slots, max_len, device=device,
                                            per_slot=True, kv_bits=kv_bits)
        self.kv_bits = 8 if "k_scale" in self.cache else 16
        self.max_len = int(self.cache["kpos"].shape[-1])
        self._free = set(range(num_slots))
        self._allocated: set = set()
        # slots whose bookkeeping reset was deferred (allocate(reset=False))
        # and has not yet committed inside a prefill dispatch
        self._pending_reset: set = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    def all_free(self) -> bool:
        return not self._allocated and len(self._free) == self.num_slots

    def cache_bytes(self) -> int:
        """Resident payload bytes of the pool (bookkeeping excluded)."""
        return sum(t.numel() * t.element_size() for k, t in self.cache.items()
                   if k not in KNOWN_BOOKKEEPING)

    def bytes_per_slot(self) -> int:
        return self.cache_bytes() // self.num_slots

    def allocate(self, reset: bool = True) -> int:
        """Claim the lowest free slot and reset its bookkeeping in place.

        ``reset=False`` leaves the slot's stale kpos/pos; the caller owns
        the reset (the engine's fast path folds it into the first prefill
        chunk through a ``fresh`` row mask) and reports it with
        ``note_reset_committed``. Until then the slot may only ride along
        as a masked row, and a release repairs it, so the next claimant
        never inherits stale bookkeeping."""
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
        self.cache["kpos"][slot] = -1
        self.cache["pos"][slot] = 0
        self._pending_reset.discard(slot)

    def note_reset_committed(self, slot: int) -> None:
        """A deferred (fresh-mask) reset committed inside a prefill
        dispatch: the slot's bookkeeping is clean from here on."""
        self._pending_reset.discard(slot)

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

    def check_invariants(self) -> None:
        """Free and allocated slots partition the slot range; only
        allocated slots have a pending reset."""
        n = self.num_slots
        if self._free | self._allocated != set(range(n)) \
                or self._free & self._allocated:
            raise AssertionError(f"slots leaked: free={sorted(self._free)} "
                                 f"allocated={sorted(self._allocated)}")
        if not self._pending_reset <= self._allocated:
            raise AssertionError(f"pending resets on non-allocated slots: "
                                 f"{sorted(self._pending_reset - self._allocated)}")
