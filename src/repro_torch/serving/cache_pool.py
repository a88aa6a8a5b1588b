"""Slot-based KV-cache pool for continuous batching — the contiguous layout.

Port of the contiguous half of ``repro.serving.cache_pool``: the pool owns
ONE per-slot cache (``LMModel.init_cache``): every batch row is a serving
slot with its own write offset (``pos[i]``) and absolute positions
(``kpos[i]``). Allocation hands out the lowest free slot and resets only the
slot's bookkeeping (kpos → -1, pos → 0), in place: stale K/V payload stays,
since every masked key contributes an exact 0, so recycled slots behave
exactly like fresh ones. The paged layout is a later slice.
"""
from __future__ import annotations

from .errors import PoolExhausted

#: bookkeeping leaves (everything else is int8 payload, its scales or the
#: V error means)
KNOWN_BOOKKEEPING = frozenset({"kpos", "pos"})


class CachePool:
    def __init__(self, model, num_slots: int, max_len: int, *, device,
                 kv_bits: int = 8):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = num_slots
        self.cache: dict = model.init_cache(num_slots, max_len, device=device,
                                            per_slot=True, kv_bits=kv_bits)
        self.kv_bits = kv_bits
        self.max_len = int(self.cache["kpos"].shape[-1])
        self._free = set(range(num_slots))
        self._allocated: set = set()

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

    def allocate(self) -> int:
        """Claim the lowest free slot and reset its bookkeeping in place."""
        if not self._free:
            raise PoolExhausted(f"all {self.num_slots} slots allocated — "
                                f"admit after release()")
        slot = min(self._free)
        self._free.remove(slot)
        self._allocated.add(slot)
        self.cache["kpos"][slot] = -1
        self.cache["pos"][slot] = 0
        return slot

    def release(self, slot: int) -> None:
        if slot not in self._allocated:
            raise ValueError(f"slot {slot} is not allocated (double free, or "
                             f"never claimed)")
        self._allocated.remove(slot)
        self._free.add(slot)

    def check_invariants(self) -> None:
        """Free and allocated slots partition the slot range."""
        n = self.num_slots
        if self._free | self._allocated != set(range(n)) \
                or self._free & self._allocated:
            raise AssertionError(f"slots leaked: free={sorted(self._free)} "
                                 f"allocated={sorted(self._allocated)}")
