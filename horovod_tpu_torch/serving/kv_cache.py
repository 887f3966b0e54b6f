"""Slot-based KV-cache manager: the contiguous slab.

The decode batch is a fixed array of ``slots``, one per in-flight
sequence. This manager owns:

* the cache itself (``[slots, max_len, kv_heads, head_dim]`` per layer,
  from the model's ``init_cache`` factory), which the engine's forwards
  write in place;
* the batch-slot allocator (free list, per-slot owner and length), so
  the continuous batcher admits a queued request into a freed slot
  between decode steps without touching any other slot;
* per-slot lengths (the ``cache_index`` the model masks attention by)
  and eviction. Freeing a slot writes nothing: positions at or past a
  slot's length get probability 0, and every attended position is
  overwritten by the next occupant before it becomes attendable.

The slab is the baseline; the default memory plane is the paged block
pool of ``paged_kv.py`` behind the same slot API, and
:func:`create_kv_manager` is where the engine picks. The slice runs on
one card, so the JAX manager's tensor-parallel placement of the cache
is not ported.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from ..common.metrics import registry as _metrics


def create_kv_manager(
    cache_factory,
    slots: int,
    max_len: int,
    *,
    paged: bool = True,
    page_tokens: int = 16,
    num_pages: int = 0,
    prefix_cache: bool = True,
    watermark: int = -1,
):
    """The paged block-pool manager (the default) or the contiguous
    slab; both speak the same slot API."""
    if paged:
        from .paged_kv import PagedKVCacheManager

        return PagedKVCacheManager(
            cache_factory, slots, max_len,
            page_tokens=page_tokens, num_pages=num_pages,
            prefix_cache=prefix_cache, watermark=watermark,
        )
    return KVCacheManager(cache_factory, slots=slots, max_len=max_len)


class KVCacheManager:
    """Fixed-slot KV cache + allocator. Bookkeeping is thread-safe; the
    cache tensors are touched only by the engine (one consumer, the
    batcher's step loop)."""

    def __init__(self, cache_factory, slots: int, max_len: int) -> None:
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.cache = cache_factory(self.slots, self.max_len)
        self._lock = threading.Lock()
        self._free: List[int] = list(range(self.slots))
        self._owner: Dict[int, object] = {}
        self._lengths = np.zeros(self.slots, np.int32)

    # ----------------------------------------------------------- allocator

    def alloc(self, owner=None) -> Optional[int]:
        """Claim a free slot (length 0) or None when full."""
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop(0)
            self._owner[slot] = owner
            self._lengths[slot] = 0
        self._publish()
        return slot

    def free(self, slot: int) -> None:
        """Evict a slot: O(1), no cache write."""
        with self._lock:
            if slot in self._owner:
                del self._owner[slot]
                self._lengths[slot] = 0
                self._free.append(slot)
        self._publish()

    # ------------------------------------------------------------- lengths

    def set_length(self, slot: int, n: int) -> None:
        if not 0 <= n <= self.max_len:
            raise ValueError(
                f"slot length {n} outside [0, {self.max_len}]"
            )
        self._lengths[slot] = n

    def advance(self, slot: int, n: int = 1) -> int:
        new = int(self._lengths[slot]) + n
        self.set_length(slot, new)
        return new

    def lengths_array(self) -> np.ndarray:
        """The ``[slots]`` int32 ``cache_index`` of the decode step (a
        copy: the step's input must not alias bookkeeping)."""
        return self._lengths.copy()

    # --------------------------------------------------------------- stats

    def stats(self) -> Dict[str, int]:
        with self._lock:
            active = len(self._owner)
        return {
            "slots_total": self.slots,
            "slots_active": active,
            "slots_free": self.slots - active,
            "kv_max_len": self.max_len,
        }

    def _publish(self) -> None:
        _metrics.update("serve", self.stats())
