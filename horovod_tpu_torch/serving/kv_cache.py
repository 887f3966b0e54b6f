"""Slot-based KV-cache manager: the contiguous slab.

The decode batch is a fixed array of ``slots``, one per in-flight
sequence. This manager owns:

* the cache itself (``[slots, max_len, kv_heads, head_dim]`` per layer,
  from the model's ``init_cache`` factory), which the engine's forwards
  write in place, and optionally one spare slot row past it;
* the batch-slot allocator (free list, per-slot owner and length), so
  the continuous batcher admits a queued request into a freed slot
  between decode steps without touching any other slot;
* per-slot lengths (the ``cache_index`` the model masks attention by)
  and eviction. Freeing a slot writes nothing: positions at or past a
  slot's length get probability 0, and every attended position is
  overwritten by the next occupant before it becomes attendable.

The slab is the baseline; the default memory plane is the paged block
pool of ``paged_kv.py`` behind the same slot API, and
:func:`create_kv_manager` is where the engine picks.

Tensor parallelism: with ``mesh=`` (a built ``parallel.mesh.Mesh``)
every cache leaf keeps this rank's ``kv_heads/tp`` heads of its
kv-heads axis (#2 of ``[slots, seq, kv_heads, head_dim]``), the
``i``-th contiguous run for ``tp`` index ``i``, as the sharded
attention of ``models/transformer.py`` reads them; the manager keeps a
:class:`KVSharding` record where the JAX manager keeps its
``NamedSharding``. Every rank of a sharded engine builds the same
manager, so the pools have the same pages and spare rows.
"""

from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from ..common.metrics import registry as _metrics


class KVSharding(NamedTuple):
    """Where this rank's cache sits on the mesh: the tensor-parallel
    axis, its size and this rank's index along it."""

    axis: str
    size: int
    index: int


def shard_cache(cache: List[dict], mesh, tp_axis: str):
    """``(cache, KVSharding)``: every leaf cut to this rank's run of its
    kv-heads axis. Raises ``ValueError`` when the axis does not divide
    the kv head count (``horovod_tpu/serving/kv_cache.py:118-129``)."""
    tp = mesh.size(tp_axis)
    heads = {leaf.shape[2] for layer in cache for leaf in layer.values()}
    for h in heads:
        if h % tp:
            raise ValueError(
                f"the '{tp_axis}' axis size ({tp}) must divide the kv "
                f"head count ({h}) to shard the cache"
            )
    if tp == 1:
        return cache, KVSharding(tp_axis, 1, 0)
    i = mesh.axis(tp_axis).index
    cut = [
        {name: leaf[:, :, i * (leaf.shape[2] // tp):
                    (i + 1) * (leaf.shape[2] // tp)].contiguous()
         for name, leaf in layer.items()}
        for layer in cache
    ]
    return cut, KVSharding(tp_axis, tp, i)


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
    mesh=None,
    tp_axis: str = "tp",
    spare_rows: int = 0,
):
    """The paged block-pool manager (the default) or the contiguous
    slab; both speak the same slot API. ``mesh`` shards every leaf's kv
    heads over ``tp_axis``. ``spare_rows`` sizes the paged pool's spare
    rows (at least one a slot); on the slab, any value above 0 adds
    one spare slot row."""
    if paged:
        from .paged_kv import PagedKVCacheManager

        return PagedKVCacheManager(
            cache_factory, slots, max_len,
            page_tokens=page_tokens, num_pages=num_pages,
            prefix_cache=prefix_cache, watermark=watermark,
            mesh=mesh, tp_axis=tp_axis, spare_rows=spare_rows,
        )
    return KVCacheManager(cache_factory, slots=slots, max_len=max_len,
                          mesh=mesh, tp_axis=tp_axis,
                          spare_slot=spare_rows > 0)


class KVCacheManager:
    """Fixed-slot KV cache + allocator. Bookkeeping is thread-safe; the
    cache tensors are touched only by the engine (one consumer, the
    batcher's step loop)."""

    def __init__(self, cache_factory, slots: int, max_len: int, mesh=None,
                 tp_axis: str = "tp", spare_slot: bool = False) -> None:
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        self.slots = int(slots)
        self.max_len = int(max_len)
        # ``spare_slot``: one more slot row past the live ones, which no
        # slot owns (a graphed prefill's warm-up writes there).
        # ``full_cache`` is the whole slab; ``cache`` views its live
        # slots (same storage)
        self.spare_slot = self.slots if spare_slot else None
        self.full_cache = cache_factory(self.slots + int(spare_slot),
                                        self.max_len)
        self.sharding: Optional[KVSharding] = None
        if mesh is not None:
            self.full_cache, self.sharding = shard_cache(self.full_cache,
                                                         mesh, tp_axis)
        self.cache = [{name: leaf[:self.slots] for name, leaf in layer.items()}
                      for layer in self.full_cache]
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

    def owner(self, slot: int):
        with self._lock:
            return self._owner.get(slot)

    def active_slots(self) -> List[int]:
        with self._lock:
            return sorted(self._owner)

    # ------------------------------------------------------------- lengths

    def length(self, slot: int) -> int:
        return int(self._lengths[slot])

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

    def capacity_left(self, slot: int) -> int:
        return self.max_len - int(self._lengths[slot])

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
