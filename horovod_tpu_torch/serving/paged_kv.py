"""Paged KV memory plane: a fixed-size page pool plus a prefix cache.

The counterpart of ``horovod_tpu/serving/paged_kv.py``; the page
bookkeeping is the same numpy code.

* Storage is ``[num_pages, page_tokens, kv_heads, head_dim]`` per layer
  (``torch`` tensors from the model's ``init_cache``), sized by
  ``num_pages`` (tokens in flight), independent of ``max_len``.
* Each slot owns a page table: an int32 row of physical page ids, one
  per ``page_tokens``-sized logical chunk of its sequence. Unallocated
  entries hold the sentinel ``num_pages``: the model's paged write
  drops positions that map to it and reads clamp it into masked
  garbage.
* Allocation is on write: prefill takes the prompt's pages, decode one
  page each time a slot's frontier crosses a page boundary. Freeing a
  slot is refcount bookkeeping with no cache writes.

On top of the pool sits the prefix cache: prompts are chain-hashed per
full page, finished prefill pages are published into a refcounted
``hash → page`` index, and a request sharing a cached prefix attaches
those pages by pointer instead of recomputing their prefill. Shared
pages are immutable (only full pages are shared and the last prompt
token is always recomputed); a copy-on-write guard covers any other
write into a shared page. Index entries are evicted LRU, and only once
no slot holds the page.

The batcher gates admission on free pages above a reserve watermark
(:meth:`admission_headroom`); pool exhaustion mid-decode pauses the
youngest request (:meth:`detach_keep` / :meth:`reattach`) instead of
failing.

With ``mesh=`` every leaf holds this rank's kv heads
(``kv_cache.shard_cache``). The copy-on-write copy is the one write
into the pool outside a forward: ``copy_hook(new, old)``, when set, is
called before it, so a sharded engine's leader sends it to its
followers (``serving/engine.py``).
"""

from __future__ import annotations

import collections
import hashlib
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .kv_cache import KVCacheManager, shard_cache


class PagePoolExhausted(RuntimeError):
    """A decode step found slots whose next write has no page and the
    pool could not supply one. The batcher prevents this (pre-decode
    sweep + pause-youngest); seeing it raised means the engine was
    driven directly past capacity."""

    def __init__(self, slots: List[int]):
        super().__init__(
            f"page pool exhausted: no page for the next token of "
            f"slots {slots}"
        )
        self.slots = list(slots)


def page_hashes(prompt: np.ndarray, page_tokens: int) -> List[bytes]:
    """Chained per-page digests of a prompt: ``h[i]`` commits to the
    full prefix ``prompt[: (i+1) * page_tokens]``, so equal hashes mean
    equal prefixes. Only full pages are hashed."""
    prompt = np.ascontiguousarray(np.asarray(prompt, np.int32))
    out: List[bytes] = []
    h = b""
    for i in range(prompt.size // page_tokens):
        chunk = prompt[i * page_tokens:(i + 1) * page_tokens]
        h = hashlib.sha256(h + chunk.tobytes()).digest()
        out.append(h)
    return out


class PagedKVCacheManager(KVCacheManager):
    """Block-pool KV manager behind the slot API of
    :class:`~.kv_cache.KVCacheManager`, plus the page-table and
    prefix-cache surface the engine and the batcher use. Bookkeeping is
    lock-guarded; the pool tensors are touched only by the engine."""

    def __init__(
        self,
        cache_factory,
        slots: int,
        max_len: int,
        *,
        page_tokens: int = 16,
        num_pages: int = 0,
        prefix_cache: bool = True,
        watermark: int = -1,
        mesh=None,
        tp_axis: str = "tp",
        spare_rows: int = 0,
    ) -> None:
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        if page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
        if max_len % page_tokens:
            raise ValueError(
                f"page_tokens ({page_tokens}) must divide max_len "
                f"({max_len}) — pick a divisor (a slot's pages must tile "
                f"it exactly)"
            )
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.page_tokens = int(page_tokens)
        self.pages_per_slot = self.max_len // self.page_tokens
        full_backing = self.slots * self.pages_per_slot
        self.num_pages = int(num_pages) if num_pages else full_backing
        if self.num_pages < 1:
            raise ValueError(f"need at least one page, got {self.num_pages}")
        # reserve watermark: pages admission must leave free so decode
        # allocation cannot strand in-flight sequences. auto (-1): 0 at
        # full backing, one page per slot otherwise.
        if watermark < 0:
            watermark = 0 if self.num_pages >= full_backing else self.slots
        self.watermark = min(int(watermark), max(self.num_pages - 1, 0))
        self.prefix_cache_enabled = bool(prefix_cache)
        # the pool: batch axis = pages, seq axis = page_tokens. Past the
        # live pages sit spare pages no table names, ``max(slots,
        # spare_rows)`` rows: the graphed decode step's dropped writes
        # (inactive slots, full slots) and a graphed prefill chunk's pad
        # rows land there (CacheStep.on_device). ``full_cache`` is the
        # whole pool; ``cache`` views its live pages (same storage)
        self.spare_pages = -(-max(self.slots, int(spare_rows))
                             // self.page_tokens)
        self.spare_row0 = self.num_pages * self.page_tokens
        self.full_cache = cache_factory(self.num_pages + self.spare_pages,
                                        self.page_tokens)
        self.sharding = None
        if mesh is not None:
            self.full_cache, self.sharding = shard_cache(self.full_cache,
                                                         mesh, tp_axis)
        self.copy_hook = None
        self.cache = [
            {name: leaf[: self.num_pages] for name, leaf in layer.items()}
            for layer in self.full_cache
        ]
        self._lock = threading.Lock()
        self._owner: Dict[int, object] = {}
        self._lengths = np.zeros(self.slots, np.int32)
        self.sentinel = self.num_pages
        self._tables = np.full(
            (self.slots, self.pages_per_slot), self.sentinel, np.int32
        )
        self._free: "collections.deque[int]" = collections.deque(
            range(self.num_pages)
        )
        self._ref = np.zeros(self.num_pages, np.int32)
        # prefix index: hash -> physical page, LRU-ordered; _page_hash
        # is the reverse map for eviction
        self._index: "collections.OrderedDict[bytes, int]" = (
            collections.OrderedDict()
        )
        self._page_hash: Dict[int, bytes] = {}
        # index entries whose page only the index holds (ref == 1): the
        # reclaimable pool, kept incrementally so the gate never scans
        self._reclaimable = 0
        self._counters = collections.Counter()

    # ----------------------------------------------------------- page pool

    def _alloc_page_locked(self) -> Optional[int]:
        """One free page, evicting LRU index-only entries if the free
        list is dry. Caller holds the lock."""
        if self._free:
            return self._free.popleft()
        for h in list(self._index):
            page = self._index[h]
            if self._ref[page] == 1:
                del self._index[h]
                del self._page_hash[page]
                self._ref[page] = 0
                self._reclaimable -= 1
                self._counters["page_evictions"] += 1
                return page
        return None

    def _unref_locked(self, page: int) -> None:
        self._ref[page] -= 1
        if self._ref[page] == 1 and page in self._page_hash:
            self._reclaimable += 1
        if self._ref[page] <= 0:
            self._ref[page] = 0
            self._free.append(page)

    def free_pages_available(self) -> int:
        """Free-list pages plus index entries reclaimable now."""
        with self._lock:
            return len(self._free) + self._reclaimable

    def admission_headroom(self) -> int:
        """Pages the admission gate may spend: available minus the
        reserve watermark (``/healthz``'s ``free_pages``)."""
        return max(self.free_pages_available() - self.watermark, 0)

    def pages_needed(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_tokens)

    def ensure_pages(
        self, slot: int, upto: int, write_from: int = 0,
        start_page: int = 0,
    ) -> bool:
        """Map logical pages so positions ``[0, upto)`` have pages, and
        make every page that will be written (positions >=
        ``write_from``) exclusively owned, copying a shared one first.
        False when the pool cannot supply a page; pages taken so far
        stay with the slot. ``start_page`` skips pages the caller knows
        are mapped."""
        needed = self.pages_needed(upto)
        first_write = int(write_from) // self.page_tokens
        for lp in range(start_page, min(needed, self.pages_per_slot)):
            with self._lock:
                phys = int(self._tables[slot, lp])
                if phys == self.sentinel:
                    page = self._alloc_page_locked()
                    if page is None:
                        return False
                    self._tables[slot, lp] = page
                    self._ref[page] = 1
                    self._counters["page_allocs"] += 1
                    continue
                shared = lp >= first_write and self._ref[phys] > 1
            if shared and not self._cow(slot, lp):
                return False
        return True

    def _cow(self, slot: int, lp: int) -> bool:
        """Copy-on-write: give ``slot`` a private copy of logical page
        ``lp`` before it writes into it (a device copy per layer)."""
        with self._lock:
            old = int(self._tables[slot, lp])
            new = self._alloc_page_locked()
            if new is None:
                return False
            self._tables[slot, lp] = new
            self._ref[new] = 1
            self._unref_locked(old)
            self._counters["page_cow"] += 1
        if self.copy_hook is not None:
            self.copy_hook(new, old)
        self.copy_page(new, old)
        return True

    def copy_page(self, new: int, old: int) -> None:
        """Page ``old``'s rows into page ``new``, every leaf (a device
        copy per layer)."""
        for layer in self.cache:
            for leaf in layer.values():
                leaf[new].copy_(leaf[old])

    def ensure_decode_pages(self) -> List[int]:
        """Pre-decode sweep: every active slot's next write position
        must land in an owned page. Returns the slots that could not be
        supplied (the batcher's cue to pause the youngest request)."""
        starved: List[int] = []
        with self._lock:
            active = sorted(self._owner)
        for slot in active:
            n = int(self._lengths[slot])
            if n >= self.max_len:
                continue  # full slot: retires this round
            if not self.ensure_pages(
                slot, n + 1, write_from=n,
                start_page=n // self.page_tokens,
            ):
                starved.append(slot)
        return starved

    # -------------------------------------------------------- prefix cache

    def lookup_prefix(self, hashes: List[bytes]) -> List[int]:
        """Longest cached run of leading full pages, touching LRU
        recency on every hit."""
        self._counters["prefix_lookups"] += 1
        if not self.prefix_cache_enabled:
            return []
        out: List[int] = []
        with self._lock:
            for h in hashes:
                page = self._index.get(h)
                if page is None:
                    break
                self._index.move_to_end(h)
                out.append(page)
        return out

    def attach_prefix(self, slot: int, pages: List[int]) -> None:
        """Point the slot's leading table entries at cached pages; the
        prefill they carry is skipped."""
        with self._lock:
            for lp, page in enumerate(pages):
                if self._tables[slot, lp] != self.sentinel:
                    raise ValueError(
                        f"slot {slot} logical page {lp} already mapped"
                    )
                self._tables[slot, lp] = page
                if self._ref[page] == 1:
                    self._reclaimable -= 1
                self._ref[page] += 1
            self._counters["prefix_hits"] += len(pages)
            if pages:
                self._counters["prefix_hit_requests"] += 1

    def publish_prefix(self, slot: int, hashes: List[bytes]) -> None:
        """Publish the slot's full prompt pages into the index after a
        prefill (first publisher wins); the index holds its own ref."""
        if not self.prefix_cache_enabled:
            return
        with self._lock:
            for lp, h in enumerate(hashes[: self.pages_per_slot]):
                phys = int(self._tables[slot, lp])
                if phys == self.sentinel or h in self._index:
                    continue
                self._index[h] = phys
                self._index.move_to_end(h)
                self._page_hash[phys] = h
                self._ref[phys] += 1
                self._counters["prefix_published"] += 1

    def publish_hashes(
        self, kept: List[Tuple[int, int]], hashes: List[bytes]
    ) -> None:
        """Warm the prefix index from transferred pages: the sender's
        chained page hashes travel with the payload, so this worker's
        cache serves later shared-prefix admissions it never prefilled.
        Only full prompt pages carry a hash (``hashes[lp]``); the tail
        page has none. First publisher wins, as :meth:`publish_prefix`."""
        if not self.prefix_cache_enabled:
            return
        with self._lock:
            for lp, phys in kept:
                if lp >= len(hashes):
                    continue
                h = hashes[lp]
                if h in self._index:
                    continue
                self._index[h] = phys
                self._index.move_to_end(h)
                self._page_hash[phys] = h
                self._ref[phys] += 1
                self._counters["prefix_published"] += 1

    # ------------------------------------------------ transfer-ingest surface

    def ingest_alloc(self, count: int) -> Optional[List[int]]:
        """``count`` pool pages for a KV-transfer ingest, each with one
        caller-held reference (as :meth:`detach_keep`'s kept pages, so
        they go straight into :meth:`reattach`). All or nothing: on a dry
        pool the pages taken so far go back and None is returned (the
        sender's cue to fall back)."""
        got: List[int] = []
        with self._lock:
            for _ in range(int(count)):
                page = self._alloc_page_locked()
                if page is None:
                    for p in got:
                        self._ref[p] = 0
                        self._free.append(p)
                    return None
                self._ref[page] = 1
                got.append(page)
            self._counters["page_allocs"] += len(got)
            self._counters["transfer_pages_in"] += len(got)
        self._publish()
        return got

    # ------------------------------------------------- pause/resume surface

    def detach_keep(self, slot: int) -> Tuple[List[Tuple[int, int]], int]:
        """Release the slot but keep its pages under the request's own
        refs. Returns ``(kept, length)``, ``kept`` as ``[(logical,
        physical)]`` for :meth:`reattach`."""
        with self._lock:
            kept = [
                (lp, int(p))
                for lp, p in enumerate(self._tables[slot])
                if p != self.sentinel
            ]
            length = int(self._lengths[slot])
            self._tables[slot] = self.sentinel
            self._lengths[slot] = 0
            self._owner.pop(slot, None)
        self._publish()
        return kept, length

    def reattach(
        self, slot: int, kept: List[Tuple[int, int]], length: int
    ) -> None:
        """Resume a paused request into a fresh slot: its pages return
        to their logical positions; decode continues, no re-prefill."""
        with self._lock:
            for lp, page in kept:
                self._tables[slot, lp] = page
        self.set_length(slot, length)
        self._publish()

    def release_kept(self, kept: List[Tuple[int, int]]) -> None:
        """Drop a paused request's page holds; it re-prefills on
        resume."""
        with self._lock:
            for _, page in kept:
                self._unref_locked(page)
        self._publish()

    # ------------------------------------------------------ slot API (base)

    def alloc(self, owner=None) -> Optional[int]:
        with self._lock:
            for slot in range(self.slots):
                if slot not in self._owner:
                    self._owner[slot] = owner
                    self._lengths[slot] = 0
                    break
            else:
                return None
        self._publish()
        return slot

    def free(self, slot: int) -> None:
        """Retire a slot: refcounts drop, pages reaching 0 return to
        the free list, pages the index or another slot holds live on."""
        with self._lock:
            if slot not in self._owner:
                return
            del self._owner[slot]
            for lp in range(self.pages_per_slot):
                phys = int(self._tables[slot, lp])
                if phys != self.sentinel:
                    self._unref_locked(phys)
                self._tables[slot, lp] = self.sentinel
            self._lengths[slot] = 0
        self._publish()

    def table_row(self, slot: int) -> np.ndarray:
        """The slot's page-table row (a copy)."""
        return self._tables[slot].copy()

    def tables_array(self) -> np.ndarray:
        """``[slots, pages_per_slot]`` int32 for the decode step (a
        copy)."""
        return self._tables.copy()

    # --------------------------------------------------------------- stats

    def stats(self) -> Dict[str, float]:
        with self._lock:
            active_slots = len(self._owner)
            free = len(self._free)
            reclaimable = self._reclaimable
            counters = dict(self._counters)
            index_entries = len(self._index)
        lookups = counters.get("prefix_lookups", 0)
        out = {
            "slots_total": self.slots,
            "slots_active": active_slots,
            "slots_free": self.slots - active_slots,
            "kv_max_len": self.max_len,
            "page_tokens": self.page_tokens,
            "pages_total": self.num_pages,
            "pages_free": free,
            "pages_cached": reclaimable,
            "pages_active": self.num_pages - free - reclaimable,
            "page_watermark": self.watermark,
            "prefix_index_entries": index_entries,
            "prefix_hit_rate": (
                counters.get("prefix_hit_requests", 0) / lookups
                if lookups
                else 0.0
            ),
        }
        for key in (
            "page_allocs", "page_evictions", "page_cow", "prefix_hits",
            "prefix_hit_requests", "prefix_lookups", "prefix_published",
        ):
            out[key] = counters.get(key, 0)
        return out
