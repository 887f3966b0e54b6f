"""InferenceEngine: eager prefill and a graphed decode over a slot-batched
KV cache.

The counterpart of ``horovod_tpu/serving/engine.py`` on one CUDA card:

* **Prefill** runs a prompt through its slot's cache. Prompts longer
  than ``prefill_ceiling`` stream as ceiling-sized chunks, each
  attending to the cache written before it. On the paged plane the
  prompt's leading full pages are first looked up in the prefix cache:
  every hit is attached by page-table pointer and its chunk never runs.
* **Decode** is one step over every slot: each slot's last token at its
  cache index in, each slot's next token out (greedy, or sampled per
  slot with its own ``torch.Generator``). On a CUDA card the step's
  forward is one CUDA graph, the counterpart of the JAX engine's one
  compiled decode executable: a unified or decode engine warms the
  forward up and captures it when it is built, with every slot inactive
  (a prefill engine at its first local decode; ``decode_compiles``
  counts captures), and every step copies its tokens, lengths and page
  tables into the graph's static inputs and replays it. The write rows
  are worked out on the device (``CacheStep.on_device``), attention
  runs through the ``hvd_torch::paged_attention`` operator, and
  sampling for slots with a temperature stays outside the graph, on its
  logits. A capture that fails raises; the step never carries on
  eagerly. Off the card the same body runs eagerly and
  ``decode_compiles`` stays 0.
* **Memory plane**: the paged block pool by default
  (``serving/paged_kv.py``), or the contiguous slab with
  ``paged=False``. Every write into the pool is in place (prefill,
  ingest, copy-on-write): the graph holds the pool's addresses, so the
  JAX engine's rebinding of ``mgr.cache`` has no counterpart.
* **Roles** (``role=``, the disaggregated fleet of
  ``serving/kv_transfer.py``): a decode-role engine never prefills (its
  sequences arrive as pages, :meth:`ingest_attach`); a prefill-role
  engine decodes only when a transfer falls back to local decode. The
  transfer primitives :meth:`gather_pages`, :meth:`pages_to_host`,
  :meth:`extract_pages`, :meth:`export_sampling` and
  :meth:`import_sampling` are the JAX engine's.

Prefill runs eagerly at each chunk's exact width: the JAX engine's
prefill compile tiers (exact/bucket executables, background promotion,
the executable disk cache) have no counterpart, and their counters in
:meth:`stats` stay 0.

The model contract: ``model(tokens, cache=, cache_index=, pages=,
paged_attn=)`` (or ``step=`` instead of the index and the pages) returns
``[batch, t, vocab]`` logits and updates the cache in place
(``models/transformer.py``).
"""

from __future__ import annotations

import collections
import threading
import time
from contextlib import nullcontext as _nullcontext
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..common.config import live_config, resolve_device
from ..common.metrics import registry as _metrics
from ..common import tracing as _tracing
from ..models.transformer import CacheStep, init_cache
from ..ops import paged_attention as _pa
from .kv_cache import create_kv_manager
from .paged_kv import PagePoolExhausted, page_hashes

_STAT_KEYS = (
    "prefill_compiles", "decode_compiles", "prefills",
    "decode_steps", "prefill_exact_hits", "prefill_bucket_hits",
    "prefill_promotions", "prefill_pad_tokens",
    "chunked_prefill_chunks", "prefill_chunks_skipped",
    "prefill_tokens_skipped", "transfer_ingests",
    "paged_attn_calls", "paged_attn_fallbacks",
    "prefill_disk_hits", "decode_disk_hits",
    "prefill_bg_promotions",
)
ROLES = ("unified", "prefill", "decode")


class Gathered(NamedTuple):
    """:meth:`InferenceEngine.gather_pages`' result: fresh per-leaf
    ``[n_pages, page_tokens, kv_heads, head_dim]`` buffers and, on a CUDA
    card, the event recorded after the gather on the scheduler's stream
    (a reader on another thread or stream waits on it first)."""

    pages: List[torch.Tensor]
    event: Optional[object]


def _paged_counts() -> Dict[str, int]:
    """This thread's paged-attention launches: a capture's own, whatever
    another engine's thread launches meanwhile."""
    c = _pa.thread_counts()
    return {"paged_attention": c["launches"],
            "paged_attention_chunk": c["chunk_launches"],
            "paged_attention_tc": c["tc_launches"]}


def next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _sample_next(row: torch.Tensor, temps: np.ndarray, topks: np.ndarray,
                 generators: List[Optional[torch.Generator]]) -> torch.Tensor:
    """Per-slot next token. Temperature 0 takes the greedy argmax
    untouched; a slot with temperature > 0 keeps the logits at or above
    its k-th largest (top-k 0 keeps all), divides by the temperature and
    draws from the softmax with the slot's own generator."""
    nxt = torch.argmax(row, dim=-1)
    vocab = row.shape[-1]
    for slot in np.nonzero(temps > 0)[0]:
        logits = row[slot].float()
        k = int(topks[slot])
        if k > 0:
            thr = torch.topk(logits, min(k, vocab)).values[-1]
            logits = torch.where(logits >= thr, logits,
                                 torch.full_like(logits, -1e30))
        probs = torch.softmax(logits / max(float(temps[slot]), 1e-6), -1)
        nxt[slot] = torch.multinomial(
            probs, 1, generator=generators[slot]
        )[0]
    return nxt


class InferenceEngine:
    """Prefill/decode over a slot-batched KV cache on one device.

    Not thread-safe by design: one consumer (the batcher's step loop)
    drives it, on a thread bound to the engine's device.

    ``model`` is a :class:`~horovod_tpu_torch.models.transformer.
    Transformer` (its ``.cfg`` sets the KV layout); ``params`` a
    ``state_dict`` loaded into it (None keeps the model's own weights).
    The engine takes the model over: it moves it to ``device`` (None
    means the CUDA card), sets eval mode, and stores its matmul weights
    in ``cfg.dtype`` (``Transformer.cast_weights_``: the values every
    forward used are unchanged, the per-call cast kernels go).
    """

    def __init__(
        self,
        model,
        params=None,
        *,
        slots: int,
        max_len: int,
        device=None,
        prefill_ceiling: Optional[int] = None,
        paged: Optional[bool] = None,
        page_tokens: Optional[int] = None,
        pages: Optional[int] = None,
        prefix_cache: Optional[bool] = None,
        page_watermark: Optional[int] = None,
        paged_attn=None,
        role: str = "unified",
    ) -> None:
        if role not in ROLES:
            raise ValueError(
                f"role must be unified/prefill/decode, got {role!r}"
            )
        self.role = role
        self.device = resolve_device(device)
        if params is not None:
            model.load_state_dict(params)
        self.model = model.to(self.device).eval().cast_weights_()
        model_cfg = model.cfg

        def cache_factory(batch, seq):
            return init_cache(model_cfg, batch, seq, device=self.device)

        cfg = live_config()
        self.paged = True if paged is None else bool(paged)
        self.manager = create_kv_manager(
            cache_factory, slots, max_len,
            paged=self.paged,
            page_tokens=(
                cfg.serve_page_tokens if page_tokens is None
                else int(page_tokens)
            ),
            num_pages=cfg.serve_pages if pages is None else int(pages),
            prefix_cache=(
                cfg.serve_prefix_cache if prefix_cache is None
                else bool(prefix_cache)
            ),
            watermark=(
                cfg.serve_page_watermark if page_watermark is None
                else int(page_watermark)
            ),
        )
        self.slots = self.manager.slots
        self.max_len = self.manager.max_len
        # chunk ceiling: a power of two that fits the cache
        floor_pow2 = 1 << (self.max_len.bit_length() - 1)
        ceiling = int(prefill_ceiling) if prefill_ceiling else floor_pow2
        self.prefill_ceiling = min(next_pow2(ceiling), floor_pow2)
        self._decode_swept = False
        self._lock = threading.Lock()  # guards counters for stats readers
        self._counters = collections.Counter()
        # per-slot sampling: temperature 0 / top-k 0 = greedy
        self._sample_temps = np.zeros((self.slots,), np.float32)
        self._sample_topks = np.zeros((self.slots,), np.int32)
        self._generators: List[Optional[torch.Generator]] = (
            [None] * self.slots
        )
        self.paged_attn = self._resolve_paged_attn(
            cfg.serve_paged_attn if paged_attn is None else paged_attn,
            model_cfg,
        )
        # the graphed decode step: static inputs, the graph, its output,
        # the paged launches one replay makes, and the replays so far
        self._static: Optional[Dict[str, torch.Tensor]] = None
        self._graph = None
        self._graph_out: Optional[torch.Tensor] = None
        self._graph_launches: Dict[str, int] = {}
        self._graph_replays = 0
        self._capture_ms = 0.0  # the warm-up and the capture, host clock
        # the CUDA stream the last prefill or decode step wrote the pool
        # on: a gather for the wire is ordered after it, whichever
        # thread asks (a drain exports from a thread of its own)
        self._work_stream = None
        if self.paged_attn:
            _pa.warm_operator()
        if self.device.type == "cuda" and role != "prefill":
            # capture before any request: a step with every slot
            # inactive writes only the spare rows. A prefill worker
            # decodes only when a transfer falls back, and captures then
            self._load_static(np.zeros((self.slots,), np.int32))
            self._capture()

    def _resolve_paged_attn(self, requested, model_cfg) -> bool:
        """Resolve the ``HOROVOD_SERVE_PAGED_ATTN`` tri-state: ``auto``
        engages the kernel on a CUDA device, ``on`` anywhere (its plain
        version for CPU tensors), ``off`` and the slab always take the
        plain read. A kernel that is asked for and cannot run raises
        with the reason: the port never falls back, so
        ``paged_attn_fallbacks`` (kept for the JAX engine's stats keys)
        stays 0. A model with ``sliding_window`` is one such case (the
        kernel has no window): ``on`` anywhere and ``auto`` on a CUDA
        card raise, and ``off`` serves it on the windowed gather read
        of ``models/transformer.py``, where the JAX engine counts a
        fallback to that read instead."""
        if isinstance(requested, bool):
            requested = "on" if requested else "off"
        requested = str(requested).lower()
        if requested not in ("auto", "on", "off"):
            raise ValueError(
                f"paged_attn must be auto/on/off, got {requested!r}"
            )
        if not self.paged or requested == "off":
            return False
        if requested == "auto" and self.device.type != "cuda":
            return False
        leaf = self.manager.cache[0]["k"]
        page_tokens, _, head_dim = leaf.shape[1:4]
        reason = _pa.unsupported_reason(
            int(head_dim), int(page_tokens), dtype=leaf.dtype,
            device=self.device,
        )
        if reason is None and model_cfg.sliding_window:
            reason = "sliding_window is not implemented by the paged kernel"
        if reason is not None:
            raise RuntimeError(
                f"paged_attn={requested}: the paged-attention kernel cannot "
                f"run on {self.device} ({reason}); pass paged_attn='off' "
                "to serve on the plain read"
            )
        return True

    # ------------------------------------------------------------ execution

    def _forward_chunk(self, slot: int, tokens: np.ndarray,
                       start: int) -> torch.Tensor:
        """One prefill chunk through the slot's cache; the greedy next
        token after its last position (on the device)."""
        toks = torch.as_tensor(tokens[None], device=self.device)
        index = np.asarray([start], np.int32)
        if self.paged:
            logits = self.model(
                toks, cache=self.manager.cache, cache_index=index,
                pages=self.manager.table_row(slot)[None],
                paged_attn=self.paged_attn,
            )
        else:
            row = [
                {name: leaf[slot:slot + 1] for name, leaf in layer.items()}
                for layer in self.manager.cache
            ]
            logits = self.model(toks, cache=row, cache_index=index)
        if self.paged_attn:
            self._counters["paged_attn_calls"] += 1
        return torch.argmax(logits[0, -1])

    @torch.no_grad()
    def prefill(self, slot: int, prompt, trace=None) -> int:
        """Run the prompt through the slot's cache; returns the first
        greedy token. The final prompt token is always recomputed, even
        on a full prefix hit, so its logits exist and shared pages are
        never written. The slot's full prompt pages are published into
        the prefix index afterwards."""
        if self.role == "decode":
            raise RuntimeError(
                "prefill on a decode-role engine: decode workers take "
                "finished KV pages over the transfer wire "
                "(serving/kv_transfer.py), never prompts"
            )
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        n = prompt.size
        self._note_stream()
        if not 0 < n <= self.max_len:
            raise ValueError(
                f"prompt length {n} outside (0, {self.max_len}]"
            )
        start = 0
        hashes = []
        if self.paged:
            mgr = self.manager
            if mgr.prefix_cache_enabled:
                hashes = page_hashes(prompt, mgr.page_tokens)
                hits = mgr.lookup_prefix(hashes)
                k = min(len(hits), (n - 1) // mgr.page_tokens)
                if k:
                    mgr.attach_prefix(slot, hits[:k])
                    start = k * mgr.page_tokens
                    self._counters["prefill_chunks_skipped"] += k
                    self._counters["prefill_tokens_skipped"] += start
            if not mgr.ensure_pages(slot, n, write_from=start):
                raise PagePoolExhausted([slot])
        ceiling = self.prefill_ceiling
        while True:
            width = min(n - start, ceiling)
            span = _tracing.start_span(
                "engine.prefill_chunk", trace, start=start, width=width,
                slot=slot,
            )
            tok = self._forward_chunk(slot, prompt[start:start + width],
                                      start)
            if span is not None:
                span.end()
            start += width
            if start == n:
                break
            self._counters["chunked_prefill_chunks"] += 1
        self.manager.set_length(slot, n)
        self._counters["prefills"] += 1
        if self.paged and hashes:
            self.manager.publish_prefix(slot, hashes)
        return int(tok)

    def prepare_decode(self) -> list:
        """Pre-decode page sweep (paged plane): allocate each active
        slot's next-token page; returns the slots the pool could not
        supply (always ``[]`` for the slab). The batcher pauses requests
        until the list is empty."""
        if not self.paged:
            return []
        starved = self.manager.ensure_decode_pages()
        self._decode_swept = not starved
        return starved

    @torch.no_grad()
    def decode_step(self, tokens: np.ndarray) -> np.ndarray:
        """One step over every slot: each slot's last token at its cache
        index in, each slot's next token out. Inactive slots (length 0)
        compute junk at position 0; on the paged plane their table is
        all sentinel, so their write goes to a spare row of the pool."""
        tokens = np.asarray(tokens, np.int32).reshape(self.slots)
        if self.paged:
            if not self._decode_swept:
                starved = self.prepare_decode()
                if starved:
                    raise PagePoolExhausted(starved)
            self._decode_swept = False
        self._note_stream()
        logits = self._decode_logits(tokens)
        nxt = _sample_next(logits, self._sample_temps,
                           self._sample_topks, self._generators)
        with self._lock:
            self._counters["decode_steps"] += 1
            if self.paged_attn:
                self._counters["paged_attn_calls"] += 1
        return nxt.to(torch.int32).cpu().numpy()

    def _note_stream(self) -> None:
        if self.device.type == "cuda":
            self._work_stream = torch.cuda.current_stream(self.device)

    def _decode_logits(self, tokens: np.ndarray) -> torch.Tensor:
        """``[slots, vocab]`` fp32 logits of one decode step: a replay of
        the captured graph on a CUDA card; elsewhere the same body, run
        eagerly."""
        self._load_static(tokens)
        if self.device.type != "cuda":
            return self._decode_body()
        if self._graph is None:
            self._capture()
        self._graph.replay()
        self._graph_replays += 1
        return self._graph_out

    def _load_static(self, tokens: np.ndarray) -> None:
        """Copy the step's tokens, lengths and page tables into the
        step's static inputs (made on the first call), which the graph
        reads on a CUDA card."""
        mgr = self.manager
        if self._static is None:
            dev = self.device
            self._static = {
                "tokens": torch.zeros((self.slots, 1), dtype=torch.int64,
                                      device=dev),
                "lengths": torch.zeros((self.slots,), dtype=torch.int32,
                                       device=dev),
                "tables": (torch.zeros((self.slots, mgr.pages_per_slot),
                                       dtype=torch.int32, device=dev)
                           if self.paged else None),
            }
        st = self._static
        st["tokens"].copy_(torch.from_numpy(
            np.asarray(tokens, np.int64).reshape(self.slots, 1)))
        st["lengths"].copy_(torch.from_numpy(mgr.lengths_array()))
        if self.paged:
            st["tables"].copy_(torch.from_numpy(mgr.tables_array()))

    def _decode_body(self) -> torch.Tensor:
        """The decode forward over the static inputs, with the write
        rows built on the device: what the graph captures, and the
        decode step off the card."""
        mgr = self.manager
        st = self._static
        cache = getattr(mgr, "full_cache", mgr.cache)
        step = CacheStep.on_device(cache, st["lengths"], st["tables"], 1,
                                   getattr(mgr, "spare_row0", None))
        return self.model(st["tokens"], cache=cache, step=step,
                          paged_attn=self.paged_attn)[:, 0, :]

    @torch.no_grad()
    def _capture(self) -> None:
        """Warm the decode forward up once on a side stream (kernels
        built, the decode kernel's ticket words grown), then capture it
        into a CUDA graph. The warm-up writes the loaded step's k/v
        (spare rows only at construction; on a prefill worker's first
        local decode, rows the first replay writes again with the same
        values). Other threads may use the card meanwhile
        (``capture_error_mode="thread_local"``)."""
        dev = self.device
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._decode_body()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = _paged_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self._decode_body()
        after = _paged_counts()
        self._graph_launches = {k: after[k] - before[k] for k in after}
        self._graph, self._graph_out = graph, out
        self._capture_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self._counters["decode_compiles"] += 1

    def graph_launches(self) -> Dict[str, object]:
        """The graphed decode step's accounting: captures, replays and
        the paged-attention launches one replay makes. A launch counter
        ticks at capture only, so the launches a run made are the
        counter plus ``(replays - captures) × per_replay``."""
        return {"captures": int(self._graph is not None),
                "replays": self._graph_replays,
                "per_replay": dict(self._graph_launches),
                "capture_ms": self._capture_ms}

    # ------------------------------------------------------------- sampling

    def set_sampling(self, slot: int, temperature: float = 0.0,
                     top_k: int = 0, seed: Optional[int] = None) -> None:
        """Arm a slot's sampling knobs: ``temperature <= 0`` keeps the
        greedy branch, ``top_k <= 0`` disables truncation, ``seed``
        re-seeds the slot's generator."""
        self._sample_temps[slot] = float(temperature)
        self._sample_topks[slot] = int(top_k)
        if seed is not None or self._generators[slot] is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed or 0))
            self._generators[slot] = gen

    def clear_sampling(self, slot: int) -> None:
        """Back to greedy when a slot frees."""
        self._sample_temps[slot] = 0.0
        self._sample_topks[slot] = 0

    def export_sampling(self, slot: int) -> dict:
        """A slot's armed sampling state: the knobs and its generator's
        raw state mid-stream (not the seed: re-seeding on a receiver
        would fork the sampled sequence; importing the state continues
        it)."""
        gen = self._generators[int(slot)]
        return {
            "temperature": float(self._sample_temps[int(slot)]),
            "top_k": int(self._sample_topks[int(slot)]),
            "key": (None if gen is None
                    else [int(x) for x in gen.get_state().tolist()]),
        }

    def import_sampling(self, slot: int, state: dict) -> None:
        """Arm a slot from an :meth:`export_sampling` snapshot."""
        slot = int(slot)
        self._sample_temps[slot] = float(state.get("temperature", 0.0))
        self._sample_topks[slot] = int(state.get("top_k", 0))
        key = state.get("key")
        if key is not None:
            gen = torch.Generator(device=self.device)
            gen.set_state(torch.tensor(key, dtype=torch.uint8))
            self._generators[slot] = gen

    # ----------------------------------------------- KV transfer primitives

    def _leaves(self) -> List[torch.Tensor]:
        """The pool's live-page tensors in the JAX cache's
        ``tree_leaves`` order (per layer: k, v)."""
        return [layer[name] for layer in self.manager.cache
                for name in sorted(layer)]

    def gather_pages(self, kept) -> Gathered:
        """The first half of :meth:`extract_pages`, on the thread that
        detached the pages: one indexed read a leaf into fresh device
        buffers (no storage shared with the pool, which later steps
        write), and on a CUDA card an event recorded after them. Both
        run on the stream the last prefill or decode step wrote the pool
        on, not this thread's current one, so the read follows the
        writes even when a drain's thread asks. Hand the result to
        :meth:`pages_to_host` (or the transfer codec) off this thread."""
        if not self.paged:
            raise RuntimeError("gather_pages needs the paged plane")
        stream = None
        if self.device.type == "cuda":
            stream = (self._work_stream
                      or torch.cuda.current_stream(self.device))
        with (torch.cuda.stream(stream) if stream is not None
              else _nullcontext()):
            idx = torch.as_tensor([p for _, p in kept], dtype=torch.long,
                                  device=self.device)
            pages = [leaf.index_select(0, idx) for leaf in self._leaves()]
        event = None
        if stream is not None:
            event = torch.cuda.Event()
            event.record(stream)
        return Gathered(pages, event)

    def finish_pages(self, raw: Gathered, kept, length: int,
                     stream=None) -> List[torch.Tensor]:
        """The gathered pages ready for the wire, on their device: the
        current stream (or ``stream``) waits for the gather's event, then
        the tail page's rows at and past ``length`` are zeroed, so no
        garbage travels and none raises an int8 block scale (a zero never
        moves an absmax). Runs on the transfer thread."""
        pages = list(raw.pages)
        if raw.event is not None:
            waiter = stream or torch.cuda.current_stream(self.device)
            waiter.wait_event(raw.event)
            for p in pages:
                p.record_stream(waiter)
        pt = self.manager.page_tokens
        tail_valid = int(length) - (len(kept) - 1) * pt
        ctx = (torch.cuda.stream(stream) if stream is not None
               else _nullcontext())
        with ctx:
            if 0 <= tail_valid < pt:
                for p in pages:
                    p[-1, tail_valid:] = 0
        return pages

    def pages_to_host(self, raw: Gathered, kept, length: int
                      ) -> List[torch.Tensor]:
        """The blocking half of :meth:`extract_pages`: :meth:`finish_pages`
        then one device-to-host copy of every leaf at once. Returns CPU
        tensors in the pool's dtype (numpy has no bfloat16)."""
        pages = self.finish_pages(raw, kept, length)
        if not pages:
            return []
        flat = torch.cat([p.reshape(-1) for p in pages]).cpu()
        out, off = [], 0
        for p in pages:
            out.append(flat[off:off + p.numel()].reshape(p.shape))
            off += p.numel()
        return out

    def extract_pages(self, kept, length: int) -> List[torch.Tensor]:
        """Host copies of a detached slot's pages: one ``[n_pages,
        page_tokens, kv_heads, head_dim]`` tensor a leaf, positions at or
        past ``length`` zeroed (:meth:`gather_pages` then
        :meth:`pages_to_host`)."""
        return self.pages_to_host(self.gather_pages(kept), kept, length)

    @torch.no_grad()
    def ingest_attach(self, slot, logical, arrays, length, hashes=()):
        """The receiver's half of a KV transfer: land the foreign pages
        (``arrays``, one a leaf in :meth:`extract_pages` order, in the
        pool's dtype) as refcounted local pages, written in place, and
        point the slot's table at them; the sender's chained prompt
        hashes warm this worker's prefix index. Returns the kept-pages
        list now backing the slot, or None when the pool is dry.
        Scheduler thread only (the pool's one writer)."""
        if not self.paged:
            raise RuntimeError("ingest_attach needs the paged plane")
        mgr = self.manager
        phys = mgr.ingest_alloc(len(logical))
        if phys is None:
            return None
        idx = torch.as_tensor(phys, dtype=torch.long, device=self.device)
        for leaf, arr in zip(self._leaves(), arrays):
            src = torch.as_tensor(arr).to(device=self.device,
                                          dtype=leaf.dtype)
            leaf.index_copy_(0, idx, src)
        kept = list(zip([int(lp) for lp in logical], phys))
        mgr.reattach(slot, kept, int(length))
        if hashes:
            mgr.publish_hashes(kept, list(hashes))
        with self._lock:
            self._counters["transfer_ingests"] += 1
        return kept

    # ----------------------------------------------------------------- stats

    def stats(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._counters)
        for key in _STAT_KEYS:
            out.setdefault(key, 0)
        out["prefill_exact_entries"] = 0
        out["prefill_bucket_entries"] = 0
        return out

    def publish(self) -> None:
        _metrics.update("serve", self.stats())
