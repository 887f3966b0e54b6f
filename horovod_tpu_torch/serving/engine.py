"""InferenceEngine: eager prefill and decode over a slot-batched KV cache.

The counterpart of ``horovod_tpu/serving/engine.py`` on one CUDA card:

* **Prefill** runs a prompt through its slot's cache. Prompts longer
  than ``prefill_ceiling`` stream as ceiling-sized chunks, each
  attending to the cache written before it. On the paged plane the
  prompt's leading full pages are first looked up in the prefix cache:
  every hit is attached by page-table pointer and its chunk never runs.
* **Decode** is one step over every slot: each slot's last token at its
  cache index in, each slot's next token out (greedy, or sampled per
  slot with its own ``torch.Generator``).
* **Memory plane**: the paged block pool by default
  (``serving/paged_kv.py``), or the contiguous slab with
  ``paged=False``.

The cache is written in place by each forward. The JAX engine instead
donates its cache through compiled executables; eager PyTorch has no
executables to build, so the JAX engine's compile tiers (exact/bucket
prefill executables, background promotion, the executable disk cache)
have no counterpart here, and prefill runs at each chunk's exact width.
The ``*_compiles`` counters in :meth:`stats` stay 0.

The model contract: ``model(tokens, cache=, cache_index=, pages=,
paged_attn=)`` returns ``[batch, t, vocab]`` logits and updates the
cache in place (``models/transformer.py``).
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..common.config import live_config, resolve_device
from ..common.metrics import registry as _metrics
from ..common import tracing as _tracing
from ..models.transformer import init_cache
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
    ) -> None:
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

    def _resolve_paged_attn(self, requested, model_cfg) -> bool:
        """Resolve the ``HOROVOD_SERVE_PAGED_ATTN`` tri-state: ``auto``
        engages the kernel on a CUDA device, ``on`` anywhere (its plain
        version for CPU tensors), ``off`` and the slab always take the
        plain read. A kernel that is asked for and cannot run raises
        with the reason: the port never falls back, so
        ``paged_attn_fallbacks`` (kept for the JAX engine's stats keys)
        stays 0."""
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
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        n = prompt.size
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
        all sentinel, so even their write is dropped."""
        tokens = np.asarray(tokens, np.int32).reshape(self.slots)
        if self.paged:
            if not self._decode_swept:
                starved = self.prepare_decode()
                if starved:
                    raise PagePoolExhausted(starved)
            self._decode_swept = False
        toks = torch.as_tensor(tokens[:, None], device=self.device)
        logits = self.model(
            toks, cache=self.manager.cache,
            cache_index=self.manager.lengths_array(),
            pages=self.manager.tables_array() if self.paged else None,
            paged_attn=self.paged_attn,
        )
        nxt = _sample_next(logits[:, 0, :], self._sample_temps,
                           self._sample_topks, self._generators)
        self._counters["decode_steps"] += 1
        if self.paged_attn:
            self._counters["paged_attn_calls"] += 1
        return nxt.to(torch.int32).cpu().numpy()

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
