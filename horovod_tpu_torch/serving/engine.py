"""InferenceEngine: graphed prefill tiers and a graphed decode over a
slot-batched KV cache.

The counterpart of ``horovod_tpu/serving/engine.py`` on one CUDA card:

* **Prefill** runs a prompt through its slot's cache. Prompts longer
  than ``prefill_ceiling`` stream as ceiling-sized chunks, each
  attending to the cache written before it. On the paged plane the
  prompt's leading full pages are first looked up in the prefix cache:
  every hit is attached by page-table pointer and its chunk never runs.
  Each chunk runs through the JAX engine's two prefill tiers (below).
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

**The prefill tiers** (``horovod_tpu/serving/engine.py:583-705``): a
chunk's final piece of ``length`` tokens runs through an *entry* of a
fixed width. An exact entry of that width serves it when the length was
promoted (``prefill_exact_hits``); otherwise the power-of-two bucket
``min(max(next_pow2(length), min_bucket), prefill_ceiling)`` does, with
pad tokens (``prefill_pad_tokens``). A length seen ``promote_after``
times is promoted: its exact entry is made in a background thread
(``prefill_bg_promotions``) while the bucket keeps serving, and installs
when ready; at most ``exact_capacity`` exact entries are kept (LRU), and
the sightings map at most ``4 × exact_capacity`` lengths. A bucket that
would overrun the slot's room (``max_len - start``) makes the exact
entry at once, on the scheduler's thread. Full chunks at the ceiling
reuse the ceiling's bucket entry. ``prefill_compiles`` counts entries
made, ``prefill_promotions`` exact installs.

On a CUDA card an entry is one CUDA graph of the chunk's forward at that
width, made when the entry is: a warm-up on a side stream, then a
capture, both with a real length of 0 on inputs that name no live row
(an all-sentinel table; on the slab, the spare slot row past the live
ones that the manager keeps for this), so the warm-up writes no row a
slot owns. Its static inputs are one int64 buffer: the tokens ``[1,
width]``, the start index, the last real position and the slot's
page-table row at its full width (the slab's slot index on
``paged=False``, whose write rows and read are worked out on the device,
so one graph a width serves every slot). Its output is the greedy token
at the last real position, with the LM head applied to that row only.
Pad rows never reach a live page: on the paged plane they go to the
pool's spare rows (``CacheStep.on_device``'s ``valid``), which are sized
for ``max(slots, prefill_ceiling)`` rows; on the slab they land in the
slot's own row past the prompt, as the JAX engine's do, and the mask
keeps them unattended until decode overwrites them. The attention
kernel's launch geometry comes from the shapes alone (the table's full
width, never a host length).

Every prefill's matrix products, an entry's and an eager exact-width
chunk's alike, run at the ceiling's row count (the model's
``product_rows`` argument): a bf16 product's rounding depends on how
many rows the library's kernel is given, so without it a prompt's K/V,
and the greedy tokens after them, would depend on which tier served it,
which differs between engines with different histories (the fleet
replays and migrates requests between them). One divergence is left: a
final piece of one to four tokens attends through the decode kernel,
whose sums run in another order than the tiled kernel's, so its row
(and the tokens after it) can round differently under an exact entry
of that width than under a wider bucket. What the padding costs is
measured on the card (``chip_smoke.py`` phase 24 (d)).

The prefill graphs share one memory pool; that is safe because they
replay on one stream and each graph's output stays alive and is read
before the next replay. An entry's warm-up runs under the engine's
device lock, which the scheduler holds over each prefill and decode
step: it runs kernels (the decode kernel's ticket words among them),
so it must not overlap the scheduler's launches, and it waits for them
to finish before it lets go. The capture launches nothing and runs
outside that lock, on a stream of its own, and without the card-wide
synchronize and cache flush that ``torch.cuda.graph`` starts with, so
a background promotion stalls the scheduler for its warm-up only. Every capture in the process
(a decode graph's too) holds one process-wide lock and runs with
``capture_error_mode="relaxed"``: the engines of a fleet share the
process, and under the stricter modes another thread's synchronizing
call (a token copied to the host, a pool freed) while a graph is being
captured invalidates the capture; relaxed mode leaves other threads'
calls alone, and the lock keeps two captures from sharing the
allocator's capture state. A capture that fails raises, on the
scheduler's thread at its next prefill when it was a background one; a
prefill never carries on eagerly on the card. Off the card an entry is
the same fixed-width body run eagerly, so the tiers, the padding and
the counters can be held against the JAX engine on the CPU. Tiers serve
unified and prefill-role engines; a decode-role engine has none, and a
sharded engine keeps its eager exact-width prefill as a mode (below).

The JAX engine's executable disk cache (``_warm_start``,
``_disk_prefill_exact``) has no counterpart, and ``prefill_disk_hits``
and ``decode_disk_hits`` stay 0: a CUDA graph holds the capturing
process's device addresses, so it cannot be persisted. Every process
captures its decode graph again when it builds the engine, and
``stats()["capture_ms"]`` is what that took on the host's clock (the
warm-up and the capture; 0 when nothing was captured); each prefill
entry's is in :meth:`prefill_graphs`. What a torch process can persist
is Inductor's output (``common/exe_cache.py``).

**A sharded engine** (``mesh=``, the JAX engine's ``mesh``/``tp_axis``/
``ep_axis``): ``tp`` shards the KV pool's kv heads and the attention
heads, ``ep`` the MoE expert banks (``models/transformer.py``). The
design is one engine class and one process per rank, the leader
driving:

* every rank of the mesh builds the engine on its own device, with its
  shard of the weights (``Transformer(cfg, mesh=)`` loaded from
  ``convert.shard_state_dict``) and of the KV pool;
* the rank at coordinate 0 of ``ep × tp`` is the **leader**. It alone
  owns the slot and page bookkeeping, the batcher, the HTTP frontend,
  sampling and the logits;
* every other rank is a **follower**: :meth:`follow` receives each
  device operation from the leader over the mesh's ``ep × tp`` group
  and runs the same operation on its own shards, until the leader's
  :meth:`close` sends "stop". Before it runs an operation the leader
  broadcasts a fixed-size header (operation, batch, t, ...) and then,
  in one more broadcast, the tokens and the ``CacheStep`` inputs
  (cache index or lengths, and page tables); the copy-on-write page
  copy is sent the same way. Prefix hits change tables only and frees
  write nothing, so the followers' pools stay the leader's, whatever
  the manager decides. An idle leader's batcher sends a no-op every
  ``KEEPALIVE_S``, so no follower's wait reaches the group's timeout;
* followers compute no logits: they stop at the last block, and the
  LM head runs on the leader only;
* **the decode step and prefill run eagerly**: their all-reduces sit
  between layers, a gloo collective cannot be captured, and a captured
  NCCL collective cannot be exercised with one card. So
  ``decode_compiles`` and ``prefill_compiles`` stay 0,
  ``stats()["decode_graphed"]`` is 0, and each prefill chunk runs at
  its exact width with no tiers (the followers' protocol carries exact
  widths). This is a mode, not a fallback: the steps still run on the
  card, through the paged kernel on this rank's heads;
* an engine without a mesh, or on a mesh whose ``tp`` and ``ep`` are 1
  (no group), is the engine above, its captured graph included.

A sharded engine refuses a mesh with another axis above 1 (the JAX
engine shards over ``tp_axis`` and ``ep_axis`` only) and the prefill
and decode roles: a sharded worker would have to gather every tp rank's
pages for the wire, and its pages cannot leave the ranks
(:meth:`gather_pages` and :meth:`ingest_attach` raise). A graph per
rank with NCCL collectives captured inside, and the sharded roles, wait
for a 4-card cell (ROADMAP A15).

The model contract: ``model(tokens, cache=, cache_index=, pages=,
paged_attn=)`` (or ``step=`` instead of the index and the pages) returns
``[batch, t, vocab]`` logits and updates the cache in place
(``models/transformer.py``).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from contextlib import nullcontext as _nullcontext
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..common.config import live_config, resolve_device
from ..common.logging import get_logger
from ..common.metrics import registry as _metrics
from ..common import tracing as _tracing
from ..models.transformer import CacheStep, init_cache
from ..ops import paged_attention as _pa
from ..parallel.mesh import AXIS_ORDER
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
DEFAULT_MIN_BUCKET = 8
DEFAULT_PROMOTE_AFTER = 2
DEFAULT_EXACT_CAPACITY = 32  # exact entries kept, LRU
_log = get_logger("serve.engine")
# the leader's control operations (serving on a mesh)
OP_STOP, OP_NOOP, OP_PREFILL, OP_DECODE, OP_COPY = range(5)
_HEADER = 6  # op, batch, t, slot or new page, old page, payload length
KEEPALIVE_S = 5.0  # an idle leader's no-op interval
# one CUDA graph capture at a time in the process, whichever engine or
# thread captures (the module docstring)
_CAPTURE_LOCK = threading.Lock()


class Gathered(NamedTuple):
    """:meth:`InferenceEngine.gather_pages`' result: fresh per-leaf
    ``[n_pages, page_tokens, kv_heads, head_dim]`` buffers and, on a CUDA
    card, the event recorded after the gather on the scheduler's stream
    (a reader on another thread or stream waits on it first)."""

    pages: List[torch.Tensor]
    event: Optional[object]


class _PrefillEntry:
    """One prefill width's entry: its static inputs (one int64 buffer:
    tokens, start, last real position, then the table row or the slab's
    slot) and, on a CUDA card, its graph, the graph's output (the token
    and the last row's logits), the paged launches one replay makes,
    its replays and what making it took on the host's clock (the
    warm-up's share of it apart)."""

    def __init__(self, width: int, tier: str, static: torch.Tensor):
        self.width, self.tier, self.static = width, tier, static
        self.graph = None
        self.out = None
        self.launches: Dict[str, int] = {}
        self.replays = 0
        self.capture_ms = 0.0
        self.warm_ms = 0.0


def _paged_counts() -> Dict[str, int]:
    """This thread's paged-attention launches: a capture's own, whatever
    another engine's thread launches meanwhile."""
    c = _pa.thread_counts()
    return {"paged_attention": c["launches"],
            "paged_attention_chunk": c["chunk_launches"],
            "paged_attention_tc": c["tc_launches"]}


def _control_axis(model, role: str, mesh, tp_axis: str, ep_axis: str):
    """The ``ep × tp`` axis a sharded engine's leader drives its
    followers over, or None for an engine with no group. Raises on what
    the sharded engine does not serve."""
    model_mesh = getattr(model, "mesh", None)
    if mesh is not None:
        other = [a for a, n in zip(AXIS_ORDER, mesh.shape)
                 if a not in (tp_axis, ep_axis) and n > 1]
        if other:
            raise ValueError(
                f"the serving engine shards over '{tp_axis}' and "
                f"'{ep_axis}' only; the mesh has {other} above 1 "
                "(ROADMAP A15)")
    if mesh is None or mesh.size(tp_axis) * mesh.size(ep_axis) == 1:
        if model_mesh is not None and (
                model_mesh.size(model.tp_axis) * model_mesh.size(
                    model.ep_axis) > 1):
            raise ValueError(
                "the model is one rank's shard of a mesh: pass that mesh "
                "to the engine (mesh=)")
        return None
    if role != "unified":
        raise ValueError(
            f"role={role!r} on a mesh: a sharded prefill or decode worker "
            "would gather every tp rank's pages for the wire, which is "
            "queued in ROADMAP A15; serve the mesh as role='unified'")
    if model_mesh is not mesh:
        raise ValueError(
            "a sharded engine serves this rank's shard: build the model "
            "as Transformer(cfg, mesh=mesh) and load "
            "convert.shard_state_dict of the whole state_dict")
    return mesh.axis(ep_axis, tp_axis)


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

    ``mesh`` (a built ``parallel.mesh.Mesh``) shards the engine over
    ``tp_axis`` and ``ep_axis`` (the module docstring): ``model`` is
    then this rank's shard, ``Transformer(cfg, mesh=mesh)``, and
    ``params`` its ``convert.shard_state_dict``. The leader
    (``leader``) is driven as any engine; a follower runs
    :meth:`follow`.
    """

    def __init__(
        self,
        model,
        params=None,
        *,
        slots: int,
        max_len: int,
        device=None,
        min_bucket: int = DEFAULT_MIN_BUCKET,
        prefill_ceiling: Optional[int] = None,
        promote_after: int = DEFAULT_PROMOTE_AFTER,
        exact_capacity: int = DEFAULT_EXACT_CAPACITY,
        paged: Optional[bool] = None,
        page_tokens: Optional[int] = None,
        pages: Optional[int] = None,
        prefix_cache: Optional[bool] = None,
        page_watermark: Optional[int] = None,
        paged_attn=None,
        role: str = "unified",
        mesh=None,
        tp_axis: str = "tp",
        ep_axis: str = "ep",
    ) -> None:
        if role not in ROLES:
            raise ValueError(
                f"role must be unified/prefill/decode, got {role!r}"
            )
        self.role = role
        self.mesh = mesh
        self._ctl = _control_axis(model, role, mesh, tp_axis, ep_axis)
        self.sharded = self._ctl is not None
        self.leader = not self.sharded or self._ctl.index == 0
        self.device = resolve_device(device)
        if params is not None:
            model.load_state_dict(params)
        self.model = model.to(self.device).eval().cast_weights_()
        model_cfg = model.cfg

        def cache_factory(batch, seq):
            return init_cache(model_cfg, batch, seq, device=self.device)

        cfg = live_config()
        self.paged = True if paged is None else bool(paged)
        # chunk ceiling: a power of two that fits the cache
        floor_pow2 = 1 << (int(max_len).bit_length() - 1)
        ceiling = int(prefill_ceiling) if prefill_ceiling else floor_pow2
        self.prefill_ceiling = min(next_pow2(ceiling), floor_pow2)
        # every prefill product's rows (the module docstring); 0, a
        # private switch, runs each at its own width
        self._product_rows = self.prefill_ceiling
        # the prefill tiers (the module docstring); a sharded engine
        # prefills eagerly at exact widths, a decode worker never does
        self._tiers = role != "decode" and not self.sharded
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
            mesh=mesh, tp_axis=tp_axis,
            spare_rows=self.prefill_ceiling if self._tiers else 0,
        )
        self.slots = self.manager.slots
        self.max_len = self.manager.max_len
        self.min_bucket = max(int(min_bucket), 1)
        self.promote_after = max(int(promote_after), 1)
        self._exact_capacity = max(int(exact_capacity), 1)
        self._prefill_exact: "collections.OrderedDict[int, _PrefillEntry]" = (
            collections.OrderedDict())
        self._prefill_bucket: Dict[int, _PrefillEntry] = {}
        self._seen: "collections.OrderedDict[int, int]" = (
            collections.OrderedDict())
        self._promoting: set = set()
        self._promote_threads: List[threading.Thread] = []
        self._promotion_error: Optional[BaseException] = None
        self._prefill_pool = None  # the prefill graphs' shared memory pool
        # entries are graphs on a CUDA card; off (a private switch) they
        # run their body eagerly there too, the reference a check holds
        # the graphs to
        self._graph_prefill = self.device.type == "cuda"
        # paged launches of the prefill graphs: one replay's, summed over
        # the replays and over the captures (where they tick)
        self._prefill_acct = {"captures": 0, "replays": 0,
                              "launched": collections.Counter(),
                              "captured": collections.Counter()}
        self._last_logits: Optional[torch.Tensor] = None
        # held over each prefill and decode step and over a background
        # entry's making (the module docstring)
        self._device_lock = threading.RLock()
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
        # the leader's control stream, held by one thread at a time (the
        # batcher's, a drain's close), its last send, and its end
        self._drive_lock = threading.RLock()
        self._last_send = time.monotonic()
        self._closed = False
        self._failed: Optional[BaseException] = None
        if self.sharded:
            self._ctl_src = self._ctl.ranks[0]
            self._ctl_dev = (torch.device("cpu")
                             if dist.get_backend(self._ctl.group) == "gloo"
                             else self.device)
            if self.paged and self.leader:
                self.manager.copy_hook = self._send_copy
        if self.paged_attn:
            _pa.warm_operator()
        if (self.device.type == "cuda" and role != "prefill"
                and not self.sharded):
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
        token after its last position (on the device). A sharded
        leader sends the chunk to its followers first."""
        table = self.manager.table_row(slot)[None] if self.paged else None
        with self._driving():
            if self.sharded:
                parts = [tokens, [start]]
                if table is not None:
                    parts.append(table.reshape(-1))
                self._send(OP_PREFILL, 1, tokens.size, slot,
                           0 if table is None else table.shape[1], parts)
            logits = self._chunk(slot, tokens, start, table, head=True)
        if self.paged_attn:
            self._counters["paged_attn_calls"] += 1
        return torch.argmax(logits[0, -1])

    def _chunk(self, slot: int, tokens: np.ndarray, start: int,
               table: Optional[np.ndarray], head: bool) -> torch.Tensor:
        """The chunk's forward: logits, or (``head`` False, a follower)
        the final LayerNorm's output. Its products run at the ceiling's
        rows, as the tiers' entries do, so a chunk's K/V are the same
        bits whichever path computes it."""
        toks = torch.as_tensor(np.asarray(tokens)[None], device=self.device)
        index = np.asarray([start], np.int32)
        rows = self._product_rows
        if self.paged:
            return self.model(
                toks, cache=self.manager.cache, cache_index=index,
                pages=table, paged_attn=self.paged_attn,
                return_hidden=not head, product_rows=rows,
            )
        row = [
            {name: leaf[slot:slot + 1] for name, leaf in layer.items()}
            for layer in self.manager.cache
        ]
        return self.model(toks, cache=row, cache_index=index,
                          return_hidden=not head, product_rows=rows)

    @torch.no_grad()
    def prefill(self, slot: int, prompt, trace=None) -> int:
        """Run the prompt through the slot's cache; returns the first
        greedy token. The final prompt token is always recomputed, even
        on a full prefix hit, so its logits exist and shared pages are
        never written. Each chunk runs through the prefill tiers (the
        module docstring), or eagerly at its exact width on a sharded
        engine. The slot's full prompt pages are published into the
        prefix index afterwards."""
        if self.role == "decode":
            raise RuntimeError(
                "prefill on a decode-role engine: decode workers take "
                "finished KV pages over the transfer wire "
                "(serving/kv_transfer.py), never prompts"
            )
        self._check_leader("prefill")
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
        if self._tiers:
            with self._device_lock:
                tok = self._prefill_tiered(slot, prompt, start, trace)
        else:
            tok = self._prefill_exact_widths(slot, prompt, start, trace)
        self.manager.set_length(slot, n)
        self._counters["prefills"] += 1
        if self.paged and hashes:
            self.manager.publish_prefix(slot, hashes)
        return tok

    def _prefill_exact_widths(self, slot: int, prompt: np.ndarray,
                              start: int, trace) -> int:
        """The eager prefill: each chunk at its exact width, no pads (a
        sharded engine's, sent to its followers chunk by chunk)."""
        n = prompt.size
        while True:
            width = min(n - start, self.prefill_ceiling)
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
                return int(tok)
            self._counters["chunked_prefill_chunks"] += 1

    # ----------------------------------------------------- the prefill tiers

    def _prefill_tiered(self, slot: int, prompt: np.ndarray, start: int,
                        trace) -> int:
        """The JAX engine's chunk loop over the tiers: full chunks at the
        ceiling through its bucket entry, then the rest through
        :meth:`_get_prefill_entry`."""
        err, self._promotion_error = self._promotion_error, None
        if err is not None:
            raise RuntimeError(
                "a background prefill promotion failed") from err
        n = prompt.size
        ceiling = self.prefill_ceiling
        while n - start > ceiling:
            entry = self._bucket_entry(ceiling)
            self._counters["chunked_prefill_chunks"] += 1
            self._run_entry(entry, slot, prompt[start:start + ceiling],
                            start, trace)
            start += ceiling
        entry = self._get_prefill_entry(n - start, avail=self.max_len - start)
        return int(self._run_entry(entry, slot, prompt[start:], start, trace))

    def _bucket_entry(self, width: int) -> _PrefillEntry:
        """The bucket tier's entry of ``width`` tokens, made on a miss
        (the JAX engine's ``_bucket_exe``)."""
        entry = self._prefill_bucket.get(width)
        if entry is None:
            entry = self._make_entry(width, "bucket")
            with self._lock:
                self._prefill_bucket[width] = entry
        else:
            self._counters["prefill_bucket_hits"] += 1
        return entry

    def _get_prefill_entry(self, length: int,
                           avail: Optional[int] = None) -> _PrefillEntry:
        """The two-tier lookup for a final piece of ``length`` tokens
        (the JAX engine's ``_get_prefill_exe``): the exact entry when
        promoted, else the bucket, whose pads count
        ``prefill_pad_tokens``. The ``promote_after``-th sighting of a
        length starts its background promotion; a bucket wider than
        ``avail`` (the slot's room) makes the exact entry here."""
        with self._lock:  # a promotion installs and evicts under it
            entry = self._prefill_exact.get(length)
            if entry is not None:
                self._prefill_exact.move_to_end(length)
                self._counters["prefill_exact_hits"] += 1
                return entry
        count = self._seen.get(length, 0) + 1
        self._seen[length] = count
        self._seen.move_to_end(length)
        while len(self._seen) > 4 * self._exact_capacity:
            self._seen.popitem(last=False)
        bucket = min(max(next_pow2(length), self.min_bucket),
                     self.prefill_ceiling)
        forced = avail is not None and bucket > avail
        if forced:
            entry = self._make_entry(length, "exact")
            self._install_exact(length, entry)
            return entry
        if count >= self.promote_after:
            self._spawn_promotion(length)
        entry = self._bucket_entry(bucket)
        self._counters["prefill_pad_tokens"] += bucket - length
        return entry

    def _install_exact(self, length: int, entry: _PrefillEntry) -> None:
        with self._lock:
            self._prefill_exact[length] = entry
            self._counters["prefill_promotions"] += 1
            while len(self._prefill_exact) > self._exact_capacity:
                self._prefill_exact.popitem(last=False)

    def _spawn_promotion(self, length: int) -> None:
        """Make the exact entry of ``length`` in a background thread and
        install it when ready; the bucket serves meanwhile. One thread a
        length at a time. A failure is raised at the next prefill."""
        with self._lock:
            if length in self._promoting:
                return
            self._promoting.add(length)

        def work():
            try:
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                with torch.no_grad():
                    entry = self._make_entry(length, "exact")
                self._install_exact(length, entry)
                with self._lock:
                    self._counters["prefill_bg_promotions"] += 1
            except BaseException as e:  # raised at the next prefill
                _log.error("background promotion of width %d failed: %s",
                           length, e)
                self._promotion_error = e
            finally:
                with self._lock:
                    self._promoting.discard(length)

        t = threading.Thread(target=work, daemon=True,
                             name=f"serve-promote-{length}")
        self._promote_threads.append(t)
        t.start()

    def drain_promotions(self, timeout: float = 60.0) -> bool:
        """Join the background promotions; True when every one landed."""
        deadline = time.monotonic() + timeout
        for t in list(self._promote_threads):
            t.join(max(deadline - time.monotonic(), 0.0))
        self._promote_threads = [t for t in self._promote_threads
                                 if t.is_alive()]
        return not self._promote_threads

    def _make_entry(self, width: int, tier: str) -> _PrefillEntry:
        """A new entry of ``width`` tokens, captured on a CUDA card: the
        warm-up under the device lock, the capture outside it. Its
        static inputs start at a real length of 0 (every row a pad) on
        an all-sentinel table, or on the slab's spare slot row, so the
        warm-up writes no row a slot owns."""
        mgr = self.manager
        extra = mgr.pages_per_slot if self.paged else 1
        static = torch.zeros(width + 2 + extra, dtype=torch.int64,
                             device=self.device)
        static[width + 1] = -1
        static[width + 2:] = mgr.sentinel if self.paged else mgr.spare_slot
        entry = _PrefillEntry(width, tier, static)
        if self._graph_prefill:
            with self._device_lock:
                self._warm_prefill(entry)
            self._capture_prefill(entry)
        with self._lock:
            self._counters["prefill_compiles"] += 1
        return entry

    def _prefill_body(self, entry: _PrefillEntry):
        """The fixed-width chunk forward over ``entry``'s static inputs:
        what its graph captures, and the prefill off the card. Returns
        the greedy token at the last real position and that row's fp32
        logits (the LM head runs on that row alone)."""
        w, buf = entry.width, entry.static
        start = buf[w:w + 1].to(torch.int32)
        last = buf[w + 1:w + 2]
        mgr = self.manager
        if self.paged:
            cache = mgr.full_cache
            step = CacheStep.on_device(cache, start, buf[w + 2:].view(1, -1),
                                       w, mgr.spare_row0, valid=last + 1)
        else:
            # the slab as a pool of one page a slot: the slot a device
            # index, so one graph a width serves every slot (the spare
            # slot row included)
            cache = mgr.full_cache
            slot = buf[w + 2:w + 3]
            dst = (slot * mgr.max_len + buf[w:w + 1]
                   + torch.arange(w, device=buf.device))
            step = CacheStep(index=start, table=slot.view(1, 1).to(
                torch.int32), src=None, dst=dst)
        hidden = self.model(buf[:w].view(1, w), cache=cache, step=step,
                            paged_attn=self.paged_attn, return_hidden=True,
                            product_rows=self._product_rows)
        logits = self.model.lm_head(
            hidden[0].index_select(0, last.clamp(min=0)))[0]
        return torch.argmax(logits), logits

    @torch.no_grad()
    def _warm_prefill(self, entry: _PrefillEntry) -> None:
        """Run ``entry``'s body once on a side stream (kernels built, the
        decode kernel's ticket words grown) and wait for it: the caller
        holds the device lock, so it overlaps no launch of the
        scheduler's."""
        dev = self.device
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._prefill_body(entry)
        side.synchronize()
        entry.warm_ms = (time.perf_counter() - t0) * 1e3
        entry.capture_ms += entry.warm_ms

    @torch.no_grad()
    def _capture_prefill(self, entry: _PrefillEntry) -> None:
        """Capture ``entry``'s warmed body into a CUDA graph in the
        prefill graphs' shared pool, on a stream of its own (one capture
        at a time in the process, relaxed mode). A capture launches
        nothing, so the scheduler's replays go on meanwhile; it begins
        and ends the capture itself, since ``torch.cuda.graph`` first
        synchronizes the card and empties the allocator's cache, which
        would stall the scheduler's steps."""
        dev = self.device
        t0 = time.perf_counter()
        if self._prefill_pool is None:
            self._prefill_pool = torch.cuda.graph_pool_handle()
        before = _paged_counts()
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, torch.cuda.stream(torch.cuda.Stream(dev)):
            graph.capture_begin(pool=self._prefill_pool,
                                capture_error_mode="relaxed")
            try:
                out = self._prefill_body(entry)
            finally:
                graph.capture_end()
        after = _paged_counts()
        entry.launches = {k: after[k] - before[k] for k in after}
        entry.graph, entry.out = graph, out
        entry.capture_ms += (time.perf_counter() - t0) * 1e3
        with self._lock:
            self._prefill_acct["captures"] += 1
            self._prefill_acct["captured"].update(entry.launches)

    def _run_entry(self, entry: _PrefillEntry, slot: int,
                   tokens: np.ndarray, start: int, trace) -> torch.Tensor:
        """One chunk through ``entry``: its static inputs loaded in one
        copy, then a replay (or the body, off the card). Returns the
        greedy token on the device."""
        w, real = entry.width, tokens.size
        span = _tracing.start_span(
            "engine.prefill_chunk", trace, start=start, width=w, slot=slot,
            real=real,
        )
        host = np.zeros(entry.static.numel(), np.int64)
        host[:real] = tokens
        host[w], host[w + 1] = start, real - 1
        host[w + 2:] = (self.manager.table_row(slot) if self.paged
                        else slot)
        entry.static.copy_(torch.from_numpy(host))
        self._note_stream()
        if entry.graph is not None:
            entry.graph.replay()
            entry.replays += 1
            with self._lock:
                self._prefill_acct["replays"] += 1
                self._prefill_acct["launched"].update(entry.launches)
            tok, self._last_logits = entry.out
        else:
            tok, self._last_logits = self._prefill_body(entry)
        if span is not None:
            span.end()
        if self.paged_attn:
            self._counters["paged_attn_calls"] += 1
        return tok

    def prefill_launches(self) -> Dict[str, object]:
        """The prefill graphs' accounting over the engine's life (evicted
        entries included): captures, replays, and by counter the paged
        launches the replays made (``launched``) and the ones the
        captures ticked without launching (``captured``). The launches a
        run made are the counter plus ``launched - captured``."""
        with self._lock:
            acct = self._prefill_acct
            return {"captures": acct["captures"], "replays": acct["replays"],
                    "launched": dict(acct["launched"]),
                    "captured": dict(acct["captured"])}

    def prefill_graphs(self) -> List[Dict[str, object]]:
        """Every live prefill entry: its width, tier, replays, the paged
        launches one replay makes (empty off the card) and what making
        it took (``capture_ms``, host clock; ``warm_ms`` the warm-up's
        share, for which the scheduler waits). A launch counter ticks at
        capture only, so the launches the replays made are
        ``replays × per_replay``."""
        with self._lock:
            entries = (list(self._prefill_bucket.values())
                       + list(self._prefill_exact.values()))
        return [{"width": e.width, "tier": e.tier, "replays": e.replays,
                 "per_replay": dict(e.launches), "capture_ms": e.capture_ms,
                 "warm_ms": e.warm_ms, "graphed": e.graph is not None}
                for e in entries]

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
        self._check_leader("decode_step")
        tokens = np.asarray(tokens, np.int32).reshape(self.slots)
        if self.paged:
            if not self._decode_swept:
                starved = self.prepare_decode()
                if starved:
                    raise PagePoolExhausted(starved)
            self._decode_swept = False
        self._note_stream()
        with self._device_lock:
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
        the captured graph on a CUDA card; elsewhere, and on a sharded
        engine (sent to the followers first), the same body, run
        eagerly."""
        if self.sharded:
            mgr = self.manager
            lengths = mgr.lengths_array()
            tables = mgr.tables_array() if self.paged else None
            with self._driving():
                parts = [tokens, lengths]
                if tables is not None:
                    parts.append(tables.reshape(-1))
                self._send(OP_DECODE, self.slots, 1, 0,
                           0 if tables is None else tables.shape[1], parts)
                self._load_static(tokens, lengths, tables)
                return self._decode_body()
        self._load_static(tokens)
        if self.device.type != "cuda":
            return self._decode_body()
        if self._graph is None:
            self._capture()
        self._graph.replay()
        self._graph_replays += 1
        return self._graph_out

    def _load_static(self, tokens: np.ndarray,
                     lengths: Optional[np.ndarray] = None,
                     tables: Optional[np.ndarray] = None) -> None:
        """Copy the step's tokens, lengths and page tables (the
        manager's unless given) into the step's static inputs (made on
        the first call), which the graph reads on a CUDA card."""
        mgr = self.manager
        if lengths is None:
            lengths = mgr.lengths_array()
            tables = mgr.tables_array() if self.paged else None
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
        st["lengths"].copy_(torch.from_numpy(
            np.asarray(lengths, np.int32)))
        if self.paged:
            st["tables"].copy_(torch.from_numpy(
                np.asarray(tables, np.int32)))

    def _decode_body(self, head: bool = True) -> torch.Tensor:
        """The decode forward over the static inputs, with the write
        rows built on the device: what the graph captures, and the
        decode step off the card and on a sharded engine (a follower's,
        ``head`` False, stops at the final LayerNorm)."""
        mgr = self.manager
        st = self._static
        cache = mgr.full_cache if self.paged else mgr.cache
        step = CacheStep.on_device(cache, st["lengths"], st["tables"], 1,
                                   getattr(mgr, "spare_row0", None))
        return self.model(st["tokens"], cache=cache, step=step,
                          paged_attn=self.paged_attn,
                          return_hidden=not head)[:, 0, :]

    @torch.no_grad()
    def _capture(self) -> None:
        """Warm the decode forward up once on a side stream (kernels
        built, the decode kernel's ticket words grown), then capture it
        into a CUDA graph. The warm-up writes the loaded step's k/v
        (spare rows only at construction; on a prefill worker's first
        local decode, rows the first replay writes again with the same
        values). Other threads may use the card meanwhile (the module
        docstring: one capture at a time, relaxed mode)."""
        dev = self.device
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._decode_body()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = _paged_counts()
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, torch.cuda.graph(
                graph, stream=torch.cuda.Stream(dev),
                capture_error_mode="relaxed"):
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

    # ------------------------------------------------------- the mesh's ranks

    def _check_leader(self, what: str) -> None:
        if not self.leader:
            raise RuntimeError(
                f"{what} on a follower rank of a sharded engine: the "
                "leader drives; a follower runs follow()"
            )

    def _whole_pool(self, what: str) -> None:
        if self.sharded:
            raise RuntimeError(
                f"{what}: a sharded engine's pages hold this rank's kv "
                "heads only; the page wire over tp ranks is ROADMAP A15"
            )

    @contextlib.contextmanager
    def _driving(self):
        """The leader's control stream, held for one operation (its
        sends and its forward): a failure inside leaves a sharded
        engine failed, since its followers are then out of step."""
        with self._drive_lock:
            if self._failed is not None:
                raise RuntimeError(
                    "the sharded engine's control stream failed earlier; "
                    "its followers are out of step") from self._failed
            if self._closed:
                raise RuntimeError("the sharded engine was closed: its "
                                   "followers have stopped")
            try:
                yield
            except BaseException as e:
                if self.sharded:
                    self._failed = e
                raise

    def _send(self, op: int, batch: int = 0, t: int = 0, a: int = 0,
              b: int = 0, parts=()) -> None:
        """Broadcast one operation to the followers: the header, then
        its payload (``parts`` flattened to one int64 tensor)."""
        payload = (np.concatenate([np.asarray(p, np.int64).reshape(-1)
                                   for p in parts])
                   if len(parts) else np.zeros(0, np.int64))
        header = torch.tensor([op, batch, t, a, b, payload.size],
                              dtype=torch.int64, device=self._ctl_dev)
        dist.broadcast(header, src=self._ctl_src, group=self._ctl.group)
        if payload.size:
            dist.broadcast(torch.from_numpy(payload).to(self._ctl_dev),
                           src=self._ctl_src, group=self._ctl.group)
        self._last_send = time.monotonic()
        with self._lock:
            self._counters["control_ops"] += 1
            self._counters["control_broadcasts"] += 1 + bool(payload.size)

    def _send_copy(self, new: int, old: int) -> None:
        """The manager's copy-on-write hook: the followers copy the same
        page in their pools before the leader does in its own."""
        with self._driving():
            self._send(OP_COPY, 0, 0, new, old)

    def keepalive(self) -> None:
        """An idle sharded leader's no-op, at most one a ``KEEPALIVE_S``
        (the batcher calls it when it has nothing to do); a no-op
        elsewhere."""
        if not self.sharded or not self.leader:
            return
        with self._drive_lock:
            if (self._closed or self._failed is not None
                    or time.monotonic() - self._last_send < KEEPALIVE_S):
                return
            with self._driving():
                self._send(OP_NOOP)

    def close(self) -> None:
        """The leader's "stop": every follower's :meth:`follow` returns,
        and this engine takes no more work. Idempotent; a no-op on an
        unsharded engine, on a follower and after a failed operation
        (the followers are out of step: they end on the group's
        error)."""
        if not self.sharded or not self.leader:
            return
        with self._drive_lock:
            if self._closed or self._failed is not None:
                return
            self._send(OP_STOP)
            self._closed = True

    @torch.no_grad()
    def follow(self) -> int:
        """A follower's loop: receive each operation the leader sends and
        run it on this rank's shards, until "stop". Returns the number
        of operations run. Raises when the operation raises (the
        leader's next collective then fails, and its requests end
        ``error``)."""
        if not self.sharded or self.leader:
            raise RuntimeError("follow() runs on a follower rank of a "
                               "sharded engine")
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        header = torch.zeros(_HEADER, dtype=torch.int64,
                             device=self._ctl_dev)
        ran = 0
        while True:
            dist.broadcast(header, src=self._ctl_src, group=self._ctl.group)
            op, batch, t, a, b, n = (int(v) for v in header.tolist())
            payload = np.zeros(0, np.int64)
            if n:
                buf = torch.zeros(n, dtype=torch.int64, device=self._ctl_dev)
                dist.broadcast(buf, src=self._ctl_src, group=self._ctl.group)
                payload = buf.cpu().numpy()
            if op == OP_STOP:
                return ran
            if op == OP_NOOP:
                continue
            self._note_stream()
            if op == OP_COPY:
                self.manager.copy_page(a, b)
            elif op == OP_PREFILL:
                table = payload[t + 1:].reshape(1, b) if b else None
                self._chunk(a, payload[:t], int(payload[t]), table,
                            head=False)
                with self._lock:
                    self._counters["chunks_followed"] += 1
            elif op == OP_DECODE:
                tokens = payload[:batch]
                lengths = payload[batch:2 * batch]
                tables = (payload[2 * batch:].reshape(batch, b) if b
                          else None)
                self._load_static(tokens, lengths, tables)
                self._decode_body(head=False)
                with self._lock:
                    self._counters["decode_steps"] += 1
            else:
                raise RuntimeError(f"unknown control operation {op}")
            ran += 1

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
        self._whole_pool("gather_pages")
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
        self._whole_pool("ingest_attach")
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
        out["prefill_exact_entries"] = len(self._prefill_exact)
        out["prefill_bucket_entries"] = len(self._prefill_bucket)
        graphs = self.prefill_graphs()
        out["prefill_graphs"] = sum(g["graphed"] for g in graphs)
        out["prefill_capture_ms"] = sum(g["capture_ms"] for g in graphs)
        # a sharded engine's decode is eager (decode_graphed 0); its
        # leader's control stream: operations and broadcasts sent
        out["decode_graphed"] = int(self._graph is not None)
        out["capture_ms"] = self._capture_ms
        out["mesh_ranks"] = self._ctl.size if self.sharded else 1
        out.setdefault("control_ops", 0)
        out.setdefault("control_broadcasts", 0)
        return out

    def publish(self) -> None:
        _metrics.update("serve", self.stats())
