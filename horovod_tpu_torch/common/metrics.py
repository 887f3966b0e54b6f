"""Process-wide metrics registry: named counters and gauges, and their
JSON-lines export.

The counterpart of ``horovod_tpu/common/metrics.py``. Subsystems bump
metrics by dotted name (the fusion manager its ``fusion.*`` ledger after
every cycle, the serving plane ``serve.*``, the bucketed overlap its
schedule through :func:`publish_overlap`, the stall inspector
``stall.*``); ``/metrics`` renders a snapshot as Prometheus text
(``common/telemetry.py``). ``HOROVOD_METRICS_FILE`` (or an explicit
``dump``/``configure_export`` call) appends JSON lines:

    {"ts": <unix>, "seq": <monotonic>, "name": "fusion.cycles", "value": 17}

Dumps are delta-aware: after the first full snapshot only changed values
are appended (``dump(force=True)`` re-emits everything). Thread-safe;
values are floats. The legends below name each family once, so
dashboards and tests never re-derive the spelling.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

# Enum gauges are exported as integer codes (JSON-lines values are
# floats); this is the shared wire-format legend — fusion's
# ``fusion.wire_format`` gauge and the timeline's counter track both
# use it, so a trace and a metrics dump decode identically.
WIRE_FORMAT_CODES = {"fp32": 0, "bf16": 1, "int8": 2}
WIRE_FORMAT_NAMES = {v: k for k, v in WIRE_FORMAT_CODES.items()}

# Two-level (topology-aware) wire metric families — the per-hop split
# of the fused dispatcher's wire ledger plus the driver's
# straggler-rebalance surface. Emitters: ops/fusion.py cache_stats
# (fusion.*), elastic/driver.py (driver.rebalance.*). Kept here as the
# single legend so dashboards and tests never re-derive the spelling:
#   fusion.hier_dispatches         fused batches that rode the two-level
#                                  recipe (counter)
#   fusion.wire_bytes_saved_intra  intra-hop (intra-node) bytes removed vs the
#                                  flat fp32 baseline (counter)
#   fusion.wire_bytes_saved_inter  inter-hop (inter-node) bytes removed — the
#                                  scarce-hop meter (counter)
#   fusion.wire_format_intra/inter last dispatch's per-hop wire, as a
#                                  WIRE_FORMAT_CODES code (gauge)
#   driver.rebalance.active        ranks currently down-weighted (gauge)
#   driver.rebalance.updates       weight-map publications (counter)
HIERARCHY_METRICS = (
    "fusion.hier_dispatches",
    "fusion.wire_bytes_saved_intra",
    "fusion.wire_bytes_saved_inter",
    "fusion.wire_format_intra",
    "fusion.wire_format_inter",
    "driver.rebalance.active",
    "driver.rebalance.updates",
)

# Local-SGD metric family (local_sgd.py — the K-step
# semi-synchronous regime). Emitters: the host round driver
# (local_sgd.maybe_sync / run_round), the fused dispatcher's phase
# routing, and the elastic driver's heartbeat aggregation. One legend:
#   local_sgd.local_steps       optimizer steps taken under the mode
#                               (counter; local_steps / sync_rounds
#                               ≈ the effective K)
#   local_sgd.sync_rounds       reconciliation rounds completed
#                               (counter)
#   local_sgd.rounds_deferred   rounds pushed out by an inter-node failure
#                               after the retry ladder (counter —
#                               degraded-not-stalled evidence)
#   local_sgd.inter_bytes       modeled per-rank inter-node bytes the rounds
#                               that RAN moved (counter; the ÷K lever)
#   fusion.local_dispatches     eager fused allreduces routed
#                               intra-only under an active phase
#                               (counter)
#   driver.local_sgd.rounds_deferred  gang-max deferral count from the
#                               heartbeat ledger (gauge)
LOCAL_SGD_METRICS = (
    "local_sgd.local_steps",
    "local_sgd.sync_rounds",
    "local_sgd.rounds_deferred",
    "local_sgd.inter_bytes",
    "fusion.local_dispatches",
    "driver.local_sgd.rounds_deferred",
)

# Expert-wire metric families (parallel/moe.py +
# ops/fusion.py eager alltoall). Emitters: the fusion manager's flush
# (alltoall.*, cumulative, so the flight recorder sees the expert
# dispatch's bytes) and :func:`publish_moe` (moe.*, the
# step harness / serving loop publishes the MoEStats counters plus the
# capacity decision in force). Kept here as the single legend so
# dashboards and tests never re-derive the spelling:
#   alltoall.dispatches       eager alltoall executor invocations
#                             (counter)
#   alltoall.wire_bytes       cumulative (n-1)/n-model bytes those
#                             dispatches moved (counter)
#   moe.dropped_tokens        tokens past the capacity gate (counter)
#   moe.routed_tokens         live tokens routed (counter)
#   moe.expert_tokens_max     hottest expert's kept tokens, last step
#                             (gauge)
#   moe.imbalance             hottest / mean kept tokens (gauge; 1.0 =
#                             balanced — hot experts ARE stragglers)
#   moe.drop_rate             dropped / routed, last step (gauge)
#   moe.capacity_factor       the factor in force (gauge; the
#                             CapacityTuner's decision when tuned)
MOE_METRICS = (
    "alltoall.dispatches",
    "alltoall.wire_bytes",
    "moe.dropped_tokens",
    "moe.routed_tokens",
    "moe.expert_tokens_max",
    "moe.imbalance",
    "moe.drop_rate",
    "moe.capacity_factor",
)

# Training-state integrity metric families (the names the
# runbook in docs/robustness.md documents; emitters: common/guard.py,
# audit.py, checkpoint.py, elastic/driver.py). Kept here as the single
# legend so dashboards and tests never re-derive the spelling:
#   guard.nonfinite_steps    skipped optimizer updates (counter)
#   guard.nonfinite_batches  non-finite fused eager batches (counter)
#   guard.skip_streak        consecutive skips at last skip (gauge)
#   audit.digests            parameter digests computed (counter)
#   audit.last_digest_step   step of the newest digest (gauge)
#   checkpoint.digest_mismatch  corrupt-but-parseable restores (counter)
#   driver.divergence_restarts  gang restarts for replica divergence
INTEGRITY_METRICS = (
    "guard.nonfinite_steps",
    "guard.nonfinite_batches",
    "guard.skip_streak",
    "audit.digests",
    "audit.last_digest_step",
    "checkpoint.digest_mismatch",
    "driver.divergence_restarts",
)

# Serving memory-plane metric families (serving/paged_kv.py — the
# names the docs/serving.md "memory plane" runbook documents; emitter:
# PagedKVCacheManager.stats → the `serve.` registry prefix, rendered
# as `hvd_serve_*` on /metrics). Kept here as the single legend so
# dashboards and tests never re-derive the spelling:
#   serve.pages_total / pages_free   pool size / free-list pages (gauge)
#   serve.pages_active               pages held by live slots (gauge)
#   serve.pages_cached               pages held ONLY by the prefix
#                                    index — reclaimable (gauge)
#   serve.page_allocs                pages taken at write frontiers
#                                    (counter)
#   serve.page_evictions             LRU index evictions at refcount 0
#                                    (counter)
#   serve.page_cow                   copy-on-write page copies (counter;
#                                    0 under the shipped sharing policy)
#   serve.prefix_hits                cached pages attached instead of
#                                    prefilled (counter)
#   serve.prefix_hit_requests / prefix_lookups / prefix_hit_rate
#                                    request-level hit accounting
#   serve.prefix_published           pages published into the index
#   serve.paused / serve.resumed     pool-exhaustion preemptions and
#                                    their resumes (counters)
#   serve.paused_pages_reclaimed     paused requests whose kept pages
#                                    were reclaimed past the deadline
#                                    (counter; they re-prefill)
SERVING_PAGE_METRICS = (
    "serve.pages_total",
    "serve.pages_free",
    "serve.pages_active",
    "serve.pages_cached",
    "serve.page_allocs",
    "serve.page_evictions",
    "serve.page_cow",
    "serve.prefix_hits",
    "serve.prefix_hit_requests",
    "serve.prefix_lookups",
    "serve.prefix_hit_rate",
    "serve.prefix_published",
    "serve.paused",
    "serve.resumed",
    "serve.paused_pages_reclaimed",
)

# KV-transfer wire families (serving/kv_transfer.py — the
# disaggregated-fleet stream; legend for docs/observability.md's
# transfer table, rendered as `hvd_serve_*` on /metrics):
#   sender (prefill worker):
#   serve.kv_transfer_bytes / _pages / _ms   framed bytes, pages and
#                                    wall-ms streamed out (counters —
#                                    bytes/pages is the wire's realized
#                                    compression ratio)
#   serve.transfers                  requests successfully streamed out
#   serve.transfer_local             no decode capacity at reserve time
#                                    → decoded locally, never streamed
#   serve.transfer_fallbacks         stream/decode FAILED after
#                                    prefill → request came home for a
#                                    pointer-cheap local decode
#   serve.handed_off                 remote decode completed and the
#                                    waiter was released
#   receiver (decode worker):
#   serve.kv_transfer_bytes_in / _pages_in   framed bytes / pages landed
#   serve.transfer_admits            ingested requests pointer-attached
#                                    into decode slots (counter)
#   serve.transfer_reservations / _reserve_denied
#                                    page reservations granted / denied
#   serve.transfer_pages_in          pool pages taken by ingests
#                                    (PagedKVCacheManager counter)
#   serve.transfer_ingests           engine-level ingest writes
SERVING_TRANSFER_METRICS = (
    "serve.kv_transfer_bytes",
    "serve.kv_transfer_pages",
    "serve.kv_transfer_ms",
    "serve.transfers",
    "serve.transfer_local",
    "serve.transfer_fallbacks",
    "serve.handed_off",
    "serve.kv_transfer_bytes_in",
    "serve.kv_transfer_pages_in",
    "serve.transfer_admits",
    "serve.transfer_reservations",
    "serve.transfer_reserve_denied",
    "serve.transfer_pages_in",
    "serve.transfer_ingests",
)

# Paged-attention kernel path (ops/paged_attention.py through
# serving/engine.py and models/transformer.py — legend for the
# docs/observability.md counter table):
#   serve.paged_attn_calls       executable invocations (decode steps +
#                                prefill chunks) that ran the fused
#                                pool-read kernel (counter; engine
#                                stats → `serve.` prefix)
#   serve.paged_attn_fallbacks   kernel requested but the fallback
#                                ladder rode the gather read instead —
#                                bumped once at engine resolution and
#                                at model trace time (counter)
SERVING_PAGED_ATTN_METRICS = (
    "serve.paged_attn_calls",
    "serve.paged_attn_fallbacks",
)

# Crash-safe serving families (router durability + live
# migration, serving/frontend.py + serving/kv_transfer.py; the
# docs/robustness.md "serving failure ladder" runbook, rendered as
# `hvd_serve_*` on /metrics):
#   serve.replay_dedupe_hits     /generate answered from the TTL ledger
#                                by client request_id — a retry or a
#                                hedge loser absorbed without recompute
#   serve.replays                routed payloads replayed on a live
#                                peer after a DARK worker failure (an
#                                orderly 503 fails over without one)
#   serve.hedges                 hedged second launches past
#                                HOROVOD_SERVE_HEDGE_MS (first writer
#                                wins)
#   serve.migrations             in-flight sequences streamed OUT past
#                                the drain deadline (sender counter)
#   serve.migrations_in          migrated sequences landed and resumed
#                                mid-decode (receiver counter)
#   serve.migration_ms           pack + wire wall-ms per migration
#                                (sender counter)
SERVING_FAILOVER_METRICS = (
    "serve.replay_dedupe_hits",
    "serve.replays",
    "serve.hedges",
    "serve.migrations",
    "serve.migrations_in",
    "serve.migration_ms",
)

# The persistent compiled-artifact store and the warm restart
# (common/exe_cache.py, elastic/driver.py and standby.py, the elastic
# worker's init; analysis/sched_audit.py for the schedule audit):
#   exe_cache.hits / misses       disk-tier lookups that loaded an entry
#                                 / found none (counters)
#   exe_cache.corrupt             torn or bit-flipped entries, or
#                                 payloads Inductor refused, degraded to
#                                 a cold compile (counter; chaos site
#                                 `exe_cache.load`)
#   exe_cache.rejected            entries refused by the invalidation
#                                 rules (torch, CUDA, capability,
#                                 Triton, platform, topology, wire,
#                                 donation), never loaded (counter)
#   exe_cache.stores              entries made and queued (counter)
#   exe_cache.bytes               entry bytes read on hits (counter)
#   exe_cache.deserialize_ms      wall-ms loading payloads into
#                                 Inductor's caches (counter)
#   elastic.restart_ms            gang teardown to this worker's init,
#                                 wall-ms (gauge, per worker)
#   elastic.restart_warm          1.0 when a warm standby absorbed the
#                                 restart (gauge)
#   serve.scaleup_ms              restart_ms of a serve-saturation grow
#                                 restart (gauge)
#   driver.standby.reserved       hosts held as warm standbys (gauge)
#   driver.standby.swapins        standbys released into a gang
#                                 (counter)
#   audit.sched_published         schedule fingerprints published
#                                 (counter); audit.sched_dispatches and
#                                 audit.sched_last_step are its gauges
#   driver.sched_divergence_restarts  gang restarts for a divergent
#                                 collective schedule (counter)
EXE_CACHE_METRICS = (
    "exe_cache.hits",
    "exe_cache.misses",
    "exe_cache.corrupt",
    "exe_cache.rejected",
    "exe_cache.stores",
    "exe_cache.bytes",
    "exe_cache.deserialize_ms",
    "elastic.restart_ms",
    "elastic.restart_warm",
    "serve.scaleup_ms",
    "driver.standby.reserved",
    "driver.standby.swapins",
    "audit.sched_published",
    "driver.sched_divergence_restarts",
)


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._values: Dict[str, float] = {}
        self._path: Optional[str] = None
        self._last_dump = 0.0
        # delta-aware export state: what the sink last saw, plus a
        # monotonic per-line sequence number so readers can totally
        # order lines even when ts collides
        self._last_dumped: Optional[Dict[str, float]] = None
        self._seq = 0

    # -- write side ---------------------------------------------------

    def counter(self, name: str, inc: float = 1.0) -> None:
        with self._lock:
            self._values[name] = self._values.get(name, 0.0) + inc

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._values[name] = float(value)

    def update(self, prefix: str, stats: Dict[str, float]) -> None:
        """Publish a dict of gauges under a common prefix (the shape
        fusion.cache_stats() and autotune samples come in)."""
        with self._lock:
            for k, v in stats.items():
                self._values[f"{prefix}.{k}"] = float(v)

    # -- read side ----------------------------------------------------

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._values)

    def reset(self) -> None:
        with self._lock:
            self._values.clear()
            # the sink's view is stale too: next dump re-baselines with
            # a full snapshot (seq stays monotonic across resets)
            self._last_dumped = None

    # -- export -------------------------------------------------------

    @property
    def exporting(self) -> bool:
        """True when a JSON-lines sink is configured — subsystems use
        this to skip observability work that forces a device sync
        (e.g. the fusion manager's EF-residual norm)."""
        return self._path is not None

    def configure_export(self, path: Optional[str] = None) -> None:
        """Set (or clear) the JSON-lines sink. Defaults from
        HOROVOD_METRICS_FILE; explicit path wins."""
        if path is None:
            path = os.environ.get("HOROVOD_METRICS_FILE") or None
        with self._lock:
            if path != self._path:
                # a fresh sink has seen nothing: first write is full
                self._last_dumped = None
            self._path = path

    def maybe_dump(self, min_interval: float = 1.0) -> Optional[str]:
        """Rate-limited dump for hot paths (the fusion flush calls
        this): at most one append per ``min_interval`` seconds, nothing
        when no sink is configured."""
        if not self._path:
            return None
        now = time.monotonic()
        with self._lock:
            if now - self._last_dump < min_interval:
                return None
            self._last_dump = now
        return self.dump()

    def dump(
        self, path: Optional[str] = None, force: bool = False
    ) -> Optional[str]:
        """Append metric lines to the sink; returns the path written
        (None when no sink is configured).

        Delta-aware: only metrics whose value CHANGED since the last
        dump are appended — a long run's periodic export stops paying
        O(total metrics) lines per interval. The first write to a sink
        and ``dump(force=True)`` emit the full snapshot (so a reader can
        always reconstruct state from the last full snapshot forward);
        an explicit ``path`` different from the configured sink also
        gets a full snapshot, without disturbing the sink's delta state.
        Every line carries a monotonic ``seq``."""
        explicit = path is not None and path != self._path
        path = path or self._path
        if not path:
            return None
        now = time.time()
        snap = self.snapshot()
        with self._lock:
            prev = self._last_dumped
            if force or explicit or prev is None:
                items = sorted(snap.items())
            else:
                items = sorted(
                    (k, v) for k, v in snap.items() if prev.get(k) != v
                )
            if not explicit:
                self._last_dumped = dict(snap)
            lines = []
            for name, value in items:
                lines.append(
                    json.dumps(
                        {
                            "ts": now,
                            "seq": self._seq,
                            "name": name,
                            "value": value,
                        }
                    )
                )
                self._seq += 1
        if lines:
            # One O_APPEND write per dump (audited for the chaos
            # drill, docs/robustness.md): the JSON-lines sink is an
            # append log, so tmp+rename doesn't apply — instead the
            # whole batch lands in a single atomic append, and a
            # SIGKILL can at worst tear the final line of the final
            # batch, which any JSON-lines reader skips. Never a
            # half-interleaved record from two processes either.
            payload = ("\n".join(lines) + "\n").encode()
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            try:
                os.write(fd, payload)
            finally:
                os.close(fd)
        return path


registry = MetricsRegistry()


def publish_moe(
    expert_tokens,
    dropped: float,
    total: float,
    capacity_factor: Optional[float] = None,
) -> None:
    """Publish one step's expert-load counters (``moe.*`` — the
    MOE_METRICS legend) from a fetched ``MoEStats``: the step harness
    or serving loop calls this with host floats, so it costs no device
    sync of its own. Counters accumulate (dropped/routed); the
    histogram summaries and capacity decision are gauges."""
    tokens = [float(t) for t in expert_tokens]
    hot = max(tokens, default=0.0)
    kept = float(total) - float(dropped)
    mean = kept / len(tokens) if tokens and kept > 0 else 0.0
    registry.counter("moe.dropped_tokens", float(dropped))
    registry.counter("moe.routed_tokens", float(total))
    registry.gauge("moe.expert_tokens_max", hot)
    registry.gauge("moe.imbalance", hot / mean if mean > 0 else 1.0)
    registry.gauge(
        "moe.drop_rate",
        float(dropped) / float(total) if float(total) > 0 else 0.0,
    )
    if capacity_factor is not None:
        registry.gauge("moe.capacity_factor", float(capacity_factor))


def publish_overlap(
    n_buckets: int,
    bucket_bytes,
    total_bytes: Optional[int] = None,
) -> None:
    """Publish the bucketed-gradient-exchange schedule shape
    (``overlap.*`` gauges — ops/overlap.py). One call per schedule
    build/lookup; values are static host-side ints, so this costs no
    device sync. The exposed/hidden collective-time estimate rides the
    same prefix but is produced by the traced timeline
    (``traced_timeline.collective_overlap_stats``), which owns the
    device spans it is computed from."""
    bucket_bytes = list(bucket_bytes)
    registry.update(
        "overlap",
        {
            "buckets": n_buckets,
            "bucket_bytes_total": (
                total_bytes
                if total_bytes is not None
                else sum(bucket_bytes)
            ),
            "bucket_bytes_max": max(bucket_bytes, default=0),
            "bucket_bytes_min": min(bucket_bytes, default=0),
        },
    )
