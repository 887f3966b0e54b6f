"""Flight-recorder telemetry: the per-step stats hub and the live scrape
endpoint.

The counterpart of ``horovod_tpu/common/telemetry.py``. Three faces, one
hub:

1. **StepStats ring / flight recorder**: ``hvd.step_begin()`` /
   ``hvd.step_end()`` close a per-step record (wall time, the traced
   timeline's exposed and hidden collective time, wire bytes and
   format, fusion dispatches and cycles, tuner decisions) into a bounded
   ring of the last ``HOROVOD_TELEMETRY_STEPS`` (default 256) steps.
   With ``HOROVOD_FLIGHT_RECORDER=/path`` set, ``atexit`` and a chained
   SIGTERM hook dump the ring as JSON lines, so a killed worker leaves
   its last N steps on disk.
2. **Live scrape endpoint**: :class:`MetricsServer`, a stdlib
   ``http.server`` thread (``HOROVOD_METRICS_PORT``; 0 = off) serving
   ``/metrics`` as Prometheus text (the registry snapshot plus the
   ring's step-time p50/p95), ``/telemetry`` as JSON, ``/traces`` (the
   span ring of ``common/tracing.py``) and ``/healthz``.
3. **Cross-rank straggler feed**: :func:`heartbeat_stats` distills the
   ring into the ``{step, step_ms_p50, last_step_ts}`` payload the
   elastic worker puts beside its heartbeat; the driver's
   ``StallInspector.straggler_ranks()`` reads the gang's payloads.

Auto-threading: ``DistributedOptimizer.step()`` calls
:func:`device_step_tick` once an update (a host call: the port's step
runs eagerly) when :func:`auto_enabled` says some consumer exists (a
flight-recorder path, a scraper, or ``HOROVOD_TELEMETRY=1``); with none
the default step pays one function call and nothing else.
"""

from __future__ import annotations

import atexit
import collections
import itertools
import json
import os
import re
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from .logging import TRACE as _TRACE, get_logger
from .metrics import WIRE_FORMAT_NAMES, registry as _metrics

_log = get_logger("telemetry")

DEFAULT_RING_STEPS = 256

# Registry names treated as CUMULATIVE counters: a StepStats record
# carries their step_begin→step_end DELTA (what THIS step did), not the
# running total. Everything else of interest is a gauge read at close.
_COUNTER_KEYS = (
    "fusion.dispatches",
    "fusion.hits",
    "fusion.bucket_hits",
    "fusion.cycles",
    "fusion.flushed_bytes",
    "fusion.bucket_pad_bytes",
    "fusion.wire_bytes_saved",
    # two-level wire: per-hop split of the saved-bytes ledger (inter =
    # the inter-node hop — the scarce one; advanced by hierarchical
    # dispatches only, so a step's inter delta IS its inter-node saving)
    "fusion.wire_bytes_saved_intra",
    "fusion.wire_bytes_saved_inter",
    "fusion.hier_dispatches",
    "fusion.quant_blocks",
    # expert wire (parallel/moe.py + eager alltoall): a step's alltoall deltas attribute its
    # expert-dispatch bytes, and a nonzero dropped-tokens delta marks
    # a capacity overflow on exactly that step
    "alltoall.dispatches",
    "alltoall.wire_bytes",
    "moe.dropped_tokens",
    "moe.routed_tokens",
    # chaos-hardened control plane (common/retry.py, testing/chaos.py):
    # per-step deltas let a postmortem correlate a slow step with the
    # hop that was retrying under it (attempts_total is deliberately
    # absent — the record emits only the fields it carries)
    "retry.retries_total",
    "retry.exhausted_total",
    "faults_injected",
    # training-state integrity plane (common/guard.py, audit.py): a
    # step whose record shows a nonzero guard delta SKIPPED its
    # update; an audit.digests delta marks the digest cadence, so the
    # flight recorder pins integrity events to exact steps
    "guard.nonfinite_steps",
    "audit.digests",
    # collective-schedule audit (analysis/sched_audit.py): a nonzero
    # sched_published delta marks the steps whose records carried a
    # schedule-fingerprint publish
    "audit.sched_published",
    # local-SGD regime (local_sgd.py): local_steps is the
    # host-driver cadence meter, a sync_rounds delta marks the steps
    # that closed a reconciliation round, a rounds_deferred delta pins
    # an inter-node outage to the exact step whose round it pushed
    # out, and inter_bytes is the modeled inter-node ledger of the
    # rounds that DID run
    "local_sgd.local_steps",
    "local_sgd.sync_rounds",
    "local_sgd.rounds_deferred",
    "local_sgd.inter_bytes",
    # serving plane (serving/): a decode-step record's
    # tokens-out delta is its realized batch occupancy, and a nonzero
    # admitted_mid_decode delta pins a TPOT blip to the prefill that
    # caused it
    "serve.tokens_out",
    "serve.admitted_mid_decode",
    # paged memory plane (serving/paged_kv.py): page_allocs deltas mark
    # the steps whose slots crossed page boundaries (allocation IS the
    # write frontier), prefix_hits deltas mark admissions that attached
    # cached prefix pages instead of prefilling them
    "serve.page_allocs",
    "serve.prefix_hits",
    # KV-transfer wire (serving/kv_transfer.py): bytes/pages/ms deltas
    # meter the inter-slice KV stream a disaggregated fleet pays per
    # handed-off request (the int8-vs-fp32 wire trade in byte units),
    # and a transfer_fallbacks delta pins a decode-capacity outage to
    # the step whose request came home to decode locally
    "serve.kv_transfer_bytes",
    "serve.kv_transfer_pages",
    "serve.kv_transfer_ms",
    "serve.transfer_fallbacks",
    # persistent compiled-artifact store (common/exe_cache.py): a step
    # whose record shows a hits/misses delta compiled a graph through
    # the disk tier, and a corrupt delta pins an entry degraded to a
    # cold compile to the step that read it
    "exe_cache.hits",
    "exe_cache.misses",
    "exe_cache.corrupt",
    "exe_cache.rejected",
    "exe_cache.stores",
    "exe_cache.bytes",
    "exe_cache.deserialize_ms",
)

# Gauges copied into the record's ``tuner`` dict — the autotune /
# wire-format / overlap decisions in force when the step closed, so a
# post-mortem can correlate a regression with the knob flip that
# caused it.
_TUNER_PREFIXES = ("autotune.",)
_TUNER_KEYS = (
    "fusion.wire_format",
    "fusion.wire_format_intra",
    "fusion.wire_format_inter",
    "overlap.buckets",
    "moe.capacity_factor",
)


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
    return sorted_vals[idx]


class TelemetryHub:
    """Per-process step-stats ring (the flight recorder).

    Thread-safe; always constructible (no ``hvd.init()`` required) so a
    bare training script — or a test — can drive it directly. One open
    record at a time; records are opened by :meth:`step_begin` (or the
    auto/tick variants) and closed into the ring by :meth:`step_end`.
    """

    def __init__(
        self,
        capacity: Optional[int] = None,
        flight_path: Optional[str] = None,
    ) -> None:
        env = os.environ
        if capacity is None:
            raw = env.get("HOROVOD_TELEMETRY_STEPS", "")
            capacity = int(raw) if raw.strip() else DEFAULT_RING_STEPS
        if flight_path is None:
            flight_path = env.get("HOROVOD_FLIGHT_RECORDER") or None
        self.capacity = max(int(capacity), 1)
        self.flight_path = flight_path
        self.forced = env.get("HOROVOD_TELEMETRY", "").strip().lower() in (
            "1", "true", "yes", "on",
        )
        self._lock = threading.Lock()
        self._ring: "collections.deque" = collections.deque(
            maxlen=self.capacity
        )
        # the one in-flight record: (record dict, base snapshot, t0
        # monotonic, kind) — kind ∈ {"manual", "auto", "tick"}
        self._open = None
        self._ids = itertools.count()
        self._last_step_id = -1
        # ticks (DistributedOptimizer's per-update path) stand down
        # whenever another instrumentation source closed a record since
        # the previous tick — otherwise an eager loop would record every
        # step twice (once per hook).
        self._non_tick_closed = False
        # last step id a tick HANDLED (opened, deduped, or stood down
        # for) — duplicate ticks of one step must be no-ops even after
        # the record they'd duplicate was closed
        self._last_tick_step = None
        # one tick source drives the recorder: when both a caller's
        # own counter (source "tape") and DistributedOptimizer (internal
        # counter, source "opt") tick in one loop, their ids can diverge
        # and would split every step into two fragment records. The
        # tape source outranks the optimizer's (its ids are the
        # caller's real step counter).
        self._tick_source = None
        # attached by basics.init(); both optional
        self.timeline = None
        self.stall_inspector = None
        # run↔flight-recorder correlation: when a harness
        # stamps a run id, every record closed while it is set carries
        # it, so on-chip captures are attributable after the fact
        self.run_id: Optional[str] = None
        # bumped by MetricsServer.start()/stop() — a live scraper turns
        # the auto hooks on even without a flight-recorder path
        self.scrapers = 0
        self._hooks_installed = False
        self._prev_sigterm = None
        if self.flight_path:
            self._install_hooks()

    # ------------------------------------------------------------ config

    def configure(
        self,
        capacity: Optional[int] = None,
        flight_path: Optional[str] = None,
    ) -> None:
        """Re-read knobs at ``hvd.init()`` time (the hub is process-wide
        and may predate init). Shrinking the ring keeps the newest
        records."""
        with self._lock:
            if capacity is not None and int(capacity) != self.capacity:
                self.capacity = max(int(capacity), 1)
                self._ring = collections.deque(
                    self._ring, maxlen=self.capacity
                )
            if flight_path is not None:
                self.flight_path = flight_path or None
        if self.flight_path:
            self._install_hooks()

    @property
    def enabled(self) -> bool:
        """True when some consumer exists (flight recorder, scraper, or
        HOROVOD_TELEMETRY=1) — gates the implicit per-step hooks."""
        return bool(self.flight_path or self.scrapers or self.forced)

    # -------------------------------------------------------- step faces

    def step_begin(self, step: Optional[int] = None) -> int:
        """Open a step record; returns its step id. An already-open
        record (any kind) is closed first — a forgiving contract, so a
        loop that misses one ``step_end`` degrades to tick semantics
        instead of wedging."""
        return self._begin(step, kind="manual")

    def step_end(self) -> Optional[dict]:
        """Close the open record into the ring; returns the record (or
        None when no step is open)."""
        return self._end(kinds=("manual", "auto", "tick"))

    def tick(self, step: Optional[int] = None, source: str = "opt") -> None:
        """One step boundary (``DistributedOptimizer.step()``'s
        per-update call, source "opt", or a caller's own counter, source
        "tape"). A tick closes the previous tick-opened record and
        opens the next; it stands down entirely while manual/auto
        records are flowing, dedupes duplicates by step id,
        and only ONE source drives the recorder ("tape" outranks "opt",
        adopted on first sight)."""
        sid = None if step is None else int(step)
        with self._lock:
            if self._tick_source is None or (
                source == "tape" and self._tick_source == "opt"
            ):
                self._tick_source = source
            if source != self._tick_source:
                return
            open_rec = self._open
            open_kind = open_rec[3] if open_rec is not None else None
            if sid is not None and sid == self._last_tick_step:
                # duplicate tick for an already-HANDLED step (the dups
                # may arrive after the record closed): one tick wins
                return
            if sid is not None:
                self._last_tick_step = sid
            if open_kind in ("manual", "auto"):
                return
            stand_down = self._non_tick_closed and open_kind is None
            self._non_tick_closed = False
        if stand_down:
            return
        if open_kind == "tick":
            self._end(kinds=("tick",))
        self._begin(sid, kind="tick")

    # ----------------------------------------------------- record plumbing

    def _begin(self, step: Optional[int], kind: str) -> int:
        snap = _metrics.snapshot()
        now = time.time()
        t0 = time.monotonic()
        closed = None
        with self._lock:
            if self._open is not None:
                closed = self._close_locked(time.monotonic(), time.time())
            if step is None:
                step_id = next(self._ids)
                # explicit ids may have advanced past the internal
                # counter; keep auto ids monotonic with them
                if step_id <= self._last_step_id:
                    step_id = self._last_step_id + 1
                    self._ids = itertools.count(step_id + 1)
            else:
                step_id = int(step)
                self._ids = itertools.count(step_id + 1)
            self._open = ({"step": step_id, "ts": now}, snap, t0, kind)
        if closed is not None:
            self._publish(closed)
        return step_id

    def _end(self, kinds) -> Optional[dict]:
        with self._lock:
            if self._open is None or self._open[3] not in kinds:
                return None
            rec = self._close_locked(time.monotonic(), time.time())
        self._publish(rec)
        return rec

    def _close_locked(self, t1: float, now: float) -> dict:
        rec, base, t0, kind = self._open
        self._open = None
        if kind != "tick":
            self._non_tick_closed = True
        snap = _metrics.snapshot()
        deltas = {
            k: snap.get(k, 0.0) - base.get(k, 0.0) for k in _COUNTER_KEYS
        }
        # wire footprint this step: payload + bucket padding − quantized
        # savings (the fusion manager's byte model, per-step delta)
        wire = (
            deltas["fusion.flushed_bytes"]
            + deltas["fusion.bucket_pad_bytes"]
            - deltas["fusion.wire_bytes_saved"]
        )
        tuner = {
            k: v
            for k, v in snap.items()
            if k in _TUNER_KEYS or k.startswith(_TUNER_PREFIXES)
        }
        rec.update(
            {
                "wall_ms": round((t1 - t0) * 1e3, 3),
                # exposed/hidden collective device time: the traced
                # timeline's overlap ledger
                # (traced_timeline.collective_overlap_stats) — the
                # LATEST session's values, since the profiler measures
                # windows, not single steps
                "collective_ms": snap.get("overlap.collective_ms", 0.0),
                "exposed_collective_ms": snap.get(
                    "overlap.exposed_collective_ms", 0.0
                ),
                "hidden_collective_ms": snap.get(
                    "overlap.hidden_collective_ms", 0.0
                ),
                "wire_bytes": max(wire, 0.0),
                "wire_bytes_saved": deltas["fusion.wire_bytes_saved"],
                # two-level wire: the per-hop split (inter = the
                # scarce hop). Advanced only by hierarchical dispatches,
                # so a step's inter delta IS its inter-node saving
                "wire_bytes_saved_intra": deltas[
                    "fusion.wire_bytes_saved_intra"
                ],
                "wire_bytes_saved_inter": deltas[
                    "fusion.wire_bytes_saved_inter"
                ],
                "hier_dispatches": deltas["fusion.hier_dispatches"],
                "wire_format": WIRE_FORMAT_NAMES.get(
                    int(snap.get("fusion.wire_format", 0)), "fp32"
                ),
                "fusion_dispatches": deltas["fusion.dispatches"],
                "fusion_cache_hits": deltas["fusion.hits"]
                + deltas["fusion.bucket_hits"],
                "fusion_cycles": deltas["fusion.cycles"],
                # expert wire: eager alltoall dispatch/byte
                # deltas — expert-dispatch traffic attributed to THIS
                # step — plus the MoE capacity-gate counters the step
                # harness published (0s without MoE traffic)
                "alltoall.dispatches": deltas["alltoall.dispatches"],
                "alltoall.wire_bytes": deltas["alltoall.wire_bytes"],
                "moe.dropped_tokens": deltas["moe.dropped_tokens"],
                "moe.routed_tokens": deltas["moe.routed_tokens"],
                # control-plane weather during THIS step: retries the
                # transports absorbed, rounds that exhausted, and any
                # chaos-layer faults injected (0s on a healthy step)
                "retries": deltas["retry.retries_total"],
                "retry_exhausted": deltas["retry.exhausted_total"],
                "faults_injected": deltas["faults_injected"],
                # integrity plane: a nonzero guard delta means
                # THIS step's update was skipped for non-finite
                # gradients; audit_ran marks the digest cadence
                # landing on this step, and audit.last_digest_step is
                # the GAUGE (the newest digest's step id), not a delta
                "guard.nonfinite_steps": deltas["guard.nonfinite_steps"],
                "audit_ran": 1.0 if deltas["audit.digests"] else 0.0,
                "audit.last_digest_step": snap.get(
                    "audit.last_digest_step", 0.0
                ),
                # local-SGD regime (local_sgd.py): a
                # sync_rounds delta marks the step that closed a
                # reconciliation round, rounds_deferred pins a inter-node
                # outage to the step whose round it pushed out, and
                # inter_bytes is the modeled inter-node cost of the rounds
                # that ran (all 0 outside the mode)
                "local_sgd.local_steps": deltas["local_sgd.local_steps"],
                "local_sgd.sync_rounds": deltas["local_sgd.sync_rounds"],
                "local_sgd.rounds_deferred": deltas[
                    "local_sgd.rounds_deferred"
                ],
                "local_sgd.inter_bytes": deltas["local_sgd.inter_bytes"],
                # serving plane: tokens this record emitted and the
                # mid-decode admissions that landed inside it (both 0
                # on training steps)
                "serve.tokens_out": deltas["serve.tokens_out"],
                "serve.admitted_mid_decode": deltas[
                    "serve.admitted_mid_decode"
                ],
                "serve.page_allocs": deltas["serve.page_allocs"],
                "serve.prefix_hits": deltas["serve.prefix_hits"],
                "tuner": tuner,
            }
        )
        if self.run_id:
            rec["run_id"] = self.run_id
        self._last_step_id = max(self._last_step_id, rec["step"])
        self._ring.append(rec)
        return rec

    def _publish(self, rec: dict) -> None:
        """Per-step gauges into the registry + the trace counter track,
        and the stall check every traced/eager step goes through."""
        pct = self.percentiles()
        _metrics.update(
            "telemetry",
            {
                "step": rec["step"],
                "step_ms": rec["wall_ms"],
                "step_ms_p50": pct.get("p50", 0.0),
                "step_ms_p95": pct.get("p95", 0.0),
                "steps_recorded": pct.get("count", 0),
            },
        )
        tl = self.timeline
        if tl is not None:
            # aligns traces with StepStats records: the same step id on
            # a counter track next to the per-tensor lifecycle rows
            tl.counter("telemetry.step", rec["step"])
        insp = self.stall_inspector
        if insp is not None:
            # steady-state stall coverage for traced jobs that never
            # run an eager fusion cycle; may raise the shutdown
            # escalation, which is the point
            insp.check()

    # ----------------------------------------------------------- read side

    def records(self) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._ring]

    def _snapshot_records(self, timeout: float = 1.0) -> List[dict]:
        """Ring copy that NEVER deadlocks: the SIGTERM/preemption dump
        runs in a signal handler ON the main thread, and if the signal
        landed while that same thread held ``_lock`` inside
        step_begin/step_end, a blocking acquire would hang the handler
        forever (threading.Lock is not reentrant) — the grace window
        and the checkpoint behind it would be lost. Bounded acquire,
        then a lock-free best-effort copy: in the contended case the
        holder is the interrupted (frozen) frame, so the ring is
        quiescent; a racing mutation from another thread at worst
        raises mid-iteration, which we retry and then accept losing."""
        acquired = self._lock.acquire(timeout=timeout)
        try:
            for _ in range(3):
                try:
                    return [dict(r) for r in list(self._ring)]
                except RuntimeError:  # deque mutated during iteration
                    continue
            return []
        finally:
            if acquired:
                self._lock.release()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def percentiles(self) -> Dict[str, float]:
        """step-time p50/p95 (+count/sum) over the ring; {} when empty."""
        with self._lock:
            walls = sorted(r["wall_ms"] for r in self._ring)
        if not walls:
            return {}
        return {
            "p50": _percentile(walls, 0.50),
            "p95": _percentile(walls, 0.95),
            "count": len(walls),
            "sum": sum(walls),
        }

    def heartbeat_stats(self) -> Dict[str, float]:
        """The straggler-ledger payload piggybacked onto the rendezvous
        heartbeat: this worker's last closed step id, its ring p50, and
        when that step closed (epoch seconds). {} before the first
        step."""
        with self._lock:
            last = self._ring[-1] if self._ring else None
        if last is None:
            return {}
        pct = self.percentiles()
        out = {
            "step": last["step"],
            "step_ms_p50": pct.get("p50", 0.0),
            "last_step_ts": last["ts"] + last["wall_ms"] / 1e3,
        }
        # local-SGD deferral ledger piggybacks the heartbeat: the
        # driver's gang view shows which workers' inter-node rounds are being
        # pushed out (degraded inter axis) while every beat stays fresh
        deferred = _metrics.snapshot().get("local_sgd.rounds_deferred")
        if deferred:
            out["local_sgd_rounds_deferred"] = float(deferred)
        return out

    # -------------------------------------------------- flight recorder

    def dump(self, path: Optional[str] = None) -> Optional[str]:
        """Write the ring as JSON-lines (one record per line, oldest
        first) to ``path`` / the configured flight-recorder path.
        Whole-file replace via tmp+rename: a dump interrupted by the
        next signal can't leave a torn file."""
        path = path or self.flight_path
        if not path:
            return None
        # signal-safe snapshot: dump() is reached from SIGTERM handlers
        # (ours and preemption.GracefulShutdown's) — see _snapshot_records
        records = self._snapshot_records()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
        os.replace(tmp, path)
        self._dump_spans(path)
        return path

    def _dump_spans(self, path: str) -> None:
        """Drain the trace-plane span ring beside the StepStats dump —
        ``<flight_recorder>.spans`` — on the same atexit/SIGTERM hooks,
        so a killed worker's spans survive for trace_assemble. Never
        lets a tracing bug spoil the step-record dump."""
        try:
            from . import tracing

            rec = tracing._recorder  # don't construct one just to drain it
            if rec is not None and len(rec):
                rec.dump(path + ".spans")
        except Exception:
            _log.debug("span-ring dump failed", exc_info=True)

    def set_run_id(self, run_id: Optional[str]) -> None:
        """Stamp (or clear) the run id carried by every record
        closed from now on."""
        self.run_id = run_id or None

    def _install_hooks(self) -> None:
        """atexit + chained SIGTERM dump — the 'killed worker leaves its
        last N steps on disk' guarantee. SIGTERM keeps its fatal
        semantics: after dumping, the previous handler runs, or the
        process exits 143 when the previous disposition was default
        (preemption.GracefulShutdown installed LATER chains us and owns
        the exit instead)."""
        with self._lock:
            if self._hooks_installed:
                return
            self._hooks_installed = True
        atexit.register(self._atexit_dump)
        try:
            if threading.current_thread() is threading.main_thread():
                self._prev_sigterm = signal.signal(
                    signal.SIGTERM, self._on_sigterm
                )
        except ValueError:
            pass  # non-main-thread import: atexit still covers us

    def _atexit_dump(self) -> None:
        try:
            if len(self):
                self.dump()
            elif self.flight_path:
                # no step records, but the span ring may still hold a
                # trace worth keeping (e.g. a pure-routing worker)
                self._dump_spans(self.flight_path)
        except Exception:
            _log.debug("flight-recorder atexit dump failed", exc_info=True)

    def _on_sigterm(self, signum, frame) -> None:
        try:
            self.dump()
        except Exception:
            pass
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
            return
        if prev is signal.SIG_IGN:
            return
        # default disposition: die like a SIGTERM'd process (128+15);
        # os._exit because the signal may have landed mid-collective
        # and interpreter teardown over wedged device state can hang
        os._exit(143)


# ---------------------------------------------------------------- singleton

_hub: Optional[TelemetryHub] = None
_hub_lock = threading.Lock()


def hub() -> TelemetryHub:
    """The process-wide hub (created lazily from env)."""
    global _hub
    with _hub_lock:
        if _hub is None:
            _hub = TelemetryHub()
        return _hub


def _reset_hub() -> None:
    """Test hook: drop the singleton so the next hub() re-reads env.
    Installed signal/atexit hooks of the old hub stay installed (they
    are idempotent dumps of a now-empty ring)."""
    global _hub
    with _hub_lock:
        _hub = None


def auto_enabled() -> bool:
    """Gate for the implicit hooks (the optimizer's tick):
    cheap, and False unless someone is actually consuming telemetry."""
    h = _hub
    if h is None:
        # don't force-create the hub on the hot path; construct only if
        # env says telemetry is on at all
        env = os.environ
        if not (
            env.get("HOROVOD_FLIGHT_RECORDER")
            or env.get("HOROVOD_TELEMETRY", "").strip().lower()
            in ("1", "true", "yes", "on")
        ):
            return False
        h = hub()
    return h.enabled


def step_begin(step: Optional[int] = None) -> int:
    """``hvd.step_begin()`` — open a per-step flight-recorder record."""
    return hub().step_begin(step)


def step_end() -> Optional[dict]:
    """``hvd.step_end()`` — close the record into the ring, and close the
    step for ``HOROVOD_AUTOTUNE``'s parameter manager
    (``FusionManager.end_step``), so that an eager loop tunes too."""
    rec = hub().step_end()
    from . import basics

    if basics.is_initialized():
        basics.state().fusion.end_step(source="step_end")
    return rec


def device_step_tick(step, source: str = "opt") -> None:
    """One step boundary per optimizer update (``DistributedOptimizer.
    step()`` calls it). Telemetry bugs must never kill a training step,
    EXCEPT the stall inspector's shutdown escalation, which exists to
    kill a wedged job and rides the per-step check inside the record
    close."""
    from .basics import HorovodInternalError

    try:
        hub().tick(int(step), source=source)
    except HorovodInternalError:
        raise
    except Exception:
        _log.debug("telemetry tick failed", exc_info=True)


def set_run_id(run_id: Optional[str]) -> None:
    """Module-level convenience for harnesses: stamp every
    flight-recorder record closed from now on with ``run_id``."""
    hub().set_run_id(run_id)


def heartbeat_stats() -> Dict[str, float]:
    """Module-level convenience for the elastic worker's heartbeat."""
    h = _hub
    return h.heartbeat_stats() if h is not None else hub().heartbeat_stats()


# ------------------------------------------------------- prometheus render

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _prom_name(name: str) -> str:
    out = _PROM_BAD.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return "hvd_" + out


def _prom_value(v: float) -> Optional[str]:
    v = float(v)
    if v != v or v in (float("inf"), float("-inf")):
        return None  # exposition must not carry NaN/Inf from gauges
    return f"{v:.10g}"


def render_prometheus(
    snapshot: Dict[str, float],
    percentiles: Optional[Dict[str, float]] = None,
) -> str:
    """Prometheus text exposition v0.0.4: the step-time summary first,
    then every registry metric as a ``hvd_``-prefixed gauge with
    HELP/TYPE lines. Pure function so tests can feed it directly."""
    percentiles = percentiles or {}
    lines = [
        "# HELP telemetry_step_ms Per-step wall time over the "
        "flight-recorder ring (HOROVOD_TELEMETRY_STEPS newest steps).",
        "# TYPE telemetry_step_ms summary",
    ]
    def _v(x) -> str:
        return _prom_value(x) or "0"

    if percentiles:
        lines.append(
            'telemetry_step_ms{quantile="0.5"} ' + _v(percentiles["p50"])
        )
        lines.append(
            'telemetry_step_ms{quantile="0.95"} ' + _v(percentiles["p95"])
        )
    lines.append("telemetry_step_ms_sum " + _v(percentiles.get("sum", 0.0)))
    lines.append(
        "telemetry_step_ms_count " + _v(percentiles.get("count", 0))
    )
    seen = set()
    for name in sorted(snapshot):
        prom = _prom_name(name)
        if prom in seen:  # two dotted names collapsing onto one
            continue
        val = _prom_value(snapshot[name])
        if val is None:
            continue
        seen.add(prom)
        lines.append(f"# HELP {prom} horovod_tpu_torch metric {name!r}")
        lines.append(f"# TYPE {prom} gauge")
        lines.append(f"{prom} {val}")
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------ scrape server


class MetricsServer:
    """Per-worker live scrape endpoint on a stdlib http.server thread.

    Routes: ``/metrics`` (Prometheus text), ``/telemetry`` (JSON ring +
    registry snapshot), ``/traces`` (trace-plane span ring +
    worker identity + clock stamps), ``/healthz``. Read-only and unauthenticated by
    design — it exposes numbers, not control; bind it to an interface
    your scraper can reach (default all interfaces, matching the
    rendezvous server)."""

    def __init__(
        self,
        port: int = 0,
        addr: str = "0.0.0.0",
        hub_instance: Optional[TelemetryHub] = None,
    ) -> None:
        self._hub = hub_instance
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                _log.log(_TRACE, "http " + fmt, *args)

            def _reply(self, code, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                h = outer.hub
                path = self.path.split("?", 1)[0]
                if path == "/traces":
                    # span ring + this worker's identity + recv/send
                    # wall stamps: the scrape itself is an NTP edge the
                    # assembler can estimate this host's offset from
                    recv_ts = time.time()
                    from . import tracing

                    rec = tracing.recorder()
                    body = json.dumps(
                        {
                            "spans": rec.spans(),
                            "capacity": rec.capacity,
                            "host": rec.host,
                            "pid": rec.pid,
                            "role": rec.role,
                            "recv_ts": recv_ts,
                            "send_ts": time.time(),
                        }
                    ).encode()
                    return self._reply(200, body, "application/json")
                if path == "/metrics":
                    body = render_prometheus(
                        _metrics.snapshot(), h.percentiles()
                    ).encode()
                    return self._reply(200, body, PROM_CONTENT_TYPE)
                if path == "/telemetry":
                    body = json.dumps(
                        {
                            "steps": h.records(),
                            "percentiles": h.percentiles(),
                            "metrics": _metrics.snapshot(),
                            "ring_capacity": h.capacity,
                        }
                    ).encode()
                    return self._reply(200, body, "application/json")
                if path == "/healthz":
                    return self._reply(
                        200, b"ok\n", "text/plain; charset=utf-8"
                    )
                return self._reply(
                    404, b"not found\n", "text/plain; charset=utf-8"
                )

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._httpd = _Server((addr, port), _Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def hub(self) -> TelemetryHub:
        return self._hub if self._hub is not None else hub()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> int:
        if self._thread is not None:
            return self.port
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="hvd-telemetry-scrape",
            daemon=True,
        )
        self._thread.start()
        self.hub.scrapers += 1
        _log.info("telemetry /metrics endpoint on port %d", self.port)
        return self.port

    def stop(self) -> None:
        if self._thread is None:
            self._httpd.server_close()
            return
        self.hub.scrapers = max(self.hub.scrapers - 1, 0)
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        self._thread = None
