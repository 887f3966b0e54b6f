"""HTTP frontend and fleet routing: ``serve(model, params, port=…)``.

A stdlib ``ThreadingHTTPServer`` per worker, no dependencies. Routes:

* ``POST /generate``: body ``{"tokens": [...], "max_tokens"?,
  "deadline_ms"?, "temperature"?, "top_k"?, "seed"?, "request_id"?}``.
  The handler thread parks on the request until the batcher's thread has
  finished it, then replies the result JSON (tokens, status, TTFT,
  generation wall). 400 on a malformed body, 429 when the request can
  never fit, 503 while draining, 500 when the scheduler failed under it.
  A ``request_id`` this worker already answered gets the cached result
  (``serve.replay_dedupe_hits``), even mid-drain: a retry never
  recomputes. Request tracing (``common/tracing.py``): the handler adopts
  a ``traceparent`` header, or mints a root when ``HOROVOD_TRACE`` is
  on, opens the ``http.generate`` span and hands its context to the
  batcher; a traced reply carries ``X-Trace-Id``, the receive/send
  stamps and ``trace_id`` in its JSON.
* ``GET /healthz``: liveness and capacity (free slots and pages, queue
  depth).
* ``GET /metrics``: the TTFT/TPOT Prometheus summaries, then the flight
  recorder's step-time summary and the registry rendered as gauges.
* ``GET /traces``: the span ring, with this worker's identity and the
  scrape's receive/send stamps.
* ``GET /stats``: engine and batcher counters as JSON.

The HTTP threads never touch tensors: they queue requests and read host
counters. ``serve()`` registers the frontend's drain with
``preemption.register_drain``, so SIGTERM finishes every accepted
request before the worker exits. With ``HOROVOD_SERVE_DRAIN_DEADLINE_S``
set (or ``drain(migrate_after=)``), sequences still decoding past the
deadline are live-migrated to a peer over the ``migrate`` frame of
``serving/kv_transfer.py`` and finish there; one that cannot go
anywhere decodes here (``serve.transfer_fallbacks``).

A sharded engine (``serve(mesh=)``, one process per rank): on the
engine's leader ``serve()`` starts the batcher and the frontend as
above (no KV transfer server: its pages hold one rank's heads, and a
deadline drain finishes its sequences here); on a follower it opens no
port and runs the engine's ``follow()`` on a thread bound to the
device, returning a :class:`FollowerHandle`. The leader's ``stop()``
and drain send the followers "stop" after the last request.

A fleet meets in the rendezvous KV: each worker announces its capacity
(:meth:`ServeFrontend.capacity`: role, free slots and pages, the
transfer port) under scope ``serve`` every second
(``runner.rendezvous.put_announcement``), and a prefill worker's
:class:`~.kv_transfer.TransferCoordinator` reads the decode workers'
announcements. ``serve(role="prefill")`` wires that coordinator;
``serve(role="decode")`` (and a paged unified worker) runs a
:class:`~.kv_transfer.KVTransferServer`.

:class:`Router` sends each request to the least-loaded live worker
whose rank the heartbeat straggler ledger does not flag: prefill
workers when any exist, unified ones otherwise, never a decode worker;
page headroom and slot headroom folded into one unit, and blobs without
page fields (or a ``role``) still routable. Freshness is judged on the
router's own monotonic clock; the driver's dead-host set (scope
``serve`` key ``dead_hosts``) evicts at once. The routed payload is the
journal: a worker that goes dark mid-call gets the request replayed on
another (``serve.replays``) and its announcement tombstoned for one
freshness period. ``HOROVOD_SERVE_HEDGE_MS`` fires a backup request on
a second worker after the delay, first writer wins (``serve.hedges``).
"""

from __future__ import annotations

import json
import socket
import threading
import time
import uuid
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from ..common import telemetry as _telemetry
from ..common import tracing as _tracing
from ..common.config import live_config
from ..common.logging import TRACE as _TRACE, get_logger
from ..common.metrics import registry as _metrics
from ..common.telemetry import PROM_CONTENT_TYPE, render_prometheus
from ..runner.rendezvous import (  # noqa: F401
    SERVE_SCOPE,
    put_announcement,
    read_announcements,
    worker_role,
)
from .batcher import ContinuousBatcher, Rejected

_log = get_logger("serve.frontend")

DEFAULT_ANNOUNCE_INTERVAL_S = 1.0
# announcements older than this are a dead or partitioned worker as far
# as routing is concerned
DEFAULT_ANNOUNCE_TTL_S = 10.0
# the completed-result dedupe cache's bound in entries: the TTL prunes
# first, this caps memory under a flood of unique request ids
DEDUPE_MAX_ENTRIES = 1024


class ServeFrontend:
    def __init__(
        self,
        batcher: ContinuousBatcher,
        port: int = 0,
        addr: str = "0.0.0.0",
        advertise_addr: str = "127.0.0.1",
        rank: Optional[int] = None,
        announce_client=None,
        announce_interval_s: float = DEFAULT_ANNOUNCE_INTERVAL_S,
        transfer_server=None,
    ) -> None:
        self.batcher = batcher
        # the KVTransferServer of a decode (or paged unified) worker: its
        # port travels in the capacity blob, its reservations debit the
        # announced headroom
        self.transfer_server = transfer_server
        self._announce_client = announce_client
        self._announce_interval = float(announce_interval_s)
        self._announce_stop = threading.Event()
        self._announce_thread: Optional[threading.Thread] = None
        self.advertise_addr = advertise_addr
        if rank is None:
            rank = live_config().rank
        self.rank = int(rank or 0)
        self._draining = False
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._status_lock = threading.Lock()
        self._status_counts = {2: 0, 4: 0, 5: 0}
        # completed results by client request_id: (result, expiry on the
        # monotonic clock); a replay or a retry of work done here gets
        # the cached answer instead of a second generation
        self._dedupe: "OrderedDict[str, tuple]" = OrderedDict()
        self._dedupe_lock = threading.Lock()
        # the live-migration coordinator of a deadline drain, built at
        # the first one (a prefill worker reuses its batcher's)
        self._migrator = None
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                _log.log(_TRACE, "http " + fmt, *args)

            def _reply(self, code, body: bytes, ctype: str,
                       headers=None) -> None:
                if getattr(self, "_count_status", False):
                    outer._note_status(code)
                self._last_code = code
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code, obj, headers=None) -> None:
                self._reply(code, json.dumps(obj).encode(),
                            "application/json", headers)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/healthz":
                    return self._json(200, outer.capacity())
                if path == "/stats":
                    stats = dict(outer.batcher.stats())
                    stats.update(outer.batcher.engine.stats())
                    stats["slo"] = outer.batcher.recorder.summaries()
                    return self._json(200, stats)
                if path == "/metrics":
                    body = "\n".join(
                        outer.batcher.recorder.render_prometheus_summaries()
                    ) + "\n" + render_prometheus(
                        _metrics.snapshot(), _telemetry.hub().percentiles())
                    return self._reply(200, body.encode(), PROM_CONTENT_TYPE)
                if path == "/traces":
                    recv_ts = time.time()
                    rec = _tracing.recorder()
                    return self._json(200, {
                        "spans": rec.spans(), "capacity": rec.capacity,
                        "host": rec.host, "pid": rec.pid, "role": rec.role,
                        "recv_ts": recv_ts, "send_ts": time.time(),
                    })
                return self._reply(
                    404, b"not found\n", "text/plain; charset=utf-8"
                )

            def do_POST(self):
                # read the body first: a keep-alive connection with body
                # bytes left on it would desynchronise its next request
                recv_ts = time.time()
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length) if length else b""
                path = self.path.split("?", 1)[0]
                if path != "/generate":
                    return self._reply(
                        404, b"not found\n", "text/plain; charset=utf-8"
                    )
                self._count_status = True
                # adopt the caller's traceparent, or mint a root when
                # tracing is on; None (the default) costs nothing after
                tctx = _tracing.adopt(
                    self.headers.get(_tracing.TRACEPARENT_HEADER))
                span = _tracing.start_span("http.generate", tctx)
                hdrs = None
                if tctx is not None:
                    hdrs = _tracing.server_stamps(recv_ts)
                    hdrs[_tracing.TRACE_ID_HEADER] = tctx.trace_id
                try:
                    return self._generate(body, span, hdrs)
                finally:
                    self._count_status = False
                    if span is not None:
                        span.end(code=getattr(self, "_last_code", 0))

            def _generate(self, body, span=None, hdrs=None):
                trace = span.ctx if span is not None else None
                try:
                    payload = json.loads(body or b"{}")
                    if not isinstance(payload, dict):
                        raise ValueError(
                            f"body must be a JSON object, got "
                            f"{type(payload).__name__}"
                        )
                    tokens = payload["tokens"]
                except (json.JSONDecodeError, KeyError, ValueError) as e:
                    return self._json(400, {"error": f"bad request: {e}"},
                                      hdrs)
                request_id = str(payload.get("request_id") or "")
                if span is not None and request_id:
                    span.tag(request_id=request_id)
                if request_id:
                    # before the draining gate: a retry of work this
                    # worker finished gets its answer even mid-drain
                    hit = outer._dedupe_get(request_id)
                    if hit is not None:
                        _metrics.counter("serve.replay_dedupe_hits")
                        if span is not None:
                            span.tag(outcome="dedupe_hit")
                        return self._json(200, hit, hdrs)
                if outer.draining:
                    return self._json(503, {"error": "draining",
                                            "retry": True}, hdrs)
                with outer._inflight_lock:
                    outer._inflight += 1
                try:
                    try:
                        req = outer.batcher.submit(
                            tokens,
                            max_new_tokens=payload.get("max_tokens"),
                            deadline_ms=payload.get("deadline_ms"),
                            temperature=float(
                                payload.get("temperature", 0.0)
                            ),
                            top_k=int(payload.get("top_k", 0)),
                            seed=payload.get("seed"),
                            trace=trace,
                        )
                    except Rejected as e:
                        # draining is the worker's state (503); 429 is
                        # for requests that can never fit
                        code = 503 if outer.draining else 429
                        return self._json(code, {"error": str(e)}, hdrs)
                    except (TypeError, ValueError) as e:
                        return self._json(
                            400, {"error": f"bad request: {e}"}, hdrs
                        )
                    req.wait()
                    code = 500 if req.status == "error" else 200
                    result = req.result()
                    if span is not None:
                        span.tag(outcome=req.status)
                    if request_id and code == 200:
                        outer._dedupe_put(request_id, result)
                    return self._json(code, result, hdrs)
                finally:
                    with outer._inflight_lock:
                        outer._inflight -= 1

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._httpd = _Server((addr, port), _Handler)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def draining(self) -> bool:
        """A planned drain or the batcher's crash-drain: either way no
        new requests."""
        return self._draining or self.batcher.draining

    def capacity(self) -> dict:
        manager = self.batcher.engine.manager
        mgr = manager.stats()
        draining = self.draining
        cap = {
            "ok": not draining,
            "rank": self.rank,
            "addr": self.advertise_addr,
            "port": self.port,
            "role": getattr(self.batcher, "role", "unified"),
            "free_slots": mgr["slots_free"],
            "slots_total": mgr["slots_total"],
            "queue_depth": self.batcher.queue_depth(),
            "draining": draining,
            "host": socket.gethostname(),
            "ts": time.time(),
        }
        if self.transfer_server is not None:
            cap["transfer_port"] = self.transfer_server.port
        if "pages_total" in mgr:
            # page headroom is what admission gates on; a saturated pool
            # reads as no free slots, and no free slot as no free pages
            free_pages = manager.admission_headroom()
            if self.transfer_server is not None:
                # pages promised to transfers in flight are spoken for
                free_pages = max(
                    free_pages - self.transfer_server.reserved_pages(), 0)
            cap["free_pages"] = free_pages
            cap["pages_total"] = mgr["pages_total"]
            cap["prefix_hit_rate"] = round(mgr["prefix_hit_rate"], 4)
            if free_pages <= 0:
                cap["free_slots"] = 0
            if cap["free_slots"] <= 0:
                cap["free_pages"] = 0
        return cap

    def start(self) -> int:
        if self._thread is not None:
            return self.port
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="hvd-serve-frontend",
            daemon=True,
        )
        self._thread.start()
        client = self._resolve_announce_client()
        if client is not None:
            self._announce_client = client
            self._announce_stop.clear()
            self._announce_thread = threading.Thread(
                target=self._announce_loop, name="hvd-serve-announce",
                daemon=True,
            )
            self._announce_thread.start()
        _log.info("serve frontend on port %d (rank %d)", self.port, self.rank)
        return self.port

    def _resolve_announce_client(self):
        """The client given, else the launcher's rendezvous KV
        (``HOROVOD_GLOO_RENDEZVOUS_ADDR/PORT``), else None (no fleet)."""
        if self._announce_client is not None:
            return self._announce_client
        from ..common.config import TrainConfig

        cfg = TrainConfig.from_env()
        if not cfg.rendezvous_addr or not cfg.rendezvous_port:
            return None
        from ..runner.rendezvous import _client_from_cfg

        return _client_from_cfg(cfg)

    def _announce_loop(self) -> None:
        while not self._announce_stop.is_set():
            self.announce()
            self._announce_stop.wait(self._announce_interval)

    def announce(self) -> None:
        """One capacity PUT into the rendezvous KV (scope ``serve``)."""
        if self._announce_client is None:
            return
        try:
            put_announcement(self._announce_client, self.rank,
                             self.capacity())
        except (OSError, RuntimeError) as e:
            _log.debug("serve announce failed: %s", e)

    def drain(self, timeout: float = 30.0,
              migrate_after: Optional[float] = None) -> bool:
        """Refuse new work, finish the accepted work, let the in-flight
        responses flush; announce the drained state before and after.

        ``migrate_after`` (seconds; None reads
        ``HOROVOD_SERVE_DRAIN_DEADLINE_S``, where 0 is off) bounds how
        long in-flight sequences keep decoding here on the paged plane:
        past it they are live-migrated to a reserved peer
        (:meth:`_migrate_inflight`) and finish there."""
        self._draining = True
        self.announce()  # the router-side view: draining, no capacity
        if migrate_after is None:
            deadline_s = live_config().serve_drain_deadline_s
            migrate_after = deadline_s if deadline_s > 0 else None
        engine = self.batcher.engine
        if (migrate_after is not None and engine.paged
                and not engine.sharded):
            ok = self.batcher.drain(
                timeout=timeout, migrate_after=float(migrate_after),
                on_deadline=self._migrate_inflight,
            )
        else:
            ok = self.batcher.drain(timeout=timeout)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with self._inflight_lock:
                if self._inflight == 0:
                    break
            time.sleep(0.01)
        self.announce()
        return ok

    def _resolve_migrator(self):
        """The TransferCoordinator a deadline drain streams through: a
        prefill worker's own, else one built on the same announcements."""
        if self.batcher.transfer is not None:
            return self.batcher.transfer
        if self._migrator is None:
            from .kv_transfer import TransferCoordinator

            self._migrator = TransferCoordinator(
                self.batcher.engine,
                client_factory=self._resolve_announce_client,
            )
        return self._migrator

    def _migrate_inflight(self, records) -> None:
        """``batcher.drain``'s deadline hook: each exported record goes
        to a reserved peer; one that cannot (no coordinator, or its
        reservation or gather failed) comes home for a local decode,
        which the drain steps. A failure to pack the pages is the
        migrate thread's, and ends that request ``error``."""
        try:
            coord = self._resolve_migrator()
        except Exception as e:  # noqa: BLE001 - decode locally instead
            _log.warning("no migration coordinator (%s); draining %d "
                         "sequence(s) locally", e, len(records))
            coord = None
        for rec in records:
            if coord is None:
                self.batcher.requeue_fallback(rec["req"], rec["kept"],
                                              rec["length"])
                continue
            try:
                coord.migrate(self.batcher, rec)
            except Exception as e:  # noqa: BLE001 - this record only
                _log.warning("migration of request %d failed at export "
                             "(%s); falling back to local decode",
                             rec["req"].id, e)
                self.batcher.requeue_fallback(rec["req"], rec["kept"],
                                              rec["length"])

    def _note_status(self, code: int) -> None:
        """``serve.http_2xx/4xx/5xx`` counters and the
        ``serve.http_error_rate`` gauge over /generate replies."""
        klass = int(code) // 100
        if klass not in (2, 4, 5):
            klass = 5 if klass > 5 else 4
        with self._status_lock:
            self._status_counts[klass] += 1
            counts = dict(self._status_counts)
        _metrics.counter(f"serve.http_{klass}xx")
        _metrics.gauge(
            "serve.http_error_rate",
            (counts[4] + counts[5]) / sum(counts.values()),
        )

    # ----------------------------------------------------- the dedupe cache

    def _dedupe_get(self, request_id: str) -> Optional[dict]:
        with self._dedupe_lock:
            hit = self._dedupe.get(request_id)
            if hit is None:
                return None
            result, expiry = hit
            if time.monotonic() >= expiry:
                del self._dedupe[request_id]
                return None
            return result

    def _dedupe_put(self, request_id: str, result: dict) -> None:
        """Keep a completed result for ``HOROVOD_SERVE_DEDUPE_TTL_S``
        (0 keeps none), at most ``DEDUPE_MAX_ENTRIES`` of them."""
        ttl = float(live_config().serve_dedupe_ttl_s)
        if ttl <= 0:
            return
        now = time.monotonic()
        with self._dedupe_lock:
            for k in [k for k, (_, exp) in self._dedupe.items()
                      if exp <= now]:
                del self._dedupe[k]
            self._dedupe[request_id] = (result, now + ttl)
            self._dedupe.move_to_end(request_id)
            while len(self._dedupe) > DEDUPE_MAX_ENTRIES:
                self._dedupe.popitem(last=False)

    def stop(self) -> None:
        self._announce_stop.set()
        if self._announce_thread is not None:
            self._announce_thread.join(timeout=5)
            self._announce_thread = None
        if self._thread is None:
            self._httpd.server_close()
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        self._thread = None


class Router:
    """The fleet's router over the rendezvous KV: capacity announcements
    and the heartbeat straggler ledger in, pick-and-forward out.
    Stateless apart from a local debit a route, so a burst routed
    between two announcements spreads, the freshness stamps and the
    tombstones."""

    def __init__(self, store_or_client,
                 straggler_factor: Optional[float] = None,
                 announce_ttl_s: float = DEFAULT_ANNOUNCE_TTL_S) -> None:
        from ..common.stall_inspector import (
            DEFAULT_STRAGGLER_FACTOR,
            StallInspector,
        )

        self._store = store_or_client
        self._ttl = float(announce_ttl_s)
        self._inspector = StallInspector(
            straggler_factor=(DEFAULT_STRAGGLER_FACTOR
                              if straggler_factor is None
                              else straggler_factor))
        self._debits: Dict[int, int] = {}
        # rank -> (last announced ts, the router's monotonic stamp of
        # when it last changed): freshness on this clock, so a worker's
        # skewed wall clock neither drops it nor keeps a dead one
        self._seen_ts: Dict[int, tuple] = {}
        # rank -> (announced ts at the failure, monotonic expiry): a
        # worker that failed a live call stays out for one freshness
        # period, or until it announces a newer ts
        self._tombstones: Dict[int, tuple] = {}
        self._lock = threading.Lock()

    def snapshot(self) -> Dict[int, dict]:
        """The live workers: announcements not draining, not in the
        driver's dead set, not tombstoned, whose ts keeps advancing on
        the router's clock. A rank's first sight has no history, so its
        wall ts decides once (a wall-stale leftover stays out, and
        revives on its next announcement)."""
        now = time.monotonic()
        out = {}
        dead_hosts, dead_ranks = self._dead_set()
        with self._lock:
            for rank, ann in read_announcements(self._store).items():
                if ann.get("draining"):
                    continue
                if (rank in dead_ranks
                        or str(ann.get("host") or "") in dead_hosts
                        or str(ann.get("addr") or "") in dead_hosts):
                    continue  # the driver declared it dead: out now
                ts = float(ann.get("ts", 0))
                tomb = self._tombstones.get(rank)
                if tomb is not None:
                    if ts == tomb[0] and now < tomb[1]:
                        continue  # the blob it announced before failing
                    del self._tombstones[rank]  # alive again, or aged out
                prev = self._seen_ts.get(rank)
                if prev is None:
                    wall_fresh = abs(time.time() - ts) <= self._ttl
                    stamp = now if wall_fresh else now - self._ttl - 1
                    self._seen_ts[rank] = (ts, stamp)
                    if wall_fresh:
                        out[rank] = ann
                elif prev[0] != ts:
                    self._seen_ts[rank] = (ts, now)
                    out[rank] = ann
                elif now - prev[1] <= self._ttl:
                    out[rank] = ann
        return out

    def _dead_set(self):
        """The driver's dead hosts and the ranks it mapped onto them;
        empty when the read fails (the set speeds eviction, it never
        blocks routing)."""
        from ..runner.rendezvous import read_dead_hosts

        try:
            dead = read_dead_hosts(self._store)
        except (OSError, RuntimeError, ValueError):
            return set(), set()
        return ({str(h) for h in dead.get("hosts", ())},
                {int(r) for r in dead.get("ranks", ())})

    def tombstone(self, rank: int, ann: Optional[dict] = None) -> None:
        """Keep a worker that failed a live call out: its current
        announcement is unroutable for one freshness period, or until
        it announces a newer ts."""
        with self._lock:
            self._tombstones[int(rank)] = (
                float((ann or {}).get("ts", 0.0)),
                time.monotonic() + self._ttl,
            )

    def straggler_ranks(self) -> List[int]:
        """The heartbeat ledger read fleet-side: every heartbeat's step
        stats into a :class:`~horovod_tpu_torch.common.stall_inspector.
        StallInspector`, whose flagged ranks the pick avoids."""
        from ..runner.rendezvous import read_heartbeat_stats

        try:
            stats = read_heartbeat_stats(self._store)
        except (OSError, RuntimeError):
            return []
        for rank, payload in stats.items():
            self._inspector.record_heartbeat(
                rank, ts=payload.get("ts"), step=payload.get("step"),
                step_ms_p50=payload.get("step_ms_p50"),
                last_step_ts=payload.get("last_step_ts"),
            )
        return self._inspector.straggler_ranks()

    def pick(self, exclude=()) -> Optional[dict]:
        """The least-loaded live worker that takes prompts (prefill ones
        when any exist, else unified; never decode), avoiding flagged
        stragglers unless they are all that is left; ``exclude`` drops
        ranks already failed this round. Debits the pick by one."""
        workers = self.snapshot()
        for rank in exclude:
            workers.pop(rank, None)
        workers = {r: w for r, w in workers.items()
                   if worker_role(w) != "decode"}
        prefill = {r: w for r, w in workers.items()
                   if worker_role(w) == "prefill"}
        workers = prefill or workers
        if not workers:
            return None
        flagged = set(self.straggler_ranks())
        healthy = {r: w for r, w in workers.items() if r not in flagged}
        pool = healthy or workers
        if not healthy:
            _log.warning("all serve workers flagged as stragglers (%s); "
                         "routing to a flagged rank anyway",
                         sorted(flagged))
        with self._lock:
            def load(item):
                rank, w = item
                # a request needs a slot and pages: the smaller headroom,
                # in requests; a blob without pages routes on slots
                pages = w.get("free_pages")
                free = w.get("free_slots", 0)
                if pages is not None:
                    free = min(int(free), int(pages))
                free -= self._debits.get(rank, 0)
                return (-free, w.get("queue_depth", 0), rank)

            rank, ann = min(pool.items(), key=load)
            self._debits[rank] = self._debits.get(rank, 0) + 1
            return dict(ann, rank=rank)

    def credit(self, rank: int) -> None:
        """Return a pick's debit once its request is over."""
        with self._lock:
            if self._debits.get(rank, 0) > 0:
                self._debits[rank] -= 1

    def _post_generate(self, ann: dict, body: bytes, timeout: float,
                       span=None) -> dict:
        """One ``/generate`` POST to one worker, the unit of every path
        (first try, replay, hedge arm). A leg ``span`` carries its
        context in the ``traceparent`` header and takes the reply's
        clock stamps."""
        import urllib.request

        url = (f"http://{ann.get('addr', '127.0.0.1')}:{ann['port']}"
               f"/generate")
        headers = {"Content-Type": "application/json"}
        if span is not None:
            headers[_tracing.TRACEPARENT_HEADER] = (
                span.ctx.to_traceparent())
        req = urllib.request.Request(url, data=body, headers=headers,
                                     method="POST")
        t_send = time.time()
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            out = json.loads(resp.read().decode())
            _tracing.tag_hop(span, t_send, time.time(), resp.headers)
        return out

    def _note_failure(self, ann: dict, err: Exception, span=None) -> None:
        """A failed live call: a 503 is an orderly refusal (plain
        failover); anything else means the worker went dark with the
        request possibly in flight, so the retry is a replay
        (``serve.replays``) and its announcement is tombstoned."""
        import urllib.error

        _metrics.counter("serve.route_failover")
        if isinstance(err, urllib.error.HTTPError) and err.code == 503:
            if span is not None:
                span.end(outcome="failover", code=503)
            return
        _metrics.counter("serve.replays")
        if span is not None:
            span.end(outcome="replayed",
                     error=f"{type(err).__name__}: {err}")
        self.tombstone(ann["rank"], ann)

    def route(self, tokens, max_tokens: Optional[int] = None,
              deadline_ms: Optional[float] = None, timeout: float = 60.0,
              attempts: int = 3, temperature: float = 0.0, top_k: int = 0,
              seed: Optional[int] = None, request_id: Optional[str] = None,
              hedge_ms: Optional[float] = None, trace=None) -> dict:
        """POST ``/generate`` on the picked worker. The payload is the
        journal: a dead or draining pick fails over, and a worker that
        dies mid-call has the request replayed on another, idempotent by
        ``request_id`` (made here when the caller brings none). A 4xx is
        the request's fault and raises at once. ``hedge_ms`` (default
        ``HOROVOD_SERVE_HEDGE_MS``, 0 off) fires a backup on a second
        worker after the delay; the first answer wins. Each leg is a
        ``route.attempt`` span under the ``route`` root."""
        import urllib.error

        payload: dict = {"tokens": [int(t) for t in tokens]}
        if max_tokens is not None:
            payload["max_tokens"] = int(max_tokens)
        if deadline_ms is not None:
            payload["deadline_ms"] = float(deadline_ms)
        if temperature:
            payload["temperature"] = float(temperature)
        if top_k:
            payload["top_k"] = int(top_k)
        if seed is not None:
            payload["seed"] = int(seed)
        payload["request_id"] = str(request_id or uuid.uuid4().hex)
        body = json.dumps(payload).encode()
        last_err: Optional[Exception] = None
        failed: set = set()
        tctx = trace if trace is not None else _tracing.mint()
        root = _tracing.root_span("route", tctx,
                                  request_id=payload["request_id"])
        try:
            if hedge_ms is None:
                hedge_ms = live_config().serve_hedge_ms
            if hedge_ms and float(hedge_ms) > 0:
                out, failed, last_err = self._route_hedged(
                    body, timeout, float(hedge_ms) / 1e3, tctx=tctx)
                if out is not None:
                    if root is not None:
                        root.tag(outcome="ok")
                        out.setdefault("trace_id", tctx.trace_id)
                    return out
                # every arm went dark: the loop below replays, the
                # failed ranks excluded
            for _ in range(max(int(attempts), 1)):
                ann = self.pick(exclude=failed)
                if ann is None:
                    if failed:
                        raise RuntimeError(
                            f"routing failed: every live worker errored "
                            f"({sorted(failed)}): {last_err}")
                    raise RuntimeError("no live serve workers announced")
                leg = _tracing.start_span(
                    "route.attempt", tctx, rank=int(ann["rank"]),
                    mode="replay" if failed else "first")
                try:
                    out = self._post_generate(ann, body, timeout, span=leg)
                    if leg is not None:
                        leg.end(outcome="ok")
                        out.setdefault("trace_id", tctx.trace_id)
                    if root is not None:
                        root.tag(outcome="ok")
                    return out
                except urllib.error.HTTPError as e:
                    if e.code >= 500:
                        # the worker's fault: the next candidate
                        last_err = e
                        failed.add(ann["rank"])
                        self._note_failure(ann, e, span=leg)
                        continue
                    # the request's fault: every worker would say so
                    if leg is not None:
                        leg.end(outcome="rejected", code=e.code)
                    try:
                        detail = json.loads(e.read().decode()).get(
                            "error", "")
                    except (ValueError, OSError):
                        detail = ""
                    raise RuntimeError(
                        f"request rejected by rank {ann['rank']} (HTTP "
                        f"{e.code}): {detail or e.reason}") from e
                except (OSError, ValueError) as e:
                    last_err = e
                    failed.add(ann["rank"])
                    self._note_failure(ann, e, span=leg)
                    continue
                finally:
                    self.credit(ann["rank"])
            raise RuntimeError(
                f"routing failed after {attempts} attempts: {last_err}")
        finally:
            if root is not None:
                if "outcome" not in root.tags:
                    root.tag(outcome="error")
                root.end()

    def _route_hedged(self, body: bytes, timeout: float, hedge_s: float,
                      tctx=None):
        """The primary at once; if nothing has landed after ``hedge_s``,
        a backup on a second worker (``serve.hedges``). The first
        answer wins and the loser's is dropped when it lands. Returns
        ``(result or None, failed ranks, last error)``; each arm is a
        ``route.attempt`` span tagged ``hedge=primary|backup``."""
        primary = self.pick()
        if primary is None:
            return None, set(), None
        cv = threading.Condition()
        box: dict = {"errors": []}

        def arm(ann, hedge_tag):
            leg = _tracing.start_span("route.attempt", tctx,
                                      rank=int(ann["rank"]), hedge=hedge_tag)
            try:
                out = self._post_generate(ann, body, timeout, span=leg)
            except Exception as e:  # noqa: BLE001 - an arm's failure is data
                with cv:
                    box["errors"].append((ann, e, leg))
                    cv.notify_all()
            else:
                with cv:
                    won = "result" not in box
                    box.setdefault("result", out)
                    cv.notify_all()
                if leg is not None:
                    leg.end(outcome="ok" if won else "discarded")
            finally:
                self.credit(ann["rank"])

        threading.Thread(target=arm, args=(primary, "primary"),
                         name="hvd-route-primary", daemon=True).start()
        arms = 1
        deadline = time.monotonic() + timeout
        with cv:
            cv.wait(timeout=hedge_s)
            if "result" not in box and not box["errors"]:
                backup = self.pick(exclude={primary["rank"]})
                if backup is not None:
                    _metrics.counter("serve.hedges")
                    arms = 2
                    threading.Thread(target=arm, args=(backup, "backup"),
                                     name="hvd-route-hedge",
                                     daemon=True).start()
            while "result" not in box and len(box["errors"]) < arms:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not cv.wait(timeout=remaining):
                    break
            errors = list(box["errors"])
            result = box.get("result")
        failed: set = set()
        last_err: Optional[Exception] = None
        for ann, err, leg in errors:
            failed.add(ann["rank"])
            last_err = err
            self._note_failure(ann, err, span=leg)
        return result, failed, last_err


class ServeHandle:
    """What :func:`serve` returns: the running plane and its lifecycle."""

    def __init__(self, engine, batcher, frontend, shutdown_ctx=None,
                 transfer_server=None):
        self.engine = engine
        self.batcher = batcher
        self.frontend = frontend
        self.transfer_server = transfer_server
        self._shutdown_ctx = shutdown_ctx
        self._stopped = threading.Event()

    @property
    def port(self) -> int:
        return self.frontend.port

    def drain(self, timeout: float = 30.0,
              migrate_after: Optional[float] = None) -> bool:
        """The frontend's drain; a sharded leader then sends its
        followers "stop"."""
        ok = self.frontend.drain(timeout=timeout,
                                 migrate_after=migrate_after)
        self.engine.close()
        return ok

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until stop()."""
        return self._stopped.wait(timeout)

    def stop(self) -> None:
        from .. import preemption

        preemption.unregister_drain(self._drain_hook)
        try:
            self.frontend.stop()
            self.batcher.stop()
            if self.transfer_server is not None:
                self.transfer_server.stop()
            self.engine.close()  # a sharded leader's followers stop
        finally:
            if self._shutdown_ctx is not None:
                self._shutdown_ctx.__exit__(None, None, None)
                self._shutdown_ctx = None
            self._stopped.set()

    def _drain_hook(self) -> None:
        # the deadline from HOROVOD_SERVE_DRAIN_DEADLINE_S
        self.drain()


class FollowerHandle:
    """What :func:`serve` returns on a follower rank of a sharded engine:
    the engine's ``follow()`` on a thread bound to the device, and no
    port. ``wait()`` and ``stop()`` end with the leader's "stop";
    ``error`` holds what ``follow()`` raised, if it did (the thread logs
    it too)."""

    port = None
    batcher = None
    frontend = None

    def __init__(self, engine):
        self.engine = engine
        self.error: Optional[BaseException] = None
        self.ops = 0
        self._thread = threading.Thread(target=self._follow,
                                        name="hvd-serve-follower",
                                        daemon=True)
        self._thread.start()

    def _follow(self) -> None:
        try:
            self.ops = self.engine.follow()
        except BaseException as e:  # noqa: BLE001 - kept and logged
            self.error = e
            _log.exception("serve follower failed")

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the leader's "stop" (or a failure); True once the
        follower has ended."""
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def drain(self, timeout: float = 30.0, migrate_after=None) -> bool:
        """A follower has nothing of its own to drain: wait for the
        leader's "stop"."""
        return self.wait(timeout)

    def stop(self, timeout: Optional[float] = None) -> None:
        """Wait for the leader's "stop": a follower cannot leave its
        leader's group early."""
        self.wait(timeout)


def serve(
    model,
    params=None,
    port: Optional[int] = None,
    *,
    slots: Optional[int] = None,
    max_len: Optional[int] = None,
    max_new_tokens: Optional[int] = None,
    deadline_ms: Optional[float] = None,
    max_admit_per_step: Optional[int] = None,
    eos_id: Optional[int] = None,
    addr: str = "0.0.0.0",
    advertise_addr: str = "127.0.0.1",
    rank: Optional[int] = None,
    handle_sigterm: bool = True,
    role: Optional[str] = None,
    kv_wire: Optional[str] = None,
    transfer_port: Optional[int] = None,
    announce_client=None,
    device=None,
    mesh=None,
    policy: str = "continuous",
    **engine_kwargs,
):
    """Start the inference plane on this worker: engine, continuous
    batcher and HTTP frontend, drain-wired into SIGTERM.

    ``model`` is a :class:`~horovod_tpu_torch.models.transformer.
    Transformer`; ``params`` a ``state_dict`` to load into it, or None
    to serve its own weights. ``device`` None means the CUDA card;
    without one this raises. Env defaults: ``HOROVOD_SERVE_PORT``,
    ``_KV_SLOTS``, ``_MAX_BATCH``, ``_MAX_TOKENS``, ``_DEADLINE_MS`` and
    the paged-pool knobs; ``engine_kwargs`` go to
    :class:`~.engine.InferenceEngine` (``prefill_ceiling``, ``paged``,
    ``page_tokens``, ``pages``, ``paged_attn``, ...).

    ``handle_sigterm=True`` installs a :class:`~horovod_tpu_torch.
    preemption.GracefulShutdown`, so the worker drains on SIGTERM and
    exits 143; pass False when the caller owns the signal.

    A disaggregated fleet: ``role`` (``HOROVOD_SERVE_ROLE``) ``"prefill"``
    or ``"decode"`` (``"unified"`` serves alone), ``kv_wire``
    (``HOROVOD_SERVE_KV_WIRE``: ``int8``, ``bf16`` or ``fp32``, checked
    on every role) and ``transfer_port`` (``HOROVOD_SERVE_TRANSFER_PORT``,
    0 ephemeral) for the decode worker's KV server. The workers meet in
    the rendezvous KV: ``announce_client`` (a ``RendezvousClient`` or
    ``KVStore``), or the launcher's ``HOROVOD_GLOO_RENDEZVOUS_ADDR/
    PORT``; a prefill worker with no decode worker announced decodes
    locally.

    ``policy`` is the batcher's (``"continuous"`` or ``"static"``).
    ``mesh`` (a built ``parallel.mesh.Mesh``; every rank of it calls
    ``serve``) serves a sharded engine: ``model`` is this rank's shard
    (``Transformer(cfg, mesh=mesh)``) and ``params`` its
    ``convert.shard_state_dict`` (or None). The engine's leader serves
    HTTP as above; a follower returns a :class:`FollowerHandle` and opens
    no port.
    """
    from .. import preemption
    from .engine import ROLES, InferenceEngine
    from .kv_transfer import WIRE_FORMATS

    cfg = live_config()
    if role is None:
        role = cfg.serve_role
    if role not in ROLES:
        raise ValueError(f"role must be one of {ROLES}, got {role!r}")
    if kv_wire is None:
        kv_wire = cfg.serve_kv_wire
    if kv_wire not in WIRE_FORMATS:
        raise ValueError(
            f"kv wire must be one of {WIRE_FORMATS}, got {kv_wire!r}")
    if transfer_port is None:
        transfer_port = cfg.serve_transfer_port
    _tracing.set_role(role)
    if port is None:
        port = cfg.serve_port
    if slots is None:
        slots = cfg.serve_kv_slots
    if max_new_tokens is None:
        max_new_tokens = cfg.serve_max_tokens
    if deadline_ms is None:
        deadline_ms = cfg.serve_deadline_ms
    if max_admit_per_step is None:
        max_admit_per_step = cfg.serve_max_batch
    if max_len is None:
        max_len = model.cfg.max_len
    engine = InferenceEngine(
        model, params, slots=slots, max_len=max_len, device=device,
        role=role, mesh=mesh, **engine_kwargs,
    )
    if not engine.leader:
        return FollowerHandle(engine)
    batcher = ContinuousBatcher(
        engine,
        max_admit_per_step=max_admit_per_step,
        default_max_new_tokens=max_new_tokens,
        default_deadline_ms=deadline_ms,
        eos_id=eos_id,
        role=role,
        policy=policy,
    )
    transfer_server = None
    if role == "decode" or (role == "unified" and engine.paged
                            and not engine.sharded):
        # decode workers take prefill handoffs; a paged unified worker
        # runs the server too, so a draining peer can live-migrate its
        # in-flight sequences here: a one-role fleet is still evacuable
        from .kv_transfer import KVTransferServer

        transfer_server = KVTransferServer(batcher, port=transfer_port,
                                           addr=addr)
        transfer_server.start()
    frontend = ServeFrontend(
        batcher, port=port, addr=addr, advertise_addr=advertise_addr,
        rank=rank, announce_client=announce_client,
        transfer_server=transfer_server,
    )
    if role == "prefill":
        from .kv_transfer import TransferCoordinator

        # reads the announcements the fleet publishes, resolved lazily:
        # a prefill worker with no fleet decodes locally
        batcher.transfer = TransferCoordinator(
            engine, wire=kv_wire,
            client_factory=frontend._resolve_announce_client,
        )
    shutdown_ctx = None
    if handle_sigterm:
        shutdown_ctx = preemption.GracefulShutdown(None).__enter__()
    handle = ServeHandle(engine, batcher, frontend, shutdown_ctx,
                         transfer_server=transfer_server)
    preemption.register_drain(handle._drain_hook)
    batcher.start()
    frontend.start()
    return handle
