"""HTTP frontend: ``serve(model, params, port=…)``.

A stdlib ``ThreadingHTTPServer`` per worker, no dependencies. Routes:

* ``POST /generate``: body ``{"tokens": [...], "max_tokens"?,
  "deadline_ms"?, "temperature"?, "top_k"?, "seed"?}``. The handler
  thread parks on the request until the batcher's thread has finished
  it, then replies the result JSON (tokens, status, TTFT, generation
  wall). 400 on a malformed body, 429 when the request can never fit,
  503 while draining, 500 when the scheduler failed under it. Request
  tracing (``common/tracing.py``): the handler adopts a ``traceparent``
  header, or mints a root when ``HOROVOD_TRACE`` is on, opens the
  ``http.generate`` span and hands its context to the batcher; a traced
  reply carries ``X-Trace-Id``, the receive/send stamps and
  ``trace_id`` in its JSON.
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
request before the worker exits.

A fleet meets in the rendezvous KV: each worker announces its capacity
(:meth:`ServeFrontend.capacity`: role, free slots and pages, the
transfer port) under scope ``serve`` every second
(:func:`put_announcement`), and a prefill worker's
:class:`~.kv_transfer.TransferCoordinator` reads the decode workers'
announcements (:func:`read_announcements`). ``serve(role="prefill")``
wires that coordinator; ``serve(role="decode")`` (and a paged unified
worker) runs a :class:`~.kv_transfer.KVTransferServer`. The JAX
frontend's fleet router, hedging, result dedupe and live migration come
in a later slice.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from ..common import telemetry as _telemetry
from ..common import tracing as _tracing
from ..common.config import live_config
from ..common.logging import TRACE as _TRACE, get_logger
from ..common.metrics import registry as _metrics
from ..common.telemetry import PROM_CONTENT_TYPE, render_prometheus
from .batcher import ContinuousBatcher, Rejected

_log = get_logger("serve.frontend")

SERVE_SCOPE = "serve"
DEFAULT_ANNOUNCE_INTERVAL_S = 1.0


def put_announcement(client, rank: int, payload: dict) -> None:
    """A worker's capacity blob into the rendezvous KV (a ``KVStore`` or
    a ``RendezvousClient``), scope ``serve``, key the rank."""
    client.put(SERVE_SCOPE, str(int(rank)), json.dumps(payload).encode())


def read_announcements(store_or_client) -> Dict[int, dict]:
    """Every rank's last capacity blob; entries that do not parse, or
    carry no ``port``, are skipped."""
    out: Dict[int, dict] = {}
    for key in store_or_client.keys(SERVE_SCOPE):
        raw = store_or_client.get(SERVE_SCOPE, key)
        if raw is None:
            continue
        try:
            rank = int(key)
            obj = json.loads(raw.decode())
        except (ValueError, UnicodeDecodeError):
            continue
        if isinstance(obj, dict) and "port" in obj:
            out[rank] = obj
    return out


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
                    return self._json(code, req.result(), hdrs)
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

    def drain(self, timeout: float = 30.0) -> bool:
        """Refuse new work, finish the accepted work, let the in-flight
        responses flush."""
        self._draining = True
        self.announce()  # the router-side view: draining, no capacity
        ok = self.batcher.drain(timeout=timeout)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with self._inflight_lock:
                if self._inflight == 0:
                    break
            time.sleep(0.01)
        return ok

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

    def drain(self, timeout: float = 30.0) -> bool:
        return self.frontend.drain(timeout=timeout)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until stop()."""
        return self._stopped.wait(timeout)

    def stop(self) -> None:
        from .. import preemption

        preemption.unregister_drain(self._drain_hook)
        self.frontend.stop()
        self.batcher.stop()
        if self.transfer_server is not None:
            self.transfer_server.stop()
        if self._shutdown_ctx is not None:
            self._shutdown_ctx.__exit__(None, None, None)
            self._shutdown_ctx = None
        self._stopped.set()

    def _drain_hook(self) -> None:
        self.frontend.drain()


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
    **engine_kwargs,
) -> ServeHandle:
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
        role=role, **engine_kwargs,
    )
    batcher = ContinuousBatcher(
        engine,
        max_admit_per_step=max_admit_per_step,
        default_max_new_tokens=max_new_tokens,
        default_deadline_ms=deadline_ms,
        eos_id=eos_id,
        role=role,
    )
    transfer_server = None
    if role == "decode" or (role == "unified" and engine.paged):
        # decode workers take prefill handoffs; a paged unified worker
        # runs the server too, as the JAX one does (live migration's
        # target, a later slice)
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
