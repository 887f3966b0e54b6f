"""HTTP key-value rendezvous: the launcher's KV store and its clients.

A copy of ``horovod_tpu/runner/rendezvous.py`` (standard library only)
on the port's ``common/retry.py`` and ``testing/chaos.py`` (sites
``kv.request``, ``kv.server`` and ``kv.wait``). The driver runs a
threaded HTTP server holding a scoped KV store; workers PUT and GET
(polling) through it. The port's collectives meet at a
``torch.distributed`` TCP store (``common/basics.py``); this KV carries
what the launcher and the elastic driver exchange with the workers:
the object collectives :func:`broadcast_via_kv`/:func:`allgather_via_kv`,
the workers' notification addresses, heartbeats, audit digests, the
restart stamp, the dead-host set, the version check, the straggler
rebalance's weights and the expert-load ledger. The wire is the JAX
package's, so a port client talks to a JAX server and back, and each
channel's JSON is the JAX package's byte for byte.

Differences: one Python server (the JAX package's native C++ server is
its ``_native`` layer, not ported: ROADMAP A17); every process speaks
for one rank, so the object collectives key by rank; the version check
compares the port's version, torch's and CUDA's; the schedule and
standby channels wait for the modules that use them (ROADMAP A16).

Wire protocol:
    GET    /kv/<scope>/<key>   -> 200 value | 404
    PUT    /kv/<scope>/<key>   body = value -> 200
    DELETE /kv/<scope>         -> 200 (drop whole scope)
    GET    /scope/<scope>      -> 200 JSON list of keys

If the server was created with a secret key, every request must carry
``X-Horovod-Digest: hex(hmac_sha256(secret, method + path + body))``;
bad or missing digests get 403.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from .secret import sign
from ..common.logging import TRACE as _TRACE, get_logger
from ..common.retry import RetryPolicy, backoff_delays
from ..testing import chaos as _chaos

_log = get_logger("rendezvous")


class KVStore:
    """Thread-safe scoped key-value store."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._data: Dict[str, Dict[str, bytes]] = {}

    def put(self, scope: str, key: str, value: bytes) -> None:
        with self._lock:
            self._data.setdefault(scope, {})[key] = value

    def get(self, scope: str, key: str) -> Optional[bytes]:
        with self._lock:
            return self._data.get(scope, {}).get(key)

    def keys(self, scope: str) -> List[str]:
        with self._lock:
            return sorted(self._data.get(scope, {}).keys())

    def drop_scope(self, scope: str) -> None:
        with self._lock:
            self._data.pop(scope, None)


def _make_handler(store: KVStore, secret_key: Optional[bytes]):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            # Route through the horovod logger at trace level instead
            # of stderr spam; %-args pass through so logging defers the
            # formatting to the (rare) TRACE-enabled case.
            _log.log(_TRACE, "http " + fmt, *args)

        def _body(self) -> bytes:
            length = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(length) if length else b""

        def _authed(self, body: bytes) -> bool:
            if secret_key is None:
                return True
            digest = self.headers.get("X-Horovod-Digest", "")
            want = sign(
                secret_key, self.command.encode() + self.path.encode() + body
            ).hex()
            import hmac as _hmac

            return _hmac.compare_digest(digest, want)

        def _reply(self, code: int, body: bytes = b"") -> None:
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _inject_chaos(self) -> bool:
            """``kv.server`` injection site. Returns True when the
            request was consumed by a fault (503 answered, or the
            connection torn down mid-exchange). (Named so it cannot
            shadow the module's ``_chaos`` import inside the class.)"""
            try:
                _chaos.inject("kv.server")
            except _chaos.InjectedServerError:
                self._reply(503)
                return True
            except (ConnectionResetError, TimeoutError):
                # abrupt teardown: the client sees a dropped/short
                # response and must absorb it with its RetryPolicy
                self.close_connection = True
                try:
                    self.connection.close()
                except OSError:
                    pass
                return True
            return False

        def do_GET(self):
            if self._inject_chaos():
                return
            if not self._authed(b""):
                return self._reply(403)
            parts = self.path.strip("/").split("/")
            if len(parts) == 3 and parts[0] == "kv":
                value = store.get(parts[1], parts[2])
                if value is None:
                    return self._reply(404)
                return self._reply(200, value)
            if len(parts) == 2 and parts[0] == "scope":
                return self._reply(
                    200, json.dumps(store.keys(parts[1])).encode()
                )
            return self._reply(404)

        def do_PUT(self):
            if self._inject_chaos():
                return
            body = self._body()
            if not self._authed(body):
                return self._reply(403)
            parts = self.path.strip("/").split("/")
            if len(parts) == 3 and parts[0] == "kv":
                store.put(parts[1], parts[2], body)
                return self._reply(200)
            return self._reply(404)

        def do_DELETE(self):
            if not self._authed(b""):
                return self._reply(403)
            parts = self.path.strip("/").split("/")
            if len(parts) == 2 and parts[0] == "kv":
                store.drop_scope(parts[1])
                return self._reply(200)
            return self._reply(404)

    return Handler


class RendezvousServer:
    """Driver-side rendezvous on an ephemeral or fixed port: a threaded
    ``http.server`` over a :class:`KVStore`, which ``.store`` exposes
    (the elastic driver reads it directly)."""

    def __init__(self, port: int = 0,
                 secret_key: Optional[bytes] = None) -> None:
        self._secret_key = secret_key
        self._thread: Optional[threading.Thread] = None
        self.backend = "python"
        self.store = KVStore()
        self._httpd = ThreadingHTTPServer(
            ("0.0.0.0", port), _make_handler(self.store, secret_key)
        )

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="hvd-rendezvous", daemon=True
        )
        self._thread.start()
        _log.info("rendezvous server listening on port %d", self.port)
        return self.port

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


class RendezvousClient:
    """Worker-side accessor for the driver's KV store.

    Every HTTP exchange runs under the shared ``RetryPolicy`` (site
    ``kv.request``): transient connection resets / timeouts / 5xx are
    absorbed with jittered backoff, a dead driver trips the per-peer
    circuit breaker so callers fail fast instead of stalling the gang,
    and every absorbed flake is a ``retry.kv.request.*`` counter on
    ``/metrics``. All KV verbs are idempotent (GET, last-write-wins
    PUT, scope DELETE), so re-sending after an ambiguous failure is
    safe by construction."""

    # polling backoff cap for wait(): a worker parked on a slow key
    # settles at ~1 req/s instead of 20/s (12k hits per worker over a
    # 600s start_timeout was the pre-retry behavior)
    WAIT_BACKOFF_CAP_S = 1.0

    def __init__(
        self,
        addr: str,
        port: int,
        secret_key: Optional[bytes] = None,
        retry: Optional[RetryPolicy] = None,
    ) -> None:
        self._base = f"http://{addr}:{port}"
        self._secret_key = secret_key
        self._retry = retry or RetryPolicy.from_env("kv.request")

    def _request_once(self, method: str, path: str, body: bytes = b""):
        import urllib.error
        import urllib.request

        _chaos.inject("kv.request")
        req = urllib.request.Request(
            self._base + path, data=body if method == "PUT" else None,
            method=method,
        )
        if self._secret_key is not None:
            req.add_header(
                "X-Horovod-Digest",
                sign(
                    self._secret_key, method.encode() + path.encode() + body
                ).hex(),
            )
        try:
            with urllib.request.urlopen(
                req, timeout=self._retry.attempt_timeout_s
            ) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 429 or 500 <= e.code <= 599:
                raise  # transient server-side failure: retryable
            return e.code, b""

    def _request(self, method: str, path: str, body: bytes = b""):
        """One KV exchange under the retry policy. Raises
        ``RetryError`` (a ``ConnectionError``) on exhaustion and
        ``CircuitOpenError`` once the driver's endpoint is known-dead —
        both land in the callers' existing ``except OSError`` paths."""
        return self._retry.call(
            self._request_once, method, path, body, peer=self._base
        )

    def put(self, scope: str, key: str, value: bytes) -> None:
        status, _ = self._request("PUT", f"/kv/{scope}/{key}", value)
        if status != 200:
            raise RuntimeError(f"rendezvous PUT failed with HTTP {status}")

    def get(self, scope: str, key: str) -> Optional[bytes]:
        status, body = self._request("GET", f"/kv/{scope}/{key}")
        return body if status == 200 else None

    def wait(
        self,
        scope: str,
        key: str,
        timeout: float = 30.0,
        interval: Optional[float] = None,
        should_stop=None,
    ) -> bytes:
        """Poll until the key appears — the worker-side rendezvous loop.

        The poll interval follows the shared jittered-doubling backoff
        (``interval`` seeds it, default 0.05s, capped at ~1s), so a
        worker parked behind a 600s ``start_timeout`` costs the driver
        ~O(600) requests instead of ~12k. ``should_stop`` (a callable)
        aborts the wait early — the elastic worker passes its shutdown
        event so a driver teardown doesn't leave pollers spinning to
        their full deadline; a tripped KV circuit (driver gone) aborts
        it the same way."""
        import time

        deadline = time.monotonic() + timeout
        delays = backoff_delays(
            0.05 if interval is None else float(interval),
            self.WAIT_BACKOFF_CAP_S,
        )
        while True:
            # shutdown first: a latched abort must not pay one more
            # KV exchange (against a hung driver that is a full retry
            # ladder of the preemption grace window)
            if should_stop is not None and should_stop():
                raise RuntimeError(
                    f"rendezvous wait for {scope}/{key} aborted: "
                    f"shutdown requested"
                )
            # per-POLL injection site (a plan can flake iteration N of
            # a long wait, not just the call as a whole)
            _chaos.inject("kv.wait")
            value = self.get(scope, key)
            if value is not None:
                return value
            now = time.monotonic()
            if now >= deadline:
                raise TimeoutError(
                    f"rendezvous key {scope}/{key} not published in {timeout}s"
                )
            time.sleep(min(next(delays), deadline - now))

    def keys(self, scope: str) -> List[str]:
        status, body = self._request("GET", f"/scope/{scope}")
        return json.loads(body) if status == 200 else []


# Worker-side shutdown latch: once set (elastic worker teardown, or the
# preemption handler's SIGTERM), every in-flight KV poll loop aborts at
# its next iteration instead of spinning to its full deadline — a dying
# process must not keep hammering the driver's KV for up to 600s.
_poll_shutdown = threading.Event()


def request_poll_shutdown() -> None:
    _poll_shutdown.set()


def reset_poll_shutdown() -> None:
    """Re-arm after an elastic re-init (the process lives on)."""
    _poll_shutdown.clear()


_broadcast_counts: Dict[str, int] = {}


def _kv_of_world(what: str):
    from ..common import basics

    cfg = basics.get_config()
    if not cfg.rendezvous_addr or not cfg.rendezvous_port:
        raise RuntimeError(
            f"{what} across processes needs the runner's rendezvous "
            "(HOROVOD_GLOO_RENDEZVOUS_ADDR/PORT not set)"
        )
    return cfg, _client_from_cfg(cfg), basics.topology()


def _round_name(base: str) -> str:
    """A fresh key a round: every rank calls the object collectives in
    the same order, so a per-name counter agrees everywhere, and a
    reused name never hands a rank the previous round's payload."""
    count = _broadcast_counts.get(base, 0)
    _broadcast_counts[base] = count + 1
    return f"{base}.{count}"


def broadcast_via_kv(obj, root_rank: int = 0, name: Optional[str] = None):
    """Object broadcast through the job's rendezvous KV: ``root_rank``
    publishes the pickled object and every other rank polls for it. The
    channel is HMAC-authenticated with the job's secret, which is what
    makes pickle acceptable here: only holders of the secret can
    publish payloads."""
    import pickle

    cfg, client, topo = _kv_of_world("broadcast_object")
    key = _round_name("broadcast_object" if name is None else name)
    if topo.rank == root_rank:
        client.put("broadcast", key, pickle.dumps(obj))
        return obj
    payload = client.wait(
        "broadcast", key, timeout=cfg.gloo_timeout_seconds,
        should_stop=_poll_shutdown.is_set,
    )
    return pickle.loads(payload)


def allgather_via_kv(obj, name: Optional[str] = None):
    """Object allgather through the rendezvous KV: every rank publishes
    its pickled object under its rank and polls until the whole set is
    present; one entry a rank, in rank order. The trust model of
    :func:`broadcast_via_kv`."""
    import pickle

    cfg, client, topo = _kv_of_world("allgather_object")
    scope = _round_name("allgather_object" if name is None else name)
    client.put(scope, str(topo.rank), pickle.dumps(obj))
    return [
        pickle.loads(client.wait(
            scope, str(r), timeout=cfg.gloo_timeout_seconds,
            should_stop=_poll_shutdown.is_set,
        ))
        for r in range(topo.size)
    ]


# ------------------------------------------------------------- heartbeats
# Worker→driver liveness over the KV channel, with the flight recorder's
# straggler ledger beside it: the driver's stall inspector reads them.

HEARTBEAT_SCOPE = "heartbeat"


def put_heartbeat(
    client: "RendezvousClient", rank: int, stats: Optional[dict] = None
) -> None:
    """Stamp this worker's liveness. Call on a timer (the elastic worker
    loop does; any long-running worker can).

    ``stats`` piggybacks what the worker reports beside its liveness
    (the JAX package's straggler ledger: ``step``, ``step_ms_p50``,
    ``last_step_ts``). The payload is JSON ``{"ts": ..., **stats}``;
    readers also accept the bare-float form."""
    import time as _time

    payload = {"ts": _time.time()}
    if stats:
        payload.update(stats)
    client.put(
        HEARTBEAT_SCOPE, str(int(rank)), json.dumps(payload).encode()
    )


def _parse_heartbeat(raw: bytes) -> Optional[dict]:
    """One heartbeat value → dict with at least ``ts``. Accepts the
    JSON payload and the legacy ``repr(time.time())`` float."""
    try:
        text = raw.decode()
    except UnicodeDecodeError:
        return None
    try:
        obj = json.loads(text)
    except json.JSONDecodeError:
        obj = None
    if isinstance(obj, dict) and "ts" in obj:
        try:
            obj["ts"] = float(obj["ts"])
        except (TypeError, ValueError):
            return None
        return obj
    try:
        return {"ts": float(text)}
    except ValueError:
        return None


def read_heartbeats(store_or_client) -> Dict[int, float]:
    """Driver side: {rank: unix_ts} of every heartbeat present. Accepts
    the in-process KVStore or a RendezvousClient."""
    return {
        r: s["ts"] for r, s in read_heartbeat_stats(store_or_client).items()
    }


def read_heartbeat_stats(store_or_client) -> Dict[int, dict]:
    """Driver side of the straggler ledger: {rank: payload} with at
    least ``ts``, plus whatever telemetry the worker piggybacked
    (``step``, ``step_ms_p50``, ``last_step_ts``)."""
    out: Dict[int, dict] = {}
    for key in store_or_client.keys(HEARTBEAT_SCOPE):
        raw = store_or_client.get(HEARTBEAT_SCOPE, key)
        if raw is None:
            continue
        try:
            rank = int(key)
        except ValueError:
            continue
        parsed = _parse_heartbeat(raw)
        if parsed is not None:
            out[rank] = parsed
    return out


AUDIT_SCOPE = "audit"


def put_audit(
    client: "RendezvousClient", rank: int, step: int, digest: str
) -> None:
    """Worker side of the parameter-audit ledger (audit.py): publish
    this rank's newest tree digest. One KV key per rank, overwritten
    per audit — the driver only ever compares the latest round."""
    import time as _time

    payload = {"ts": _time.time(), "step": int(step), "digest": str(digest)}
    client.put(AUDIT_SCOPE, str(int(rank)), json.dumps(payload).encode())


def read_audit_digests(store_or_client) -> Dict[int, dict]:
    """Driver side: ``{rank: {"ts", "step", "digest"}}`` of every
    published audit entry. Malformed entries are skipped — a corrupt
    audit record must not crash the auditor."""
    out: Dict[int, dict] = {}
    for key in store_or_client.keys(AUDIT_SCOPE):
        raw = store_or_client.get(AUDIT_SCOPE, key)
        if raw is None:
            continue
        try:
            rank = int(key)
            obj = json.loads(raw.decode())
        except (ValueError, UnicodeDecodeError):
            continue
        if isinstance(obj, dict) and "digest" in obj and "step" in obj:
            out[rank] = obj
    return out


RESTART_SCOPE = "restart"


def put_restart_stamp(
    store_or_client,
    epoch: int,
    reason: str,
    warm: bool = False,
    kind: str = "restart",
) -> None:
    """Driver side of the restart clock: stamped at gang-teardown time
    (``_reset``), read by every worker of the NEXT epoch at init —
    ``now - ts`` is that worker's ``elastic.restart_ms`` (or
    ``serve.scaleup_ms`` when ``kind == "scaleup"``). ``warm`` records
    whether a warm standby absorbed the restart, so the gauge can be
    compared against the cold baseline."""
    import time as _time

    payload = {
        "ts": _time.time(),
        "epoch": int(epoch),
        "reason": str(reason),
        "warm": bool(warm),
        "kind": str(kind),
    }
    store_or_client.put(
        RESTART_SCOPE, "stamp", json.dumps(payload).encode()
    )


def read_restart_stamp(store_or_client) -> Optional[dict]:
    """Worker side: the newest restart stamp, or None (first launch /
    malformed blob — a corrupt stamp must never fail worker init)."""
    raw = store_or_client.get(RESTART_SCOPE, "stamp")
    if raw is None:
        return None
    try:
        obj = json.loads(raw.decode())
    except (ValueError, UnicodeDecodeError):
        return None
    if isinstance(obj, dict) and "ts" in obj and "epoch" in obj:
        return obj
    return None


def put_dead_hosts(store_or_client, hosts, ranks=()) -> None:
    """Driver side of the dead-set channel: publish the blacklisted/
    quarantined host set into the SERVE scope (key ``dead_hosts`` — a
    non-numeric key, so ``read_announcements`` skips it by
    construction) so the serving Router evicts a dead worker's
    announcement IMMEDIATELY instead of waiting out the freshness
    window. ``ranks`` carries the worker ranks the driver mapped onto
    those hosts at publication time (announcements are keyed by rank;
    the host name is the fallback match)."""
    import time as _time

    payload = {
        "ts": _time.time(),
        "hosts": sorted(str(h) for h in hosts),
        "ranks": sorted(int(r) for r in ranks),
    }
    store_or_client.put(
        "serve", "dead_hosts", json.dumps(payload).encode()
    )


def read_dead_hosts(store_or_client) -> Dict[str, list]:
    """Router side: ``{"hosts": [...], "ranks": [...]}`` — empty lists
    on first launch or a malformed blob (the dead set accelerates
    eviction; a corrupt one must never break routing)."""
    raw = store_or_client.get("serve", "dead_hosts")
    if raw is None:
        return {"hosts": [], "ranks": []}
    try:
        obj = json.loads(raw.decode())
    except (ValueError, UnicodeDecodeError):
        return {"hosts": [], "ranks": []}
    if not isinstance(obj, dict):
        return {"hosts": [], "ranks": []}
    return {
        "hosts": [str(h) for h in obj.get("hosts", ()) or ()],
        "ranks": [
            int(r) for r in obj.get("ranks", ()) or ()
            if isinstance(r, (int, float, str)) and str(r).lstrip("-").isdigit()
        ],
    }


SERVE_SCOPE = "serve"
SERVE_ROLES = ("prefill", "decode", "unified")


def put_announcement(client, rank: int, payload: dict) -> None:
    """A serve worker's capacity blob into the KV (a ``KVStore`` or a
    ``RendezvousClient``), scope ``serve``, key the rank."""
    client.put(SERVE_SCOPE, str(int(rank)), json.dumps(payload).encode())


def read_announcements(store_or_client) -> Dict[int, dict]:
    """Every serve rank's last capacity blob; entries that do not parse,
    or carry no ``port`` (and the non-numeric ``dead_hosts`` key), are
    skipped."""
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


def worker_role(ann: dict) -> str:
    """The role a capacity announcement claims. Blobs of workers that
    announce no ``role`` (older ones) are unified and stay routable, so
    a missing or unknown value reads as ``"unified"``."""
    role = ann.get("role", "unified")
    return role if role in SERVE_ROLES else "unified"


REBALANCE_SCOPE = "rebalance"


def put_rebalance_weights(store_or_client, weights: Dict[int, float],
                          epoch: int = 0) -> None:
    """Driver side of the straggler rebalance (``HOROVOD_REBALANCE``):
    publish the gang's micro-batch weights, ``weights[r]`` in (0, 1]
    (1.0 a full share; less for a rank whose step p50 stays flagged).
    One blob, overwritten on each change: workers apply the newest."""
    import time as _time

    payload = {
        "ts": _time.time(),
        "epoch": int(epoch),
        "weights": {str(int(r)): float(w) for r, w in weights.items()},
    }
    store_or_client.put(REBALANCE_SCOPE, "weights",
                        json.dumps(payload).encode())


def read_rebalance_weights(store_or_client) -> Dict[int, float]:
    """Worker side: ``{rank: weight}`` of the newest published map, or
    ``{}`` when none was published. A malformed blob reads as ``{}``:
    a scheduling hint must never stall training."""
    raw = store_or_client.get(REBALANCE_SCOPE, "weights")
    if raw is None:
        return {}
    try:
        obj = json.loads(raw.decode())
        return {int(r): float(w) for r, w in obj.get("weights", {}).items()}
    except (ValueError, UnicodeDecodeError, AttributeError):
        return {}


EXPERT_LOAD_SCOPE = "expert_load"


def put_expert_load(store_or_client, rank: int, expert_tokens,
                    dropped: float, total: float,
                    capacity_factor: Optional[float] = None) -> None:
    """Worker side of the expert-load ledger: this rank's newest
    kept-token histogram and overflow counters (``parallel/moe.py``'s
    ``MoEStats``, host floats), one key a rank, overwritten on each
    publication."""
    import time as _time

    payload = {
        "ts": _time.time(),
        "expert_tokens": [float(t) for t in expert_tokens],
        "dropped": float(dropped),
        "total": float(total),
    }
    if capacity_factor is not None:
        payload["capacity_factor"] = float(capacity_factor)
    store_or_client.put(EXPERT_LOAD_SCOPE, str(int(rank)),
                        json.dumps(payload).encode())


def read_expert_loads(store_or_client) -> Dict[int, dict]:
    """Driver side: ``{rank: {"ts", "expert_tokens", "dropped", "total",
    ...}}`` of every published summary; malformed entries are
    skipped."""
    out: Dict[int, dict] = {}
    for key in store_or_client.keys(EXPERT_LOAD_SCOPE):
        raw = store_or_client.get(EXPERT_LOAD_SCOPE, key)
        if raw is None:
            continue
        try:
            rank = int(key)
            obj = json.loads(raw.decode())
        except (ValueError, UnicodeDecodeError):
            continue
        if (isinstance(obj, dict)
                and isinstance(obj.get("expert_tokens"), list)
                and "total" in obj):
            out[rank] = obj
    return out


def _client_from_cfg(cfg) -> "RendezvousClient":
    """Shared construction of the worker-side KV client from config
    (secret decode + endpoint) — used by the object collectives and the
    version guard alike."""
    secret = (
        bytes.fromhex(cfg.secret_key_hex) if cfg.secret_key_hex else None
    )
    return RendezvousClient(
        cfg.rendezvous_addr, cfg.rendezvous_port, secret_key=secret
    )


def _versions() -> str:
    """What must agree across a gang: the port's version, torch's and
    the CUDA it was built for."""
    import torch

    from .. import __version__

    return (f"horovod_tpu_torch {__version__} torch {torch.__version__} "
            f"cuda {torch.version.cuda}")


def check_version_consistency(cfg, topology, log=None) -> None:
    """Fail fast when gang members run different versions (the
    reference's driver probes this before launch): every rank publishes
    :func:`_versions` under the elastic epoch's scope and compares it
    with rank 0's. A rank 0 that does not publish in time, or KV
    trouble, only warns; a mismatch raises."""
    if not cfg.rendezvous_addr or not cfg.rendezvous_port:
        return
    mine = _versions()
    client = _client_from_cfg(cfg)
    # one scope an epoch: the KV server outlives the gangs, and a stale
    # entry of an earlier gang would fake a skew or mask one
    scope = f"version.{cfg.elastic_epoch}"
    try:
        client.put(scope, str(topology.rank), mine.encode())
        if topology.rank == 0:
            return
        raw = client.wait(
            scope, "0",
            timeout=min(30.0, float(cfg.gloo_timeout_seconds)),
            should_stop=_poll_shutdown.is_set,
        )
    except TimeoutError:
        if log is not None:
            log.warning(
                "version check: rank 0 did not publish within the "
                "window; skipping (mine: %s)", mine,
            )
        return
    except (OSError, RuntimeError) as e:
        if log is not None:
            log.warning("version check skipped (rendezvous: %s)", e)
        return
    lead = raw.decode()
    if lead != mine:
        raise RuntimeError(
            f"version skew in the gang: rank {topology.rank} runs {mine} "
            f"but rank 0 runs {lead}; install the same versions on every "
            "host"
        )
