"""Request tracing: W3C ``traceparent`` contexts, spans and the span ring
(stdlib only).

The counterpart of ``horovod_tpu/common/tracing.py``. The serving
frontend adopts an incoming ``traceparent`` header (or mints a root
context when ``HOROVOD_TRACE`` is on), and every stage the request
passes opens a child span under it through :func:`start_span`: the
frontend's ``http.generate``, the batcher's ``serve.prefill`` and
``serve.decode``, the engine's ``engine.prefill_chunk``. Ended spans go
into a bounded per-process ring (:class:`SpanRecorder`,
``HOROVOD_TRACE_SPANS``), which ``GET /traces`` serves (on the serve
port and on ``HOROVOD_METRICS_PORT``) and the telemetry hub's
atexit/SIGTERM dump writes beside the flight recorder as
``<flight_recorder>.spans``. Every reply of a traced request echoes
``X-Trace-Id`` and the server's receive/send wall stamps, the edges a
skew-corrected assembly of several hosts' rings feeds on.

Zero cost when off: ``HOROVOD_TRACE`` defaults off and sampling
(``HOROVOD_TRACE_SAMPLE``) is decided once at mint, so every carrier
holds an ``Optional[TraceContext]`` and skips span creation on None.
The settings are read once a process, at the first tracing call
(:func:`_reset` drops them). A disaggregated fleet's KV-transfer hops
(``serving/kv_transfer.py``) echo their stamps as JSON fields
(:func:`json_stamps`), and the sender tags the four NTP stamps onto its
hop span (:func:`tag_hop_fields`; :func:`tag_hop` for header echoes).
"""

from __future__ import annotations

import json
import os
import secrets
import socket
import threading
import time
from collections import deque
from typing import Dict, List, Optional

DEFAULT_SPAN_RING = 2048

TRACEPARENT_HEADER = "traceparent"
TRACE_ID_HEADER = "X-Trace-Id"
# hop skew stamps: servers echo their recv/send wall clocks + identity
# so clients can tag the NTP edge onto their hop span
TS_RECV_HEADER = "X-Trace-Ts-Recv"
TS_SEND_HEADER = "X-Trace-Ts-Send"
PEER_HEADER = "X-Trace-Peer"


class TraceContext:
    """trace_id / span_id pair in W3C trace-context shape.

    ``span_id`` is the id of the span this context BELONGS to — a child
    span minted under it uses it as ``parent_id``. ``sampled`` is the
    root's coin flip, inherited by every descendant so a trace is
    all-or-nothing across the fleet.
    """

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = bool(sampled)

    def to_traceparent(self) -> str:
        flag = "01" if self.sampled else "00"
        return f"00-{self.trace_id}-{self.span_id}-{flag}"

    def to_dict(self) -> Dict[str, object]:
        """Wire form for JSON payloads (kv_transfer meta frames,
        migrate records)."""
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "sampled": self.sampled,
        }

    @classmethod
    def from_dict(cls, d) -> Optional["TraceContext"]:
        if not isinstance(d, dict):
            return None
        tid = d.get("trace_id")
        sid = d.get("span_id")
        if not tid or not sid:
            return None
        return cls(str(tid), str(sid), bool(d.get("sampled", True)))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TraceContext({self.to_traceparent()})"


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """``00-{32 hex}-{16 hex}-{flags}`` → context; None on anything
    malformed (a bad header must never fail a request)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16)
        int(span_id, 16)
        sampled = bool(int(flags, 16) & 1)
    except ValueError:
        return None
    if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
        return None
    return TraceContext(trace_id.lower(), span_id.lower(), sampled)


def _new_trace_id() -> str:
    return secrets.token_hex(16)


def _new_span_id() -> str:
    return secrets.token_hex(8)


# ------------------------------------------------------------------ spans

_tls = threading.local()


class Span:
    """One timed operation on one worker.

    Two monotonic stamps and a dict: ``begin`` records epoch + monotonic
    start, ``end`` closes the duration and appends the record to the
    process ring. Usable as a context manager (pushes itself onto the
    thread-local active stack so RetryPolicy can annotate the hop it is
    retrying under), or held across threads and ended manually.
    """

    __slots__ = (
        "name", "ctx", "parent_id", "tags", "ts", "_t0", "_done",
    )

    def __init__(
        self,
        name: str,
        ctx: TraceContext,
        parent_id: Optional[str],
        tags: Optional[dict] = None,
    ) -> None:
        self.name = name
        self.ctx = ctx  # ctx.span_id is THIS span's id
        self.parent_id = parent_id
        self.tags = dict(tags) if tags else {}
        self.ts = time.time()
        self._t0 = time.monotonic()
        self._done = False

    def annotate(self, note: str) -> None:
        """Append a breadcrumb (the retry ladder's site#attempt@backoff
        entries) without touching timing."""
        notes = self.tags.setdefault("notes", [])
        if len(notes) < 64:  # bounded — a hot retry loop can't balloon a span
            notes.append(note)

    def tag(self, **kv) -> None:
        self.tags.update(kv)

    def end(self, **kv) -> None:
        if self._done:
            return
        self._done = True
        if kv:
            self.tags.update(kv)
        dur_ms = (time.monotonic() - self._t0) * 1e3
        recorder().record(
            {
                "trace_id": self.ctx.trace_id,
                "span_id": self.ctx.span_id,
                "parent_id": self.parent_id,
                "name": self.name,
                "ts": self.ts,
                "dur_ms": round(dur_ms, 3),
                "tags": self.tags,
            }
        )

    # -- thread-local active-span stack (for retry annotations) --

    def __enter__(self) -> "Span":
        push_active(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pop_active(self)
        if exc_type is not None and "outcome" not in self.tags:
            self.tags["outcome"] = "error"
            self.tags["error"] = f"{exc_type.__name__}: {exc}"
        self.end()


def push_active(span: Span) -> None:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(span)


def pop_active(span: Span) -> None:
    stack = getattr(_tls, "stack", None)
    if stack and stack[-1] is span:
        stack.pop()
    elif stack and span in stack:  # out-of-order end: drop it anyway
        stack.remove(span)


def current() -> Optional[Span]:
    """The innermost active span on THIS thread (None when tracing is
    off or no span is open) — the retry ladder's annotation target."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def annotate(note: str) -> None:
    """Annotate the active span, if any — safe to call unconditionally
    (the no-trace path is one thread-local read)."""
    span = current()
    if span is not None:
        span.annotate(note)


class active(object):
    """Context manager adopting an existing span as this thread's active
    span without owning its lifetime (the KV-transfer handoff thread
    runs under its stream span, so retry annotations and hop stamps land
    on it)."""

    __slots__ = ("_span",)

    def __init__(self, span: Optional[Span]) -> None:
        self._span = span

    def __enter__(self):
        if self._span is not None:
            push_active(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._span is not None:
            pop_active(self._span)


# -------------------------------------------------------------- recorder


class SpanRecorder:
    """Bounded per-process span ring beside the StepStats ring.

    ``deque(maxlen=N)`` appends are atomic under the GIL, so concurrent
    emitters never grow past the bound; the lock only guards reads and
    reconfiguration. Drained by the telemetry hub's atexit/SIGTERM dump
    into ``<flight_recorder>.spans``.
    """

    def __init__(self, capacity: int = DEFAULT_SPAN_RING) -> None:
        self.capacity = max(int(capacity), 1)
        self._ring: "deque" = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.host = socket.gethostname()
        self.pid = os.getpid()
        self.role = ""

    def configure(
        self, capacity: Optional[int] = None, role: Optional[str] = None
    ) -> None:
        with self._lock:
            if capacity is not None and int(capacity) != self.capacity:
                self.capacity = max(int(capacity), 1)
                self._ring = deque(self._ring, maxlen=self.capacity)
            if role is not None:
                self.role = role

    def record(self, span_rec: dict) -> None:
        span_rec.setdefault("host", self.host)
        span_rec.setdefault("pid", self.pid)
        if self.role:
            span_rec.setdefault("role", self.role)
        self._ring.append(span_rec)  # atomic; no lock on the emit path

    def spans(self) -> List[dict]:
        with self._lock:
            for _ in range(3):
                try:
                    return [dict(r) for r in list(self._ring)]
                except RuntimeError:  # mutated during iteration
                    continue
            return []

    def __len__(self) -> int:
        return len(self._ring)

    def dump(self, path: str) -> Optional[str]:
        """JSON-lines, oldest first, tmp+rename (same crash discipline
        as the flight recorder)."""
        spans = self.spans()
        if not spans:
            return None
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            for rec in spans:
                f.write(json.dumps(rec) + "\n")
        os.replace(tmp, path)
        return path


# ------------------------------------------------------------- singleton

_recorder: Optional[SpanRecorder] = None
_rec_lock = threading.Lock()
# settings cache: (enabled, sample) — resolved once, reset by tests
_settings: Optional[tuple] = None


def _load_settings() -> tuple:
    global _settings
    cached = _settings
    if cached is not None:
        return cached
    from . import basics

    cfg = basics.live_config()
    _settings = (bool(cfg.trace), float(cfg.trace_sample))
    return _settings


def recorder() -> SpanRecorder:
    global _recorder
    with _rec_lock:
        if _recorder is None:
            from . import basics

            cfg = basics.live_config()
            _recorder = SpanRecorder(capacity=cfg.trace_spans)
        return _recorder


def set_role(role: str) -> None:
    """Stamp this process's serving role (prefill/decode/unified/…)
    onto every span it records — the assembler's row key."""
    recorder().configure(role=role)


def _reset() -> None:
    """Test hook: drop the recorder + settings cache so the next call
    re-reads config."""
    global _recorder, _settings
    with _rec_lock:
        _recorder = None
        _settings = None


def enabled() -> bool:
    return _load_settings()[0]


def mint(sampled: Optional[bool] = None) -> Optional[TraceContext]:
    """Mint a ROOT context, deciding sampling once for the whole trace.
    None when tracing is off or the coin came up tails — callers treat
    None as 'no tracing for this request' everywhere downstream."""
    on, sample = _load_settings()
    if not on:
        return None
    if sampled is None:
        if sample >= 1.0:
            sampled = True
        elif sample <= 0.0:
            sampled = False
        else:
            # secrets over random: no seed-correlation with user code
            sampled = secrets.randbelow(1_000_000) < sample * 1_000_000
    if not sampled:
        return None
    return TraceContext(_new_trace_id(), _new_span_id(), True)


def adopt(header: Optional[str]) -> Optional[TraceContext]:
    """Adopt an incoming traceparent header (or mint, when absent and
    tracing is on). The caller's sampling decision wins: an explicit
    sampled=0 header stays untraced."""
    if not enabled():
        return None
    ctx = parse_traceparent(header)
    if ctx is not None:
        return ctx if ctx.sampled else None
    return mint()


def start_span(
    name: str,
    parent: Optional[TraceContext],
    **tags,
) -> Optional[Span]:
    """Child span under ``parent``; None propagates (untraced request
    ⇒ no span, no cost). The returned span's ``.ctx`` is the context to
    hand the NEXT hop."""
    if parent is None or not parent.sampled:
        return None
    child = TraceContext(parent.trace_id, _new_span_id(), True)
    return Span(name, child, parent.span_id, tags)


def root_span(name: str, ctx: Optional[TraceContext], **tags):
    """The span a freshly-minted context BELONGS to (parent None) —
    the route/request root every leg hangs off. None propagates."""
    if ctx is None or not ctx.sampled:
        return None
    return Span(name, ctx, None, tags)


def server_stamps(peer_recv_ts: float) -> Dict[str, str]:
    """Headers a server echoes so the client can skew-correct this hop:
    its recv/send wall stamps and its process identity."""
    rec = recorder()
    return {
        TS_RECV_HEADER: f"{peer_recv_ts:.6f}",
        TS_SEND_HEADER: f"{time.time():.6f}",
        PEER_HEADER: f"{rec.host}:{rec.pid}",
    }


def json_stamps(peer_recv_ts: float) -> Dict[str, object]:
    """The :func:`server_stamps` echo for JSON-body protocols (the
    KV-transfer replies carry the stamps as fields, not headers)."""
    rec = recorder()
    return {
        "recv_ts": round(peer_recv_ts, 6),
        "send_ts": round(time.time(), 6),
        "peer": f"{rec.host}:{rec.pid}",
    }


def tag_hop_fields(
    span: Optional[Span], t_send: float, t_recv: float, obj
) -> None:
    """:func:`tag_hop` for JSON-body echoes: the peer's stamps arrive as
    ``recv_ts``/``send_ts``/``peer`` fields of the reply object."""
    if span is None or not isinstance(obj, dict):
        return
    peer_recv = obj.get("recv_ts")
    peer_send = obj.get("send_ts")
    if peer_recv is None or peer_send is None:
        return
    try:
        span.tag(
            t_send=round(t_send, 6),
            t_recv=round(t_recv, 6),
            peer_recv=round(float(peer_recv), 6),
            peer_send=round(float(peer_send), 6),
            peer=str(obj.get("peer", "")),
        )
    except (TypeError, ValueError):
        pass


def tag_hop(span: Optional[Span], t_send: float, t_recv: float,
            headers) -> None:
    """Tag the four NTP stamps and the peer's identity onto a client
    hop span from the server's echo headers (a no-op without an echo or
    a span)."""
    if span is None or headers is None:
        return
    try:
        peer_recv = headers.get(TS_RECV_HEADER)
        peer_send = headers.get(TS_SEND_HEADER)
        peer = headers.get(PEER_HEADER)
    except AttributeError:
        return
    if not peer_recv or not peer_send:
        return
    try:
        span.tag(
            t_send=round(t_send, 6),
            t_recv=round(t_recv, 6),
            peer_recv=round(float(peer_recv), 6),
            peer_send=round(float(peer_send), 6),
            peer=peer or "",
        )
    except (TypeError, ValueError):
        pass
