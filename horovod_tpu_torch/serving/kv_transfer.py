"""Streamed KV-page transfer: the disaggregated fleet's wire.

The counterpart of ``horovod_tpu/serving/kv_transfer.py`` (its live
migration, the ``migrate`` frame, comes in a later slice). In a
role-split fleet a *prefill* worker runs the chunked prefill into its own
page pool, then ships the finished pages to a *decode* worker, where the
request enters continuous batching with its page table rebuilt by
pointer (``engine.ingest_attach``). A long prompt's prefill therefore
never runs on the worker that holds in-flight decode streams.

Wire format (``HOROVOD_SERVE_KV_WIRE``): ``int8`` (the default) sends
block-scaled int8 pages at about a quarter of the pool's bytes, ``fp32``
the pool dtype's own bytes (lossless: a transferred decode equals a
unified worker's), ``bf16`` between. The frames' meta and layout are the
JAX codec's, and an fp32 or bf16 frame is byte for byte what the JAX
package sends. The int8 codec quantizes with kernel B3
(``hvd_torch::int8_block_quantize``, ``rows=True``: a page a row, so no
block straddles a page; the block is the largest divisor of the page's
elements up to 512, :func:`wire_block_size`) on the device that holds
the gathered pages, then copies values and scales to the host once. The
tail page's rows at and past the sequence's length are zeroed before
(``engine.finish_pages``): a zero never raises a block's absmax. Its
rounding is stochastic from Philox where the JAX codec draws from
``jax.random``, so the two agree on the scales bit for bit and on each
value within one quantum, never value for value. Dequantizing is plain
PyTorch, as the JAX codec's is plain ``jnp``.

Transport is stdlib HTTP. The decode worker runs a
:class:`KVTransferServer` on ``HOROVOD_SERVE_TRANSFER_PORT``, announced
through the capacity blobs (``frontend.put_announcement``):

* ``POST /kv/reserve``: pages promised against the worker's admission
  headroom with a TTL, before the sender spends a prefill;
* ``POST /kv/ingest``: the framed pages; admits the request into the
  decode batcher and replies its id at once (idempotent by the sender's
  request id, so a retried stream never admits twice);
* ``GET /kv/result``: a long poll for the finished decode.

The sender (:class:`TransferCoordinator`, driven by the prefill
batcher) picks the least-loaded announced decode worker, reserves,
streams under a ``RetryPolicy`` with the ``serve.kv_transfer`` fault
site fired on every attempt, and on exhaustion falls back to decoding
locally (``serve.transfer_fallbacks``): a transfer outage degrades to a
unified worker, it never errors the request.
"""

from __future__ import annotations

import json
import math
import struct
import threading
import time
import uuid
from contextlib import nullcontext
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common import tracing as _tracing
from ..common.config import live_config
from ..common.logging import get_logger
from ..common.metrics import registry as _metrics
from ..common.retry import RetryPolicy
from ..ops.cuda_kernels import int8_block_dequantize, int8_block_quantize
from ..testing import chaos as _chaos

_log = get_logger("serve.kv_transfer")

CHAOS_SITE = "serve.kv_transfer"
WIRE_FORMATS = ("fp32", "bf16", "int8")
# the int8 block cap: clamped down to a divisor of the page's elements,
# so a scale never spans two pages
DEFAULT_WIRE_BLOCK = 512
DEFAULT_RESERVATION_TTL_S = 30.0
DEFAULT_RESULT_TIMEOUT_S = 300.0
# the pool dtypes a frame names, by the JAX codec's numpy names
DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.float16: "float16", torch.float64: "float64"}
NAME_DTYPES = {v: k for k, v in DTYPE_NAMES.items()}


def wire_block_size(page_elems: int, cap: int = DEFAULT_WIRE_BLOCK) -> int:
    """Largest block size up to ``cap`` that divides the page's element
    count: blocks tile pages exactly, so no scale mixes two pages (and
    none mixes k with v or one layer with another: each leaf is
    quantized apart)."""
    if page_elems <= cap:
        return page_elems
    for b in range(cap, 0, -1):
        if page_elems % b == 0:
            return b
    return 1


def worker_role(ann: dict) -> str:
    """The role a capacity announcement claims. Blobs of workers that
    announce no ``role`` (older ones) are unified and stay routable, so
    a missing or unknown value reads as ``"unified"``."""
    role = ann.get("role", "unified")
    return role if role in ("prefill", "decode", "unified") else "unified"


# ------------------------------------------------------------ pack/unpack


def _as_tensor(arr) -> torch.Tensor:
    if isinstance(arr, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(arr))
    return arr


def pack_pages(engine, kept, length: int, *, wire: str = "int8",
               seed: int = 0) -> Tuple[dict, bytes]:
    """Serialize a detached slot's pages for the wire (gathered, zeroed
    past ``length`` and packed in one call)."""
    raw = engine.gather_pages(kept)
    return pack_raw_pages(
        engine.finish_pages(raw, kept, length), [lp for lp, _ in kept],
        length, page_tokens=engine.manager.page_tokens, wire=wire,
        seed=seed,
    )


def pack_raw_pages(
    raw, logical: List[int], length: int, *,
    page_tokens: int, wire: str = "int8", seed: int = 0,
) -> Tuple[dict, bytes]:
    """``(meta, blob)`` of per-leaf pages ``raw`` (``[n_pages,
    page_tokens, kv_heads, head_dim]`` tensors on any device, or numpy
    arrays): ``meta`` the JSON frame header (wire, length, page geometry,
    a segment a leaf), ``blob`` the leaves' payloads back to back (int8
    values then fp32 block scales, or bf16 or the pool dtype's bytes).
    The payload is assembled on the pages' device and copied to the
    host once."""
    if wire not in WIRE_FORMATS:
        raise ValueError(f"wire must be one of {WIRE_FORMATS}, got {wire!r}")
    segments = []
    parts: List[torch.Tensor] = []
    for arr in raw:
        t = _as_tensor(arr)
        if t.dtype not in DTYPE_NAMES:
            raise ValueError(f"pages of dtype {t.dtype} cannot travel")
        seg: Dict[str, object] = {"shape": list(t.shape),
                                  "dtype": DTYPE_NAMES[t.dtype]}
        if wire == "int8":
            n_pages = t.shape[0]
            page_elems = math.prod(t.shape[1:])
            block = wire_block_size(page_elems)
            vals, scales = int8_block_quantize(
                t.reshape(n_pages, page_elems), block_size=block,
                seed=seed, rows=True,
            )
            seg["block"] = block
            seg["nscales"] = int(scales.numel())
            parts.append(vals.reshape(-1).view(torch.uint8))
            parts.append(scales.reshape(-1).view(torch.uint8))
        elif wire == "bf16":
            parts.append(t.to(torch.bfloat16).contiguous().reshape(-1)
                         .view(torch.uint8))
        else:  # fp32: the pool dtype's bytes, lossless
            parts.append(t.contiguous().reshape(-1).view(torch.uint8))
        segments.append(seg)
    meta = {
        "wire": wire,
        "length": int(length),
        "page_tokens": int(page_tokens),
        "pages": [int(lp) for lp in logical],
        "segments": segments,
    }
    blob = torch.cat(parts).cpu().numpy().tobytes() if parts else b""
    return meta, blob


def _take(buf: torch.Tensor, off: int, nbytes: int,
          dtype: torch.dtype) -> torch.Tensor:
    return buf[off:off + nbytes].clone().view(dtype)


def unpack_pages(meta: dict, blob: bytes) -> List[torch.Tensor]:
    """Inverse of :func:`pack_raw_pages`: per-leaf CPU tensors in the
    pool dtype, pad rows exact zeros (a zero quantizes and dequantizes to
    zero)."""
    wire = meta["wire"]
    buf = torch.frombuffer(bytearray(blob), dtype=torch.uint8) if blob \
        else torch.empty(0, dtype=torch.uint8)
    out: List[torch.Tensor] = []
    off = 0
    for seg in meta["segments"]:
        shape = tuple(int(x) for x in seg["shape"])
        dtype = NAME_DTYPES[seg["dtype"]]
        n = math.prod(shape)
        if wire == "int8":
            rows = shape[0]
            vals = _take(buf, off, n, torch.int8).reshape(rows, n // rows)
            off += n
            nscales = int(seg["nscales"])
            scales = _take(buf, off, 4 * nscales, torch.float32)
            off += 4 * nscales
            arr = int8_block_dequantize(
                vals, scales.reshape(rows, -1), block_size=int(seg["block"]),
                out_dtype=dtype,
            ).reshape(shape)
        elif wire == "bf16":
            arr = _take(buf, off, 2 * n, torch.bfloat16).reshape(
                shape).to(dtype)
            off += 2 * n
        else:
            size = torch.empty(0, dtype=dtype).element_size()
            arr = _take(buf, off, n * size, dtype).reshape(shape)
            off += n * size
        out.append(arr)
    return out


def frame(meta: dict, blob: bytes) -> bytes:
    """One HTTP body: a 4-byte big-endian header length, the JSON
    header, the raw payload."""
    head = json.dumps(meta).encode()
    return struct.pack(">I", len(head)) + head + blob


def unframe(body: bytes) -> Tuple[dict, bytes]:
    if len(body) < 4:
        raise ValueError("transfer frame too short")
    (hlen,) = struct.unpack(">I", body[:4])
    if len(body) < 4 + hlen:
        raise ValueError("transfer frame truncated")
    meta = json.loads(body[4:4 + hlen].decode())
    return meta, body[4 + hlen:]


# -------------------------------------------------------- receiver (decode)


class KVTransferServer:
    """The decode worker's ingest endpoint: a stdlib
    ``ThreadingHTTPServer`` owning the reservation ledger and the rid →
    request table. The HTTP threads only parse, dequantize (on the host)
    and enqueue; every write into the pool happens at admission, on the
    batcher's scheduler thread."""

    def __init__(self, batcher, port: int = 0, addr: str = "0.0.0.0",
                 reservation_ttl_s: float = DEFAULT_RESERVATION_TTL_S
                 ) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.batcher = batcher
        self._ttl = float(reservation_ttl_s)
        self._lock = threading.Lock()
        self._reservations: Dict[str, Tuple[int, float]] = {}
        self._by_request: Dict[str, str] = {}  # sender request id -> rid
        self._results: Dict[str, object] = {}  # rid -> batcher Request
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                _log.debug("kv_transfer http " + fmt, *args)

            def _json(self, code, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                recv_ts = time.time()
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length) if length else b""
                path = self.path.split("?", 1)[0]
                if path == "/kv/reserve":
                    code, obj = outer._handle_reserve(body)
                elif path == "/kv/ingest":
                    code, obj = outer._handle_ingest(body)
                else:
                    code, obj = 404, {"error": "not found"}
                # every reply is an NTP edge for the trace assembler
                obj.update(_tracing.json_stamps(recv_ts))
                return self._json(code, obj)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path == "/kv/result":
                    params = dict(kv.split("=", 1)
                                  for kv in query.split("&") if "=" in kv)
                    return self._json(*outer._handle_result(params))
                return self._json(404, {"error": "not found"})

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._httpd = _Server((addr, port), _Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> int:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="hvd-kv-transfer",
                daemon=True,
            )
            self._thread.start()
        return self.port

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # ------------------------------------------------------- reservations

    def reserved_pages(self) -> int:
        """Unexpired reserved pages: debited from the announced capacity,
        so two senders are never promised the same headroom between
        announcements."""
        now = time.monotonic()
        with self._lock:
            for rid in [r for r, (_, exp) in self._reservations.items()
                        if exp < now]:
                del self._reservations[rid]
            return sum(p for p, _ in self._reservations.values())

    def _handle_reserve(self, body: bytes):
        try:
            payload = json.loads(body or b"{}")
            pages = int(payload["pages"])
        except (ValueError, KeyError, TypeError):
            return 400, {"error": "bad reserve request"}
        span = _tracing.start_span(
            "kv.reserve", _tracing.TraceContext.from_dict(payload.get("trace")),
            pages=pages,
        )
        if self.batcher.draining:
            if span is not None:
                span.end(outcome="draining")
            return 503, {"error": "draining"}
        mgr = self.batcher.engine.manager
        headroom = mgr.admission_headroom() - self.reserved_pages()
        if pages > headroom:
            _metrics.counter("serve.transfer_reserve_denied")
            if span is not None:
                span.end(outcome="denied", free=headroom)
            return 503, {"error": "no decode capacity", "free": headroom}
        rid = uuid.uuid4().hex
        with self._lock:
            self._reservations[rid] = (pages, time.monotonic() + self._ttl)
        _metrics.counter("serve.transfer_reservations")
        if span is not None:
            span.end(outcome="ok")
        return 200, {"reservation": rid, "pages": pages}

    # -------------------------------------------------------------- ingest

    def _handle_ingest(self, body: bytes):
        try:
            meta, blob = unframe(body)
        except (ValueError, json.JSONDecodeError) as e:
            return 400, {"error": f"bad transfer frame: {e}"}
        request_id = str(meta.get("request_id", ""))
        tctx = _tracing.TraceContext.from_dict(meta.get("trace"))
        span = _tracing.start_span("kv.ingest", tctx,
                                   pages=len(meta.get("pages", ())))
        with self._lock:
            rid = self._by_request.get(request_id)
            if rid is not None:
                # a stream retried after a mid-flight reset: the first
                # frame already admitted it
                if span is not None:
                    span.end(outcome="duplicate")
                return 200, {"rid": rid, "duplicate": True}
            if meta.get("reservation"):
                self._reservations.pop(meta["reservation"], None)
        if self.batcher.draining:
            if span is not None:
                span.end(outcome="draining")
            return 503, {"error": "draining"}
        try:
            arrays = unpack_pages(meta, blob)
            req = self.batcher.submit_ingested(
                prompt=meta.get("prompt", ()),
                first_token=int(meta["first_token"]),
                max_new_tokens=int(meta["max_new_tokens"]),
                deadline_ms=meta.get("deadline_ms"),
                logical=meta["pages"],
                arrays=arrays,
                length=int(meta["length"]),
                hashes=[bytes.fromhex(h) for h in meta.get("hashes", ())],
                temperature=float(meta.get("temperature", 0.0)),
                top_k=int(meta.get("top_k", 0)),
                seed=meta.get("seed"),
                trace=span.ctx if span is not None else tctx,
            )
        except Exception as e:  # Rejected, malformed frames
            _log.warning("kv transfer ingest rejected: %s", e)
            if span is not None:
                span.end(outcome="error", error=str(e))
            return 503, {"error": str(e)}
        rid = uuid.uuid4().hex
        with self._lock:
            if request_id:
                self._by_request[request_id] = rid
            self._results[rid] = req
        _metrics.counter("serve.kv_transfer_bytes_in", len(body))
        _metrics.counter("serve.kv_transfer_pages_in", len(meta["pages"]))
        if span is not None:
            span.end(outcome="ok", bytes=len(body))
        return 200, {"rid": rid}

    def _handle_result(self, params: dict):
        rid = params.get("rid", "")
        with self._lock:
            req = self._results.get(rid)
        if req is None:
            return 404, {"error": f"unknown rid {rid!r}"}
        timeout = float(params.get("timeout", 30.0))
        if not req.wait(timeout=timeout):
            return 202, {"done": False}
        with self._lock:
            self._results.pop(rid, None)
            for k, v in list(self._by_request.items()):
                if v == rid:
                    del self._by_request[k]
        return 200, dict(req.result(), done=True)


# --------------------------------------------------------- sender (prefill)


class TransferCoordinator:
    """The prefill worker's side: the choice of decode target, the
    reservation before the prefill runs, and the retried page stream.
    The scheduler thread reserves and gathers the pages on the device;
    one short-lived handoff thread a request finishes them, packs them
    (on the device, on a stream of its own, after the gather's event)
    and streams them."""

    def __init__(
        self,
        engine,
        *,
        client=None,
        client_factory=None,
        wire: Optional[str] = None,
        retry: Optional[RetryPolicy] = None,
        reserve_timeout_s: float = 5.0,
        result_timeout_s: float = DEFAULT_RESULT_TIMEOUT_S,
    ) -> None:
        self.engine = engine
        self.wire = live_config().serve_kv_wire if wire is None else str(wire)
        if self.wire not in WIRE_FORMATS:
            raise ValueError(
                f"kv wire must be one of {WIRE_FORMATS}, got {self.wire!r}"
            )
        self._client = client
        self._client_factory = client_factory
        self._retry = retry or RetryPolicy.from_env(CHAOS_SITE)
        self._reserve_timeout = float(reserve_timeout_s)
        self._result_timeout = float(result_timeout_s)
        self._lock = threading.Lock()
        # pages reserved on each decode rank and not yet reflected in its
        # announcements
        self._debits: Dict[int, int] = {}
        self._stream_dev = None

    # ------------------------------------------------------------- targets

    def _resolve_client(self):
        if self._client is None and self._client_factory is not None:
            self._client = self._client_factory()
        return self._client

    def decode_targets(self, exclude=(), roles=("decode",)) -> List[dict]:
        """Announced transfer-capable workers of the wanted ``roles``,
        the least loaded first (announced page headroom less this
        sender's reservations on them)."""
        from .frontend import read_announcements

        client = self._resolve_client()
        if client is None:
            return []
        try:
            anns = read_announcements(client)
        except (OSError, RuntimeError):
            return []
        with self._lock:
            debits = dict(self._debits)

        def load(item):
            rank, ann = item
            free = int(ann.get("free_pages", ann.get("free_slots", 0)))
            return (-(free - debits.get(rank, 0)), rank)

        return [
            dict(ann, rank=rank)
            for rank, ann in sorted(anns.items(), key=load)
            if worker_role(ann) in roles
            and not ann.get("draining")
            and ann.get("transfer_port")
            and rank not in exclude
        ]

    # ------------------------------------------------------------- reserve

    def reserve(self, pages: int, roles=("decode",),
                trace=None) -> Optional[dict]:
        """Reserve ``pages`` on the best decode worker, failing over
        across candidates within the call; None when no decode capacity
        exists anywhere (the sender's cue to decode locally). ``trace``
        rides the body, so the receiver's decision lands in the same
        trace, and the reply's stamps are an NTP edge."""
        import urllib.error
        import urllib.request

        span = _tracing.start_span("kv.reserve", trace, pages=int(pages))
        failed: set = set()
        for _ in range(4):
            targets = self.decode_targets(exclude=failed, roles=roles)
            if not targets:
                if span is not None:
                    span.end(outcome="no_target")
                return None
            ann = targets[0]
            url = (f"http://{ann.get('addr', '127.0.0.1')}"
                   f":{ann['transfer_port']}/kv/reserve")
            payload: dict = {"pages": int(pages)}
            if span is not None:
                payload["trace"] = span.ctx.to_dict()
            try:
                req = urllib.request.Request(
                    url, data=json.dumps(payload).encode(), method="POST",
                    headers={"Content-Type": "application/json"},
                )
                t_send = time.time()
                with urllib.request.urlopen(
                        req, timeout=self._reserve_timeout) as resp:
                    out = json.loads(resp.read().decode())
                _tracing.tag_hop_fields(span, t_send, time.time(), out)
            except (OSError, ValueError, urllib.error.HTTPError) as e:
                _log.debug("reserve on rank %s failed: %s",
                           ann.get("rank"), e)
                if span is not None:
                    span.annotate(f"rank{ann.get('rank')}:{e}")
                failed.add(ann["rank"])
                continue
            with self._lock:
                self._debits[ann["rank"]] = (
                    self._debits.get(ann["rank"], 0) + int(pages))
            if span is not None:
                span.end(outcome="ok", rank=int(ann["rank"]))
            return {
                "rank": ann["rank"],
                "addr": ann.get("addr", "127.0.0.1"),
                "port": int(ann["transfer_port"]),
                "rid": out["reservation"],
                "pages": int(pages),
            }
        if span is not None:
            span.end(outcome="exhausted")
        return None

    def _credit(self, reservation: dict) -> None:
        with self._lock:
            rank = reservation["rank"]
            left = self._debits.get(rank, 0) - reservation["pages"]
            if left > 0:
                self._debits[rank] = left
            else:
                self._debits.pop(rank, None)

    # ------------------------------------------------------------- handoff

    def start_handoff(self, batcher, req, kept, length: int,
                      reservation: dict) -> None:
        """Scheduler-thread entry: only the device gather runs here
        (``engine.gather_pages``: fresh buffers, an event after them);
        packing, the host copy and HTTP run on the handoff thread, so an
        in-flight transfer never stalls the scheduler's rounds."""
        raw = self.engine.gather_pages(kept)
        threading.Thread(
            target=self._stream,
            args=(batcher, req, kept, length, reservation, raw),
            name=f"hvd-kv-handoff-{req.id}",
            daemon=True,
        ).start()

    def _side_stream(self):
        """The handoff threads' CUDA stream (None off the card)."""
        dev = self.engine.device
        if dev.type != "cuda":
            return None
        with self._lock:
            if self._stream_dev is None:
                self._stream_dev = torch.cuda.Stream(dev)
            return self._stream_dev

    def pack(self, raw, kept, length: int, seed: int) -> Tuple[dict, bytes]:
        """The gathered pages as a frame's ``(meta, blob)``: finished on
        the handoff stream once the gather's event has passed, then
        packed (B3 on the card for the int8 wire) and copied to the host
        once."""
        stream = self._side_stream()
        pages = self.engine.finish_pages(raw, kept, length, stream=stream)
        with (torch.cuda.stream(stream) if stream is not None
              else nullcontext()):
            return pack_raw_pages(
                pages, [lp for lp, _ in kept], length,
                page_tokens=self.engine.manager.page_tokens,
                wire=self.wire, seed=seed,
            )

    def _post(self, url: str, body: bytes, timeout: float) -> dict:
        """One HTTP attempt with the fault site fired first (the
        RetryPolicy's unit of work): 5xx, 429 and transport faults raise
        retryably; any other 4xx is the frame's own fault and surfaces
        at once."""
        import urllib.error
        import urllib.request

        _chaos.inject(CHAOS_SITE)
        req = urllib.request.Request(
            url, data=body, method="POST",
            headers={"Content-Type": "application/octet-stream"},
        )
        try:
            t_send = time.time()
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                out = json.loads(resp.read().decode())
            # this attempt's NTP stamps onto the stream span the handoff
            # thread runs under; the last successful attempt's edge wins
            _tracing.tag_hop_fields(_tracing.current(), t_send, time.time(),
                                    out)
            return out
        except urllib.error.HTTPError as e:
            if e.code == 429 or 500 <= e.code <= 599:
                raise OSError(f"transfer target HTTP {e.code}") from e
            raise RuntimeError(f"transfer rejected (HTTP {e.code})") from e

    def _stream(self, batcher, req, kept, length, reservation, raw):
        from .paged_kv import page_hashes

        base = f"http://{reservation['addr']}:{reservation['port']}"
        t0 = time.perf_counter()
        # the handoff thread runs under the stream span, so retry
        # annotations and _post's hop stamps land on it; the receiver's
        # kv.ingest span hangs off meta["trace"]
        span = _tracing.start_span(
            "kv.stream", getattr(req, "trace", None),
            rank=int(reservation.get("rank", -1)), pages=len(kept),
            wire=self.wire,
        )
        try:
            # outside the wire's fallback: a kernel that fails here fails
            # the request and raises, it never decodes locally
            if self.engine.device.type == "cuda":
                torch.cuda.set_device(self.engine.device)
            with _tracing.active(span):
                meta, blob = self.pack(raw, kept, length, seed=req.id)
        except Exception as e:
            if span is not None:
                span.end(outcome="error", error=f"{type(e).__name__}: {e}")
            self._credit(reservation)
            batcher.fail_handoff(req, kept)
            raise
        del raw
        try:
            with _tracing.active(span):
                remaining_ms = None
                if req.deadline_ts is not None:
                    remaining_ms = max(
                        (req.deadline_ts - time.monotonic()) * 1e3, 1.0)
                meta.update(
                    request_id=f"{id(self)}-{req.id}",
                    reservation=reservation["rid"],
                    prompt=[int(t) for t in req.prompt],
                    first_token=int(req.out_tokens[-1]),
                    max_new_tokens=int(req.max_new_tokens),
                    deadline_ms=remaining_ms,
                    # the sampling knobs travel; the seed is resolved here
                    # (the request id when unpinned), so the decode
                    # worker draws what a local decode would have
                    temperature=float(req.temperature),
                    top_k=int(req.top_k),
                    seed=int(req.id if req.seed is None else req.seed),
                    hashes=[h.hex() for h in page_hashes(
                        req.prompt, self.engine.manager.page_tokens)],
                )
                if span is not None:
                    meta["trace"] = span.ctx.to_dict()
                body = frame(meta, blob)
                out = self._retry.call(
                    self._post, base + "/kv/ingest", body,
                    self._retry.attempt_timeout_s, peer=base,
                )
            transfer_ms = (time.perf_counter() - t0) * 1e3
            _metrics.counter("serve.kv_transfer_bytes", len(body))
            _metrics.counter("serve.kv_transfer_pages", len(kept))
            _metrics.counter("serve.kv_transfer_ms", transfer_ms)
            _metrics.counter("serve.transfers")
            if span is not None:
                # pack and stream, not the remote decode: the receiver's
                # spans take the story from here
                span.end(outcome="ok", bytes=len(body),
                         transfer_ms=round(transfer_ms, 3))
            result = self._await_result(base, out["rid"])
        except Exception as e:  # any wire failure falls back
            _log.warning(
                "kv transfer of request %d to rank %s failed (%s); "
                "falling back to local decode", req.id,
                reservation.get("rank"), e,
            )
            if span is not None:
                span.end(outcome="fallback",
                         error=f"{type(e).__name__}: {e}")
            self._credit(reservation)
            batcher.requeue_fallback(req, kept, length)
            return
        self._credit(reservation)
        if result.get("status") not in ("done", "deadline"):
            _log.warning(
                "decode worker returned status %r for request %d; "
                "falling back to local decode", result.get("status"), req.id,
            )
            batcher.requeue_fallback(req, kept, length)
            return
        # the remote decode finished: the local page holds can go (the
        # prefix index may still hold published pages)
        self.engine.manager.release_kept(kept)
        batcher.complete_handoff(req, result)

    def _await_result(self, base: str, rid: str) -> dict:
        """Long-poll the decode result. Idempotent, so a transport fault
        just polls again, until the coordinator's deadline."""
        import urllib.request

        deadline = time.monotonic() + self._result_timeout
        poll = f"{base}/kv/result?rid={rid}&timeout=30"
        last: Optional[Exception] = None
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(poll, timeout=45) as resp:
                    out = json.loads(resp.read().decode())
            except (OSError, ValueError) as e:
                last = e
                time.sleep(0.2)
                continue
            if out.get("done"):
                return out
        raise TimeoutError(
            f"decode result for rid {rid} never arrived: {last}"
        )
