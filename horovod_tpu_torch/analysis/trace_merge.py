"""Skew-corrected fleet trace assembly (standard library only).

A copy of ``horovod_tpu/analysis/trace_merge.py``. The trace plane
(``common/tracing.py``) leaves one bounded span ring a process, live at
``GET /traces`` on the metrics server and drained to
``<flight_recorder>.spans`` JSON lines on a crash. Each process stamps
its spans with its own wall clock, and hosts disagree by milliseconds:
enough to make a 2 ms KV-transfer hop appear to finish before it
started. This module merges the rings into one timeline:

1. **Edges.** Every traced hop carries four stamps: the client's
   ``t_send``/``t_recv`` and the server's echoed
   ``peer_recv``/``peer_send`` (headers on HTTP hops, ``recv_ts`` /
   ``send_ts`` fields in the KV-page stream and ``/traces`` replies).
   Each quadruple is one NTP edge: :func:`ntp_offset` estimates the
   server's clock minus the client's as the half-sum of the two one-way
   deltas, with the half round trip as the error bound (exact under
   symmetric delay; the bound holds regardless).
2. **Per-process offsets.** :func:`host_offsets` fuses parallel edges
   between the same pair of processes by inverse-error weighting, then
   runs a lowest-accumulated-error search (Dijkstra) from a reference
   process: offsets compose along paths, so a decode worker that only
   talked to the prefill worker still lands on the router's timeline.
3. **Assembly.** :func:`assemble` rewrites every span's epoch stamp
   into the reference clock; :func:`to_chrome` renders the result as
   chrome://tracing / Perfetto JSON with one process row a
   ``(host, role)`` and one thread row a pid.

The same span records give the same output as the JAX package's module
(``tests/test_torch_trace_merge.py``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

# err floor (seconds): a zero-RTT edge would get infinite weight and a
# zero Dijkstra cost; 1 µs is far below any real network RTT
_MIN_ERR = 1e-6

ProcKey = Tuple[str, int]  # (host, pid)


def proc_key(rec: dict) -> ProcKey:
    """The process identity a span (or /traces payload) belongs to.
    Local smoke fleets share a hostname, so the pid is part of the
    key; the ``role`` label is display-only."""
    return str(rec.get("host", "?")), int(rec.get("pid", 0))


def parse_peer(peer: str) -> Optional[ProcKey]:
    """``"host:pid"`` (tracing.server_stamps / json_stamps identity)
    → key; None on anything malformed."""
    if not peer or ":" not in peer:
        return None
    host, _, pid = peer.rpartition(":")
    try:
        return host, int(pid)
    except ValueError:
        return None


# ------------------------------------------------------------- NTP math


def ntp_offset(
    t_send: float, peer_recv: float, peer_send: float, t_recv: float
) -> Tuple[float, float]:
    """One NTP edge → ``(offset, err)``.

    ``offset`` estimates (server clock − client clock) as the half-sum
    of the request and response one-way deltas; ``err`` is the half-RTT
    bound: whatever the delay asymmetry, the true offset lies within
    ``offset ± err`` as long as each stamped interval really contains
    its network leg."""
    offset = ((peer_recv - t_send) + (peer_send - t_recv)) / 2.0
    rtt = (t_recv - t_send) - (peer_send - peer_recv)
    return offset, max(rtt, 0.0) / 2.0


def hop_edges(spans: Iterable[dict]) -> List[dict]:
    """Extract every NTP edge a span set carries. A hop span's tags
    hold the four stamps plus the server's ``peer`` identity
    (tracing.tag_hop / tag_hop_fields); the edge direction is client →
    server, offset = server clock − client clock."""
    edges: List[dict] = []
    for rec in spans:
        tags = rec.get("tags") or {}
        peer = parse_peer(str(tags.get("peer", "")))
        if peer is None:
            continue
        try:
            offset, err = ntp_offset(
                float(tags["t_send"]),
                float(tags["peer_recv"]),
                float(tags["peer_send"]),
                float(tags["t_recv"]),
            )
        except (KeyError, TypeError, ValueError):
            continue
        edges.append(
            {"a": proc_key(rec), "b": peer, "offset": offset, "err": err}
        )
    return edges


def host_offsets(
    edges: List[dict], reference: Optional[ProcKey] = None
) -> Dict[ProcKey, float]:
    """Per-process clock offsets RELATIVE to ``reference`` (its own
    offset is 0; subtracting a process's offset moves its stamps onto
    the reference clock).

    Parallel edges between the same pair fuse by inverse-error
    weighting — a tight 0.5 ms-RTT edge dominates a retried 2 s one —
    then Dijkstra by accumulated error bound picks the most trustworthy
    stamp path to each process. Unreachable processes are omitted (the
    caller treats them as offset 0). Default reference: the process on
    the most edges, ties broken lexicographically — in a serve fleet
    that is the router, which also took the client's request."""
    if not edges:
        return {}
    # fuse parallel edges (normalize direction to sorted key order)
    fused: Dict[Tuple[ProcKey, ProcKey], Tuple[float, float]] = {}
    acc: Dict[Tuple[ProcKey, ProcKey], List[Tuple[float, float]]] = {}
    for e in edges:
        a, b, off = e["a"], e["b"], float(e["offset"])
        if a == b:
            continue
        if b < a:
            a, b, off = b, a, -off
        acc.setdefault((a, b), []).append(
            (off, max(float(e["err"]), _MIN_ERR))
        )
    for pair, obs in acc.items():
        wsum = sum(1.0 / err for _, err in obs)
        fused[pair] = (
            sum(off / err for off, err in obs) / wsum,
            1.0 / wsum,
        )
    graph: Dict[ProcKey, List[Tuple[ProcKey, float, float]]] = {}
    for (a, b), (off, err) in fused.items():
        graph.setdefault(a, []).append((b, off, err))
        graph.setdefault(b, []).append((a, -off, err))
    if reference is None:
        reference = min(
            graph, key=lambda k: (-len(graph[k]), k)
        )
    # Dijkstra on accumulated error bound
    import heapq

    best: Dict[ProcKey, Tuple[float, float]] = {reference: (0.0, 0.0)}
    heap: List[Tuple[float, ProcKey, float]] = [(0.0, reference, 0.0)]
    while heap:
        cost, node, offset = heapq.heappop(heap)
        if best.get(node, (None, float("inf")))[1] < cost:
            continue
        for nxt, off, err in graph.get(node, ()):
            ncost = cost + err
            if nxt not in best or ncost < best[nxt][1]:
                best[nxt] = (offset + off, ncost)
                heapq.heappush(heap, (ncost, nxt, offset + off))
    return {k: v[0] for k, v in best.items()}


# -------------------------------------------------------------- assembly


def assemble(
    spans: List[dict],
    edges: Optional[List[dict]] = None,
    reference: Optional[ProcKey] = None,
) -> Tuple[List[dict], Dict[ProcKey, float]]:
    """Skew-correct a merged span set onto one clock.

    Returns ``(corrected, offsets)``: copies of the spans sorted by
    corrected start, each with a ``ts_corrected`` epoch stamp (the raw
    ``ts`` minus its process's offset; unreachable processes pass
    through uncorrected). Extra ``edges`` (e.g. the assembler's own
    scrape hops) augment what the spans themselves carry."""
    all_edges = hop_edges(spans) + list(edges or ())
    offsets = host_offsets(all_edges, reference=reference)
    corrected = []
    for rec in spans:
        out = dict(rec)
        out["ts_corrected"] = float(rec.get("ts", 0.0)) - offsets.get(
            proc_key(rec), 0.0
        )
        corrected.append(out)
    corrected.sort(key=lambda r: r["ts_corrected"])
    return corrected, offsets


def traces_in(spans: Iterable[dict]) -> Dict[str, int]:
    """{trace_id: span count} — the assembler CLI's listing."""
    counts: Dict[str, int] = {}
    for rec in spans:
        tid = rec.get("trace_id")
        if tid:
            counts[tid] = counts.get(tid, 0) + 1
    return counts


def filter_trace(spans: Iterable[dict], trace_id: str) -> List[dict]:
    return [r for r in spans if r.get("trace_id") == trace_id]


def to_chrome(
    corrected: List[dict], offsets: Optional[Dict[ProcKey, float]] = None
) -> dict:
    """Corrected spans → chrome://tracing / Perfetto JSON.

    One process row per ``(host, role)`` (router, prefill and decode
    lanes a host), one thread row per pid inside it, ``ph="X"``
    complete events in µs relative to the earliest corrected span. Tags
    ride ``args`` verbatim, so every event stays greppable by trace_id /
    request_id / outcome."""
    events: List[dict] = []
    if not corrected:
        return {"traceEvents": events, "displayTimeUnit": "ms"}
    t0 = min(r["ts_corrected"] for r in corrected)
    rows: Dict[Tuple[str, str], int] = {}
    tids: Dict[Tuple[int, int], int] = {}
    for rec in corrected:
        host, pid = proc_key(rec)
        role = str(rec.get("role", "") or "worker")
        row = (host, role)
        if row not in rows:
            cpid = rows[row] = len(rows) + 1
            events.append(
                {
                    "ph": "M", "name": "process_name", "pid": cpid,
                    "tid": 0,
                    "args": {"name": f"{host} [{role}]"},
                }
            )
        cpid = rows[row]
        if (cpid, pid) not in tids:
            ctid = tids[(cpid, pid)] = (
                sum(1 for k in tids if k[0] == cpid) + 1
            )
            events.append(
                {
                    "ph": "M", "name": "thread_name", "pid": cpid,
                    "tid": ctid, "args": {"name": f"pid {pid}"},
                }
            )
        ctid = tids[(cpid, pid)]
        args = dict(rec.get("tags") or {})
        args.update(
            trace_id=rec.get("trace_id", ""),
            span_id=rec.get("span_id", ""),
            parent_id=rec.get("parent_id") or "",
        )
        events.append(
            {
                "ph": "X",
                "name": str(rec.get("name", "span")),
                "pid": cpid,
                "tid": ctid,
                "ts": round((rec["ts_corrected"] - t0) * 1e6, 1),
                "dur": round(float(rec.get("dur_ms", 0.0)) * 1e3, 1),
                "args": args,
            }
        )
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if offsets:
        out["otherData"] = {
            "clock_offsets_s": {
                f"{h}:{p}": round(o, 6) for (h, p), o in offsets.items()
            }
        }
    return out
