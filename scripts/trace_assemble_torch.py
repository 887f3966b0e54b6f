"""Fleet trace assembler CLI for the port: /traces scrapes → one
chrome://tracing JSON.

The counterpart of ``scripts/trace_assemble.py`` over
``horovod_tpu_torch.analysis.trace_merge``, with the same options; it
imports no JAX. Pulls span rings from every worker — live (``--url`` against the
MetricsServer ``/traces`` route, repeatable) or post-mortem (``--file``
against the flight recorder's ``<path>.spans`` JSON-lines siblings) —
then hands them to ``horovod_tpu_torch/analysis/trace_merge.py`` for NTP-style skew
correction and Perfetto rendering.

Every live scrape is ITSELF an NTP edge: the reply carries the
worker's ``recv_ts``/``send_ts`` stamps, and this process's
send/receive times complete the quadruple — so a fleet whose workers
never spoke to each other directly still assembles onto one clock,
through the assembler's own hops.

Usage::

    python scripts/trace_assemble_torch.py \
        --url http://10.0.0.1:9100/traces \
        --url http://10.0.0.2:9100/traces \
        --file /tmp/flight.jsonl.spans \
        [--trace <32-hex id>] [--list] --out fleet_trace.json

Open the output at chrome://tracing or https://ui.perfetto.dev.
"""

import argparse
import json
import os
import socket
import sys
import time
import urllib.request

# runnable as `python scripts/trace_assemble_torch.py` from the repo root
sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from horovod_tpu_torch.analysis import trace_merge  # noqa: E402


def scrape(url: str, timeout: float = 10.0):
    """GET one /traces endpoint → (spans, scrape-hop edge)."""
    t_send = time.time()
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        payload = json.load(resp)
    t_recv = time.time()
    spans = payload.get("spans", [])
    # the worker stamps host/pid/role onto records lazily; backfill
    # from the payload identity for anything that predates a set_role
    for rec in spans:
        rec.setdefault("host", payload.get("host", "?"))
        rec.setdefault("pid", payload.get("pid", 0))
        if payload.get("role"):
            rec.setdefault("role", payload["role"])
    edge = None
    if "recv_ts" in payload and "send_ts" in payload:
        offset, err = trace_merge.ntp_offset(
            t_send, float(payload["recv_ts"]),
            float(payload["send_ts"]), t_recv,
        )
        edge = {
            "a": (socket.gethostname(), os.getpid()),
            "b": (str(payload.get("host", "?")),
                  int(payload.get("pid", 0))),
            "offset": offset,
            "err": err,
        }
    return spans, edge


def load_file(path: str):
    spans = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                spans.append(json.loads(line))
    return spans


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Assemble per-worker span rings into one "
        "skew-corrected chrome://tracing JSON."
    )
    ap.add_argument(
        "--url", action="append", default=[],
        help="a worker's /traces endpoint (repeatable)",
    )
    ap.add_argument(
        "--file", action="append", default=[],
        help="a flight-recorder .spans JSON-lines file (repeatable)",
    )
    ap.add_argument(
        "--trace", default=None,
        help="assemble only this trace_id (default: everything)",
    )
    ap.add_argument(
        "--list", action="store_true",
        help="list trace ids + span counts and exit",
    )
    ap.add_argument(
        "--out", default="fleet_trace.json",
        help="output path (chrome://tracing JSON)",
    )
    args = ap.parse_args(argv)
    if not args.url and not args.file:
        ap.error("need at least one --url or --file source")

    spans = []
    extra_edges = []
    for url in args.url:
        got, edge = scrape(url)
        spans.extend(got)
        if edge is not None:
            extra_edges.append(edge)
        print(f"{url}: {len(got)} spans")
    for path in args.file:
        got = load_file(path)
        spans.extend(got)
        print(f"{path}: {len(got)} spans")

    counts = trace_merge.traces_in(spans)
    if args.list:
        for tid, n in sorted(
            counts.items(), key=lambda kv: -kv[1]
        ):
            print(f"{tid}  {n} spans")
        return 0
    if args.trace:
        spans = trace_merge.filter_trace(spans, args.trace)
        if not spans:
            print(f"trace {args.trace} not found", file=sys.stderr)
            return 1

    corrected, offsets = trace_merge.assemble(spans, edges=extra_edges)
    chrome = trace_merge.to_chrome(corrected, offsets)
    with open(args.out, "w") as f:
        json.dump(chrome, f)
    procs = {trace_merge.proc_key(r) for r in corrected}
    print(
        f"assembled {len(corrected)} spans / {len(counts)} trace(s) "
        f"across {len(procs)} process(es) -> {args.out}"
    )
    for key, off in sorted(offsets.items()):
        print(f"  clock offset {key[0]}:{key[1]}: {off * 1e3:+.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
