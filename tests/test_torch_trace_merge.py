"""The port's fleet trace assembly (``horovod_tpu_torch/analysis/
trace_merge.py``) against the JAX package's module: the same span records
give equal edges, offsets, assembled timelines and chrome JSON. The
records come from the port's own trace plane (``common/tracing.py``:
spans recorded in its ring, a hop tagged from a server's echo), re-homed
onto the processes of a small fleet whose clocks disagree, as in
``tests/test_tracing.py``."""

import copy
import time

import pytest

from horovod_tpu.analysis import trace_merge as jtm
from horovod_tpu_torch.analysis import trace_merge as ttm
from horovod_tpu_torch.common import tracing


@pytest.fixture()
def traced(monkeypatch):
    monkeypatch.setenv("HOROVOD_TRACE", "1")
    monkeypatch.setenv("HOROVOD_TRACE_SAMPLE", "1")
    tracing._reset()
    yield tracing
    tracing._reset()


# (host, pid, role) of each process, and its clock's offset from the
# router's, seconds
FLEETS = {
    "two-hosts": {("h1", 1, "router"): 0.0, ("h1", 2, "prefill"): 0.0,
                  ("h2", 3, "decode"): -10.0},
    "three-hosts": {("h1", 1, "router"): 0.0, ("h2", 2, "prefill"): 0.25,
                    ("h3", 3, "decode"): -0.04},
    "relay-only": {("a", 1, "router"): 0.0, ("b", 2, "prefill"): 1.5,
                   ("c", 3, "decode"): 3.0},
}


def _spans(tr, fleet):
    """One request's spans, recorded by the port's trace plane: the
    router's root and its hop to the prefill worker, the prefill
    worker's span and its KV hop to the decode worker (tagged from the
    decode worker's echoed stamps), the decode worker's span; each then
    stamped with its process and that process's clock."""
    (router, r_off), (prefill, p_off), (decode, d_off) = fleet.items()
    ctx = tr.mint(True)
    t0 = 1000.0
    plan = [
        (router, r_off, "route", t0, None),
        (router, r_off, "route.hop", t0 + 0.001, (prefill, p_off, 0.002)),
        (prefill, p_off, "serve.prefill", t0 + 0.004, None),
        (prefill, p_off, "kv.stream", t0 + 0.010, (decode, d_off, 0.003)),
        (decode, d_off, "serve.decode", t0 + 0.016, None),
    ]
    out = []
    for (host, pid, role), off, name, true_ts, hop in plan:
        span = tr.start_span(name, ctx, request_id="req-1")
        if hop is not None:
            (phost, ppid, _), poff, rtt = hop
            # the server's stamps on its own clock, from the true times
            headers = {
                tr.TS_RECV_HEADER: f"{true_ts + rtt / 2 + poff:.6f}",
                tr.TS_SEND_HEADER: f"{true_ts + rtt / 2 + 0.0005 + poff:.6f}",
                tr.PEER_HEADER: f"{phost}:{ppid}",
            }
            tr.tag_hop(span, true_ts + off, true_ts + rtt + 0.0005 + off,
                       headers)
        span.end()
        rec = tr.recorder().spans()[-1]
        rec.update(host=host, pid=pid, role=role, ts=true_ts + off)
        out.append(rec)
    return out


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_same_spans_assemble_equal(traced, fleet):
    spans = _spans(traced, FLEETS[fleet])
    assert len({r["trace_id"] for r in spans}) == 1
    assert ttm.hop_edges(spans) == jtm.hop_edges(spans)
    assert len(ttm.hop_edges(spans)) == 2
    got, got_off = ttm.assemble(copy.deepcopy(spans))
    want, want_off = jtm.assemble(copy.deepcopy(spans))
    assert got == want and got_off == want_off
    # the decode worker lands on the router's clock through the prefill
    # worker's edge, within the edges' error bounds (the offsets are
    # relative to the process on the most edges, the prefill worker)
    router, _, decode = FLEETS[fleet]
    assert got_off[decode[:2]] - got_off[router[:2]] == pytest.approx(
        FLEETS[fleet][decode] - FLEETS[fleet][router], abs=0.01)
    assert [r["name"] for r in got] == [
        "route", "route.hop", "serve.prefill", "kv.stream", "serve.decode"]
    assert ttm.to_chrome(got, got_off) == jtm.to_chrome(want, want_off)
    assert ttm.traces_in(spans) == jtm.traces_in(spans)
    tid = spans[0]["trace_id"]
    assert ttm.filter_trace(spans, tid) == jtm.filter_trace(spans, tid)


@pytest.mark.parametrize("reference", [None, ("h1", 2), ("h2", 3)])
def test_host_offsets_equal_for_every_reference(traced, reference):
    spans = _spans(traced, FLEETS["two-hosts"])
    extra = [{"a": ("h1", 1), "b": ("h2", 3), "offset": -9.9, "err": 2.0}]
    edges = ttm.hop_edges(spans) + extra
    assert ttm.host_offsets(edges, reference) == jtm.host_offsets(
        edges, reference)
    got = ttm.assemble(copy.deepcopy(spans), edges=extra, reference=reference)
    want = jtm.assemble(copy.deepcopy(spans), edges=extra,
                        reference=reference)
    assert got == want


@pytest.mark.parametrize("stamps", [
    (100.0, 100.26, 100.262, 100.022),
    (500.0, 499.881, 499.882, 500.031),
    (1.0, 1.0, 1.0, 1.0),
])
def test_ntp_offset_and_peer_parsing_equal(stamps):
    assert ttm.ntp_offset(*stamps) == jtm.ntp_offset(*stamps)
    for peer in ("h1:3", "a:b:7", "nohost", "", "h:x"):
        assert ttm.parse_peer(peer) == jtm.parse_peer(peer)


def test_empty_and_untagged_inputs_agree():
    assert ttm.host_offsets([]) == jtm.host_offsets([]) == {}
    assert ttm.to_chrome([]) == jtm.to_chrome([])
    spans = [{"name": "x", "ts": time.time(), "tags": {"peer": "h:1"}}]
    assert ttm.hop_edges(spans) == jtm.hop_edges(spans) == []
    assert ttm.assemble(spans) == jtm.assemble(spans)
