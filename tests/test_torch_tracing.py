"""The port's request tracing (``common/tracing.py``) against the JAX
package's, and ``/traces`` from the port's serving frontend.

Both modules parse the same ``traceparent`` headers alike (valid and
malformed), mint contexts of the same shape under the same
``HOROVOD_TRACE``/``_SAMPLE`` settings, and record the same span
records into their rings. A tiny model served on the CPU answers a
request that carries a ``traceparent``: the reply echoes the trace id,
and ``GET /traces`` holds the frontend's, the batcher's, the prefill's
and the decode's spans under it."""

import json
import re
import urllib.request

import pytest

from horovod_tpu_torch.common import tracing as ptr

HEADERS = [
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "AB" * 16 + "-" + "CD" * 8 + "-00",
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-03",
    None, "", "garbage", "00-short-" + "cd" * 8 + "-01",
    "00-" + "zz" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "00" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "ab" * 16 + "-" + "00" * 8 + "-01",
    "0-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-xy",
]


def _jax_tracing():
    from horovod_tpu.common import tracing as jtr

    return jtr


@pytest.fixture
def both_traced(monkeypatch):
    jtr = _jax_tracing()
    monkeypatch.setenv("HOROVOD_TRACE", "1")
    monkeypatch.setenv("HOROVOD_TRACE_SAMPLE", "1.0")
    monkeypatch.setenv("HOROVOD_TRACE_SPANS", "3")
    for mod in (jtr, ptr):
        mod._reset()
    yield jtr
    for mod in (jtr, ptr):
        mod._reset()


def _ctx(c):
    return None if c is None else (c.trace_id, c.span_id, c.sampled,
                                   c.to_traceparent(), c.to_dict())


def test_traceparent_parse_equals_the_jax_module():
    jtr = _jax_tracing()
    for h in HEADERS:
        assert _ctx(ptr.parse_traceparent(h)) == \
            _ctx(jtr.parse_traceparent(h)), h
    d = {"trace_id": "ab" * 16, "span_id": "cd" * 8, "sampled": False}
    assert _ctx(ptr.TraceContext.from_dict(d)) == \
        _ctx(jtr.TraceContext.from_dict(d))
    assert ptr.TraceContext.from_dict({"trace_id": ""}) is None


def test_mint_adopt_and_spans_like_the_jax_module(both_traced,
                                                  monkeypatch):
    jtr = both_traced
    fmt = re.compile(r"^00-[0-9a-f]{32}-[0-9a-f]{16}-01$")
    for mod in (jtr, ptr):
        assert mod.enabled()
        assert fmt.match(mod.mint().to_traceparent())
    for h in HEADERS:
        a, b = ptr.adopt(h), jtr.adopt(h)
        assert (a is None) == (b is None), h
        if ptr.parse_traceparent(h) is not None and a is not None:
            assert _ctx(a) == _ctx(b)
    recs = {}
    for mod in (jtr, ptr):
        root = mod.TraceContext("ab" * 16, "cd" * 8, True)
        for i in range(4):  # a ring of 3: the oldest goes
            span = mod.start_span(f"op{i}", root, slot=i)
            with span:
                mod.annotate(f"retry:x#{i}")
        span.end(outcome="twice")  # a second end is a no-op
        assert mod.start_span("x", None) is None
        assert mod.root_span("r", None) is None
        recs[mod] = [{k: v for k, v in r.items()
                      if k not in ("span_id", "ts", "dur_ms")}
                     for r in mod.recorder().spans()]
    assert recs[ptr] == recs[jtr] and len(recs[ptr]) == 3
    assert recs[ptr][0]["tags"] == {"slot": 1, "notes": ["retry:x#1"]}
    stamps = set(ptr.server_stamps(1.0)) == set(jtr.server_stamps(1.0))
    assert stamps
    monkeypatch.setenv("HOROVOD_TRACE_SAMPLE", "0.0")
    for mod in (jtr, ptr):
        mod._reset()
        assert mod.mint() is None


def test_ring_dump_json_lines(both_traced, tmp_path):
    root = ptr.mint()
    ptr.start_span("a", root).end()
    path = ptr.recorder().dump(str(tmp_path / "spans.jsonl"))
    lines = [json.loads(x) for x in open(path)]
    assert [r["name"] for r in lines] == ["a"]
    assert lines[0]["trace_id"] == root.trace_id


def _post(port, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=60) as r:
        return dict(r.headers), json.loads(r.read())


def _spans(port, trace_id, want, tries=100):
    import time

    for _ in range(tries):  # spans end after the reply's bytes
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/traces",
                                    timeout=10) as r:
            doc = json.loads(r.read())
        got = {s["name"] for s in doc["spans"] if s["trace_id"] == trace_id}
        if want <= got:
            return doc, got
        time.sleep(0.02)
    return doc, got


def test_traces_route_of_the_serving_frontend(monkeypatch):
    import horovod_tpu_torch as hvd

    monkeypatch.setenv("HOROVOD_TRACE", "1")
    ptr._reset()
    handle = hvd.serve(hvd.Transformer(hvd.TransformerConfig.tiny(),
                                       device="cpu"),
                       None, port=0, device="cpu", handle_sigterm=False,
                       addr="127.0.0.1")
    try:
        port = handle.port
        tid = "4bf92f3577b34da6a3ce929d0e0e4736"
        hdrs, out = _post(port, {"tokens": [1, 2, 3], "max_tokens": 3},
                          {"traceparent": f"00-{tid}-00f067aa0ba902b7-01"})
        assert out["status"] == "done" and out["trace_id"] == tid
        assert hdrs["X-Trace-Id"] == tid and "X-Trace-Ts-Recv" in hdrs
        want = {"http.generate", "serve.prefill", "serve.decode",
                "engine.prefill_chunk"}
        doc, got = _spans(port, tid, want)
        assert want <= got
        assert {"host", "pid", "role", "recv_ts", "send_ts"} <= set(doc)
        decode = [s for s in doc["spans"] if s["name"] == "serve.decode"]
        assert decode[0]["tags"]["outcome"] == "done"
        # no header: a root is minted; a malformed one mints afresh
        for extra in ({}, {"traceparent": "garbage"}):
            hdrs, out = _post(port, {"tokens": [4], "max_tokens": 1}, extra)
            assert re.match(r"^[0-9a-f]{32}$", out["trace_id"])
            assert out["trace_id"] != tid
    finally:
        handle.stop()
        ptr._reset()
