"""The port's flight recorder, metrics registry and scrape endpoint
against the JAX package's (``common/telemetry.py``, ``metrics.py``).

On the same registry values and an injected clock, both hubs close the
same records, percentiles and heartbeat payloads; both registries write
the same JSON-lines dumps (timestamps aside); ``render_prometheus`` is
byte-equal on the same snapshot (the HELP line names each package). The
port's endpoint serves ``/metrics``, ``/telemetry``, ``/traces`` and
``/healthz``; ``hvd.init()`` starts it only with
``HOROVOD_METRICS_PORT``, and with no observability variable set starts
no thread; ``DistributedOptimizer.step()`` ticks the recorder and
``GracefulShutdown`` dumps it before the checkpoint."""

import json
import socket
import threading
import types
import urllib.request

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics, telemetry
from horovod_tpu_torch.common.metrics import MetricsRegistry, registry


class _Clock:
    """Scripted ``time`` for both modules: monotonic and wall advance
    by the same steps."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        self.t += 0.0125
        return self.t

    def time(self):
        return 1.7e9 + self.t


def _jax_telemetry():
    from horovod_tpu.common import metrics as jm
    from horovod_tpu.common import telemetry as jt

    return jt, jm


def test_render_prometheus_byte_equal():
    jt, _ = _jax_telemetry()
    rng = np.random.default_rng(0)
    snap = {f"fam{i % 3}.metric_{i}": float(v)
            for i, v in enumerate(rng.normal(size=12) * 1e3)}
    snap.update({"stall.pending": 2.0, "bad.nan": float("nan"),
                 "bad.inf": float("inf"), "9lead": 1.0, "a-b": 3.0,
                 "a_b": 4.0})
    pct = {"p50": 12.5, "p95": 40.0, "count": 9, "sum": 133.25}
    for p in (pct, {}):
        got = telemetry.render_prometheus(snap, p)
        want = jt.render_prometheus(snap, p)
        assert got == want.replace("horovod_tpu metric",
                                   "horovod_tpu_torch metric")
        assert "hvd_bad_nan" not in got and "telemetry_step_ms" in got


def test_ring_records_equal_the_jax_hub(monkeypatch):
    jt, jm = _jax_telemetry()
    clock_j, clock_p = _Clock(), _Clock()
    monkeypatch.setattr(jt, "time", clock_j)
    monkeypatch.setattr(telemetry, "time", clock_p)
    jreg, preg = jm.MetricsRegistry(), MetricsRegistry()
    monkeypatch.setattr(jt, "_metrics", jreg)
    monkeypatch.setattr(telemetry, "_metrics", preg)
    jhub, phub = jt.TelemetryHub(capacity=4), telemetry.TelemetryHub(
        capacity=4)
    rng = np.random.default_rng(1)
    for step in range(6):
        for hub in (jhub, phub):
            hub.step_begin(step if step % 2 else None)
        values = {k: float(v) for k, v in zip(
            ("fusion.dispatches", "fusion.flushed_bytes",
             "fusion.wire_bytes_saved", "fusion.cycles",
             "local_sgd.rounds_deferred"), rng.integers(0, 1000, 5))}
        values["fusion.wire_format"] = float(step % 3)
        for reg in (jreg, preg):
            reg.update("x", {"y": step})
            for k, v in values.items():
                reg.gauge(k, v)
        for hub in (jhub, phub):
            hub.step_end()
    assert phub.records() == jhub.records()
    assert len(phub) == 4
    assert phub.percentiles() == jhub.percentiles()
    assert phub.heartbeat_stats() == jhub.heartbeat_stats()
    assert preg.snapshot()["telemetry.step_ms_p95"] == \
        jreg.snapshot()["telemetry.step_ms_p95"]


def test_metrics_dumps_equal_the_jax_registry(tmp_path):
    _, jm = _jax_telemetry()
    out = {}
    for tag, reg in (("jax", jm.MetricsRegistry()),
                     ("port", MetricsRegistry())):
        path = str(tmp_path / f"{tag}.jsonl")
        reg.configure_export(path)
        assert reg.exporting
        reg.gauge("a", 1.0)
        reg.counter("b", 2.0)
        reg.dump()
        reg.dump()  # unchanged: nothing appended
        reg.update("c", {"d": 3, "e": 4})
        reg.dump()
        reg.dump(force=True)
        reg.reset()
        reg.gauge("a", 5.0)
        reg.dump()
        out[tag] = [{k: v for k, v in json.loads(line).items() if k != "ts"}
                    for line in open(path)]
    assert out["port"] == out["jax"] and len(out["port"]) == 9


def test_tick_passes_only_the_stall_escalation():
    telemetry._reset_hub()
    try:
        hub = telemetry.hub()

        class _Insp:
            error = hvd.HorovodInternalError("stalled")

            def check(self):
                raise self.error

        hub.stall_inspector = _Insp()
        hub.tick(0)
        with pytest.raises(hvd.HorovodInternalError):
            telemetry.device_step_tick(1)
        _Insp.error = ValueError("a telemetry bug")
        telemetry.device_step_tick(2)  # swallowed
    finally:
        telemetry._reset_hub()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.headers.get("Content-Type"), r.read().decode()


def test_metrics_server_routes():
    hub = telemetry.TelemetryHub(capacity=8)
    srv = telemetry.MetricsServer(port=0, addr="127.0.0.1",
                                  hub_instance=hub)
    port = srv.start()
    try:
        assert hub.enabled and hub.scrapers == 1
        for i in range(3):
            hub.step_begin(i)
            hub.step_end()
        registry.gauge("stall.pending", 1.0)
        ctype, body = _get(port, "/metrics")
        assert ctype == telemetry.PROM_CONTENT_TYPE
        assert 'telemetry_step_ms{quantile="0.5"}' in body
        assert "hvd_telemetry_step_ms_p95" in body
        assert "hvd_stall_pending 1" in body
        doc = json.loads(_get(port, "/telemetry")[1])
        assert [r["step"] for r in doc["steps"]] == [0, 1, 2]
        assert doc["ring_capacity"] == 8
        traces = json.loads(_get(port, "/traces")[1])
        assert {"spans", "host", "pid", "recv_ts"} <= set(traces)
        assert _get(port, "/healthz")[1] == "ok\n"
    finally:
        srv.stop()
    assert hub.scrapers == 0


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_init_starts_the_server_only_when_asked(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_METRICS_PORT",
              "HOROVOD_TIMELINE", "HOROVOD_FLIGHT_RECORDER",
              "HOROVOD_TELEMETRY", "HOROVOD_AUTOTUNE"):
        monkeypatch.delenv(k, raising=False)
    before = threading.active_count()
    hvd.init(device="cpu")
    try:
        st = basics.state()
        assert st.telemetry_server is None and st.timeline is None
        assert st.parameter_manager is None
        assert st.stall_inspector is not None  # on by default
        assert threading.active_count() == before
    finally:
        hvd.shutdown()
    port = _free_port()
    monkeypatch.setenv("HOROVOD_METRICS_PORT", str(port))
    hvd.init(device="cpu")
    try:
        hvd.allreduce(torch.ones(3))
        body = _get(port, "/metrics")[1]
        assert "hvd_fusion_dispatches 1" in body
        assert "hvd_fusion_cycles 1" in body
    finally:
        hvd.shutdown()
    assert basics.state().telemetry_server is None


def test_optimizer_ticks_and_the_heartbeat_payload(monkeypatch, tmp_path):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_TELEMETRY", "1")
    telemetry._reset_hub()
    hvd.init(device="cpu")
    try:
        torch.manual_seed(0)
        model = torch.nn.Linear(8, 4)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        for _ in range(4):
            opt.zero_grad()
            model(torch.randn(2, 8)).sum().backward()
            opt.step()
        recs = telemetry.hub().records()
        # a tick closes the previous record: four steps, three records
        assert [r["step"] for r in recs] == [1, 2, 3]
        assert all(r["fusion_dispatches"] == 1.0 for r in recs)
        hb = telemetry.heartbeat_stats()
        assert hb["step"] == 3 and hb["step_ms_p50"] > 0
        path = telemetry.hub().dump(str(tmp_path / "fr.jsonl"))
        assert len(open(path).read().splitlines()) == 3
        opt.remove_hooks()
    finally:
        hvd.shutdown()
        telemetry._reset_hub()


def test_graceful_shutdown_dumps_the_ring_before_the_checkpoint(
        monkeypatch, tmp_path):
    path = tmp_path / "fr.jsonl"
    monkeypatch.setenv("HOROVOD_FLIGHT_RECORDER", str(path))
    telemetry._reset_hub()
    try:
        hub = telemetry.hub()
        hub.step_begin(7)
        hub.step_end()
        seen = {}

        def persist():
            seen["ring_on_disk"] = path.exists()

        state = types.SimpleNamespace(persist=persist)
        hvd.preemption.GracefulShutdown(state).drain()
        assert seen == {"ring_on_disk": True}
        assert json.loads(path.read_text())["step"] == 7
    finally:
        telemetry._reset_hub()
