"""The port's stall inspector and the elastic driver's escalation and
straggler quarantine, against the JAX package's.

Both inspectors read one scripted clock (``time`` injected into each
module) and take the same heartbeats and pending entries: their
warnings, ``straggler_ranks``, streaks, gauges and shutdown escalations
must agree. Both drivers poll the same heartbeat payloads out of their
rendezvous KV stores and must reach the same restart reasons and the
same quarantines (the JAX driver's self-healing tests' scenarios, with
the port's default of 3 polls). The fusion manager feeds the inspector:
a handle left unwaited shows in ``stall.pending`` and warns, and the
shutdown age raises from the next telemetry tick."""

import json
import logging

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics, telemetry
from horovod_tpu_torch.common import stall_inspector as pst
from horovod_tpu_torch.common.metrics import registry


class _Clock:
    def __init__(self):
        self.mono, self.wall = 100.0, 1.7e9

    def monotonic(self):
        return self.mono

    def time(self):
        return self.wall

    def advance(self, s):
        self.mono += s
        self.wall += s


def _jax_stall():
    from horovod_tpu.common import stall_inspector as jst
    from horovod_tpu.common.basics import HorovodInternalError

    return jst, HorovodInternalError


def _script(insp, clock, error):
    """One scenario through an inspector; returns what it observed."""
    seen = []
    insp.record_enqueue("grad.a")
    insp.record_enqueue("grad.b")
    for r in range(4):
        insp.record_heartbeat(r, step=100, step_ms_p50=10.0 + r)
    clock.advance(2.0)
    insp.record_complete("grad.b")
    insp.check()
    seen.append(("stale", insp.stale_ranks()))
    for beat in range(4):
        clock.advance(1.0)
        for r in range(4):
            if r == 3 and beat >= 2:
                continue  # rank 3 goes silent
            insp.record_heartbeat(r, step=100 + beat * (0 if r == 1 else 5),
                                  step_ms_p50=60.0 if r == 2 else 10.0)
        insp.check()
        seen.append(("stragglers", insp.straggler_ranks(),
                     insp.straggler_streaks(),
                     insp.quarantine_candidates(3)))
    seen.append(("lag", insp.straggler_ranks(lag_steps=10)))
    clock.advance(4.0)
    try:
        insp.check()
        seen.append(("no escalation",))
    except error as e:
        seen.append(("escalated", str(e)))
    seen.append(("stats", insp.heartbeat_stats()))
    return seen


class _Collect(logging.Handler):
    """The package loggers do not propagate: collect at the logger."""

    def __init__(self, logger):
        super().__init__(logging.WARNING)
        self.messages, self.logger = [], logger

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


def test_inspector_decisions_equal_the_jax_inspector(monkeypatch):
    jst, jerr = _jax_stall()
    out, gauges, logs = {}, {}, {}
    from horovod_tpu.common import metrics as jm

    for tag, mod, err, reg in (("jax", jst, jerr, jm.registry),
                               ("port", pst, hvd.HorovodInternalError,
                                registry)):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        with _Collect(mod.logger) as got:
            insp = mod.StallInspector(warning_seconds=1.5,
                                      shutdown_seconds=7.0,
                                      straggler_factor=3.0)
            out[tag] = _script(insp, clock, err)
        logs[tag] = got.messages
        gauges[tag] = {k: v for k, v in reg.snapshot().items()
                       if k.startswith("stall.")}
    assert out["port"] == out["jax"]
    assert logs["port"] == logs["jax"] and len(logs["port"]) >= 3
    assert gauges["port"] == gauges["jax"]
    assert out["port"][-2][0] == "escalated"
    assert any(s[0] == "stragglers" and s[1] == [2] for s in out["port"])


# ------------------------------------------------- the drivers' decisions


class _StoreServer:
    def __init__(self, store):
        self.store = store


def _driver(monkeypatch, package, hosts, polls, min_np=1):
    if package == "jax":
        from horovod_tpu.elastic.driver import ElasticDriver
        from horovod_tpu.elastic.discovery import HostDiscovery
        from horovod_tpu.runner.hosts import HostInfo
        from horovod_tpu.runner.rendezvous import KVStore
    else:
        from horovod_tpu_torch.elastic.driver import ElasticDriver
        from horovod_tpu_torch.elastic.discovery import HostDiscovery
        from horovod_tpu_torch.runner.hosts import HostInfo
        from horovod_tpu_torch.runner.rendezvous import KVStore

    class _Hosts(HostDiscovery):
        def find_available_hosts_and_slots(self):
            return [HostInfo(h, s) for h, s in hosts]

    if polls is None:
        monkeypatch.delenv("HOROVOD_STRAGGLER_QUARANTINE_POLLS",
                           raising=False)
    else:
        monkeypatch.setenv("HOROVOD_STRAGGLER_QUARANTINE_POLLS", str(polls))
    d = ElasticDriver(_Hosts(), ["true"], min_np=min_np)
    d.host_manager.refresh()
    d._server = _StoreServer(KVStore())
    d._blocks = [{"HOROVOD_RANK": str(r), "HOROVOD_HOSTNAME": h}
                 for r, h in enumerate(["a"] * 2 + ["b"] * 6)]
    return d


def _beat(d, clock, slow, silent=()):
    from horovod_tpu_torch.runner.rendezvous import HEARTBEAT_SCOPE

    for r in range(8):
        if r in silent:
            continue
        d._server.store.put(HEARTBEAT_SCOPE, str(r), json.dumps({
            "ts": clock.wall, "step": 100,
            "step_ms_p50": 500.0 if r in slow else 10.0,
            "last_step_ts": clock.wall}).encode())


SCENARIOS = {
    # default polls (3 in both packages): quarantine at the third poll
    "default": dict(polls=None, slow=(0, 1), beats=4, min_np=1),
    # capacity guard: quarantining host a would leave < min_np
    "capacity": dict(polls=2, slow=(0, 1), beats=3, min_np=8),
    # off: observe only
    "off": dict(polls=0, slow=(0, 1), beats=4, min_np=1),
    # silence past the shutdown age escalates to a restart
    "silence": dict(polls=3, slow=(), beats=3, min_np=1, silent=(5,),
                    shutdown=2.5),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_driver_decisions_equal_the_jax_driver(monkeypatch, name):
    sc = SCENARIOS[name]
    if "shutdown" in sc:
        monkeypatch.setenv("HOROVOD_STALL_CHECK_TIME_SECONDS", "1")
        monkeypatch.setenv("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS",
                           str(sc["shutdown"]))
    from horovod_tpu.common import stall_inspector as jst

    results = {}
    for package, mod in (("jax", jst), ("port", pst)):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        d = _driver(monkeypatch, package, [("a", 2), ("b", 6)], sc["polls"],
                    sc["min_np"])
        reasons = []
        for i in range(sc["beats"]):
            _beat(d, clock, sc["slow"], sc.get("silent", ()) if i else ())
            clock.advance(1.0)
            d._last_hb_poll = -1e9
            reasons.append(d._poll_heartbeats(0.0))
        results[package] = (reasons,
                            sorted(d.host_manager.blacklisted),
                            d.stall_inspector.straggler_streaks())
    assert results["port"] == results["jax"]
    reasons, blacklisted, _ = results["port"]
    if name == "default":
        assert reasons[:2] == [None, None] and "quarantine" in reasons[2]
        assert blacklisted == ["a"]
    elif name == "silence":
        assert reasons[-1] == "worker heartbeat silence"
    else:
        assert reasons == [None] * sc["beats"] and blacklisted == []


# ------------------------------------------- the fusion manager's feed


def test_unwaited_handle_warns_and_the_shutdown_age_raises(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_STALL_CHECK_DISABLE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_STALL_CHECK_TIME_SECONDS", "1")
    monkeypatch.setenv("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", "3")
    clock = _Clock()
    monkeypatch.setattr(pst, "time", clock)
    telemetry._reset_hub()
    hvd.init(device="cpu")
    try:
        insp = basics.state().stall_inspector
        assert basics.state().fusion.stall_inspector is insp
        assert telemetry.hub().stall_inspector is insp
        left = hvd.allreduce_async(torch.ones(4), name="left.open")
        clock.advance(1.5)
        with _Collect(pst.logger) as got:
            hvd.allreduce(torch.ones(2), name="other")  # a cycle: check()
        assert any("left.open" in m for m in got.messages)
        insp.check()  # "other" was waited on; "left.open" was not
        assert registry.snapshot()["stall.pending"] == 1.0
        hub = telemetry.hub()
        hub.step_begin(0)
        clock.advance(2.0)
        with pytest.raises(hvd.HorovodInternalError, match="left.open"):
            hub.step_end()  # the tick's check escalates
        hvd.synchronize(left)
        insp.check()
        assert registry.snapshot()["stall.pending"] == 0.0
    finally:
        hvd.shutdown()
        telemetry._reset_hub()


def test_stall_check_disable(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_STALL_CHECK_DISABLE", "1")
    hvd.init(device="cpu")
    try:
        assert basics.state().stall_inspector is None
        assert basics.state().fusion.stall_inspector is None
        hvd.allreduce(torch.ones(2))
    finally:
        hvd.shutdown()
