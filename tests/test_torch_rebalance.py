"""The straggler rebalance and the expert-load ledger of the port's
elastic driver against the JAX driver, mirroring
``tests/test_hier_wire.py``'s ``TestRebalance`` and
``tests/test_moe_wire.py``'s ``TestExpertLoadKV``.

Both drivers get the same heartbeats (through their stall inspectors)
and the same KV contents, under one injected clock; their published
weights and their ``driver.rebalance.*`` and ``driver.expert_load.*``
gauges must be equal, exactly. The KV payloads are the same JSON bytes
in both packages, and each package reads what the other wrote. The
worker's helpers degrade to ``{}``, 1.0 and ``False`` outside an
elastic job."""

import json
import time
import types

import pytest

from horovod_tpu.common.metrics import registry as jregistry
from horovod_tpu.elastic import driver as jdriver_mod
from horovod_tpu.elastic.discovery import HostDiscovery as JHostDiscovery
from horovod_tpu.elastic.driver import ElasticDriver as JElasticDriver
from horovod_tpu.runner import rendezvous as jrdv
from horovod_tpu.runner.hosts import HostInfo as JHostInfo
from horovod_tpu_torch.common.metrics import registry
from horovod_tpu_torch.elastic import driver as driver_mod
from horovod_tpu_torch.elastic import worker as worker_mod
from horovod_tpu_torch.elastic.discovery import HostDiscovery
from horovod_tpu_torch.elastic.driver import ElasticDriver
from horovod_tpu_torch.runner import rendezvous as rdv
from horovod_tpu_torch.runner.hosts import HostInfo

REBALANCE = ("driver.rebalance.active", "driver.rebalance.updates")
EXPERT = ("driver.expert_load.ranks", "driver.expert_load.imbalance",
          "driver.expert_load.drop_rate")


class _Disc(HostDiscovery):
    def find_available_hosts_and_slots(self):
        return [HostInfo("a", 4), HostInfo("b", 4)]


class _JDisc(JHostDiscovery):
    def find_available_hosts_and_slots(self):
        return [JHostInfo("a", 4), JHostInfo("b", 4)]


def _drivers(monkeypatch, enabled=True):
    monkeypatch.delenv("HOROVOD_WARM_STANDBY", raising=False)
    if enabled:
        monkeypatch.setenv("HOROVOD_REBALANCE", "1")
    else:
        monkeypatch.delenv("HOROVOD_REBALANCE", raising=False)
    j = JElasticDriver(_JDisc(), ["true"], min_np=1)
    j._server = types.SimpleNamespace(store=jrdv.KVStore())
    p = ElasticDriver(_Disc(), ["true"], min_np=1)
    p._server = types.SimpleNamespace(store=rdv.KVStore())
    jregistry.reset()
    registry.reset()
    return j, p


def _beat(drivers, p50s, ts):
    for d in drivers:
        for r, ms in p50s.items():
            d.stall_inspector.record_heartbeat(r, ts=ts, step=100,
                                               step_ms_p50=ms)
        d.stall_inspector.check()


def _gauges(names):
    js, ps = jregistry.snapshot(), registry.snapshot()
    return ({n: js.get(n) for n in names}, {n: ps.get(n) for n in names})


def _weights(j, p):
    return (jrdv.read_rebalance_weights(j._server.store),
            rdv.read_rebalance_weights(p._server.store))


def test_down_weights_a_persistent_straggler_and_resets(monkeypatch):
    j, p = _drivers(monkeypatch)
    p50s = {0: 100.0, 1: 100.0, 2: 100.0, 3: 800.0}
    now = time.time()
    seen = []
    for k, p3 in enumerate((800.0, 800.0, 100.0)):
        p50s[3] = p3
        _beat((j, p), p50s, now + 10 * k)
        j._maybe_rebalance()
        p._maybe_rebalance()
        want, got = _weights(j, p)
        assert got == want
        jg, pg = _gauges(REBALANCE)
        assert pg == jg
        seen.append(got)
    # streak 1: nothing; streak 2: rank 3 down; recovery: the reset map
    assert seen[0] == {}
    assert seen[1] == {0: 1.0, 1: 1.0, 2: 1.0, 3: 0.25}  # 100/800, clamped
    assert all(v == 1.0 for v in seen[2].values())
    assert registry.snapshot()["driver.rebalance.updates"] == 2
    assert registry.snapshot()["driver.rebalance.active"] == 0


def test_moderate_straggler_weight_is_the_median_ratio(monkeypatch):
    j, p = _drivers(monkeypatch)
    p50s = {0: 100.0, 1: 110.0, 2: 90.0, 3: 100.0, 4: 350.0}
    now = time.time()
    for k in range(2):
        _beat((j, p), p50s, now + k)
        j._maybe_rebalance()
        p._maybe_rebalance()
    want, got = _weights(j, p)
    assert got == want and got[4] == round(100.0 / 350.0, 2) == 0.29
    assert _gauges(REBALANCE)[1] == _gauges(REBALANCE)[0]


def test_stale_stamp_does_not_advance(monkeypatch):
    j, p = _drivers(monkeypatch)
    p50s = {0: 100.0, 1: 100.0, 2: 800.0}
    now = time.time()
    _beat((j, p), p50s, now)
    _beat((j, p), p50s, now)  # the driver polls faster than workers beat
    j._maybe_rebalance()
    p._maybe_rebalance()
    assert _weights(j, p) == ({}, {})


def test_disabled_publishes_nothing(monkeypatch):
    j, p = _drivers(monkeypatch, enabled=False)
    now = time.time()
    for k in range(2):
        _beat((j, p), {0: 100.0, 1: 900.0}, now + 10 * k)
    j._maybe_rebalance()
    p._maybe_rebalance()
    assert _weights(j, p) == ({}, {})
    assert _gauges(REBALANCE) == ({n: None for n in REBALANCE},) * 2


def test_weights_payload_is_byte_compatible(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    js, ps = jrdv.KVStore(), rdv.KVStore()
    jrdv.put_rebalance_weights(js, {0: 1.0, 3: 0.5}, epoch=2)
    rdv.put_rebalance_weights(ps, {0: 1.0, 3: 0.5}, epoch=2)
    assert ps.get(rdv.REBALANCE_SCOPE, "weights") == \
        js.get(jrdv.REBALANCE_SCOPE, "weights")
    assert rdv.REBALANCE_SCOPE == jrdv.REBALANCE_SCOPE
    # each reads the other's
    assert rdv.read_rebalance_weights(js) == jrdv.read_rebalance_weights(
        ps) == {0: 1.0, 3: 0.5}
    for store in (js, ps):
        store.put(rdv.REBALANCE_SCOPE, "weights", b"\xff not json")
    assert rdv.read_rebalance_weights(ps) == \
        jrdv.read_rebalance_weights(js) == {}


def test_worker_helpers_degrade_outside_elastic(monkeypatch):
    from horovod_tpu.elastic import worker as jworker

    for name in ("HOROVOD_GLOO_RENDEZVOUS_ADDR",
                 "HOROVOD_GLOO_RENDEZVOUS_PORT"):
        monkeypatch.delenv(name, raising=False)
    worker_mod._reset_rebalance_cache()
    jworker._reset_rebalance_cache()
    got = (worker_mod.rebalance_weights(), worker_mod.rebalance_weight(3),
           worker_mod.publish_expert_load([1.0], 0.0, 1.0),
           worker_mod.expert_loads())
    want = (jworker.rebalance_weights(), jworker.rebalance_weight(rank=3),
            jworker.publish_expert_load([1.0], 0.0, 1.0),
            jworker.expert_loads())
    assert got == want == ({}, 1.0, False, {})


def test_worker_reads_and_publishes_through_the_kv(monkeypatch):
    """The worker's side over a live KV server: the driver's weights
    read back (and cached), its expert load published where the JAX
    driver's reader finds it."""
    server = rdv.RendezvousServer()
    port = server.start()
    try:
        monkeypatch.setenv("HOROVOD_GLOO_RENDEZVOUS_ADDR", "127.0.0.1")
        monkeypatch.setenv("HOROVOD_GLOO_RENDEZVOUS_PORT", str(port))
        monkeypatch.delenv("HOROVOD_SECRET_KEY", raising=False)
        monkeypatch.setenv("HOROVOD_RANK", "2")
        worker_mod._reset_rebalance_cache()
        assert worker_mod.rebalance_weights(max_age_s=0) == {}
        rdv.put_rebalance_weights(server.store, {2: 0.5, 0: 1.0})
        assert worker_mod.rebalance_weight() == 1.0  # the cached read
        assert worker_mod.rebalance_weights(max_age_s=0) == {2: 0.5, 0: 1.0}
        assert worker_mod.rebalance_weight() == 0.5
        assert worker_mod.publish_expert_load([3.0, 5.0], 1.0, 9.0,
                                              capacity_factor=1.25)
        loads = jrdv.read_expert_loads(server.store)
        assert list(loads) == [2] and loads[2]["expert_tokens"] == [3.0, 5.0]
        assert loads[2]["capacity_factor"] == 1.25
        assert worker_mod.expert_loads()[2]["total"] == 9.0
    finally:
        worker_mod._reset_rebalance_cache()
        server.stop()


# ------------------------------------------------------- expert-load KV


def test_expert_load_roundtrip_and_malformed(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 99.0)
    js, ps = jrdv.KVStore(), rdv.KVStore()
    for mod, store in ((jrdv, js), (rdv, ps)):
        mod.put_expert_load(store, 3, [1.0, 2.0], dropped=1.0, total=4.0,
                            capacity_factor=1.5)
        store.put(mod.EXPERT_LOAD_SCOPE, "9", b"\xff not json")
        store.put(mod.EXPERT_LOAD_SCOPE, "bad", json.dumps({"x": 1}).encode())
    assert rdv.EXPERT_LOAD_SCOPE == jrdv.EXPERT_LOAD_SCOPE
    assert ps.get(rdv.EXPERT_LOAD_SCOPE, "3") == \
        js.get(jrdv.EXPERT_LOAD_SCOPE, "3")
    assert rdv.read_expert_loads(js) == jrdv.read_expert_loads(ps) == \
        jrdv.read_expert_loads(js)
    loads = rdv.read_expert_loads(ps)
    assert list(loads) == [3] and loads[3]["expert_tokens"] == [1.0, 2.0]
    assert loads[3]["capacity_factor"] == 1.5


def test_driver_aggregates_expert_loads_with_staleness(monkeypatch):
    j, p = _drivers(monkeypatch, enabled=False)
    clock = {"t": 1000.0}
    monkeypatch.setattr(time, "monotonic", lambda: clock["t"])
    p._clock = lambda: clock["t"]
    stamps = iter(float(t) for t in range(1, 100))
    monkeypatch.setattr(time, "time", lambda: next(stamps))

    def put(rank, hist, dropped, total):
        for mod, d in ((jrdv, j), (rdv, p)):
            mod.put_expert_load(d._server.store, rank, hist, dropped=dropped,
                                total=total)

    def poll():
        j._poll_expert_loads()
        p._poll_expert_loads()
        jg, pg = _gauges(EXPERT)
        assert pg == jg
        return pg

    put(0, [10.0, 30.0], 10.0, 50.0)
    put(1, [0.0, 40.0], 0.0, 40.0)
    g = poll()
    # fleet hist [10, 70], kept 80, mean 40: imbalance 1.75
    assert g["driver.expert_load.ranks"] == 2
    assert g["driver.expert_load.imbalance"] == pytest.approx(1.75)
    assert g["driver.expert_load.drop_rate"] == pytest.approx(10.0 / 90.0)
    # rank 0 advances; rank 1's stamp is frozen and ages out after the
    # stale window of the drivers' clock
    clock["t"] += 30.0
    put(0, [20.0, 20.0], 0.0, 40.0)
    assert poll()["driver.expert_load.ranks"] == 2
    clock["t"] += 31.0
    put(0, [20.0, 20.0], 0.0, 40.0)
    g = poll()
    assert g["driver.expert_load.ranks"] == 1
    assert g["driver.expert_load.drop_rate"] == 0.0
    assert driver_mod._EXPERT_LOAD_STALE_S == \
        jdriver_mod._EXPERT_LOAD_STALE_S == 60.0
    assert driver_mod._REBALANCE_STREAK == jdriver_mod._REBALANCE_STREAK
