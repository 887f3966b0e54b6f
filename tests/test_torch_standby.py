"""Warm standby in the port (``HOROVOD_WARM_STANDBY``): the elastic
driver's reservation, swap-in and serve scale-up
(``horovod_tpu_torch/elastic/driver.py``) and the warmer's lifecycle
(``elastic/standby.py``), each against the JAX package's driver and
warmer on the same hosts and the same state (oracle
``tests/test_exe_cache.py::TestWarmStandby``). The warmers the drivers
track are fakes (None), as in the reference's tests: nothing here starts
a process or imports torch for a warmer."""

import types

import pytest

from horovod_tpu.elastic.discovery import HostDiscovery as JHostDiscovery
from horovod_tpu.elastic.driver import ElasticDriver as JElasticDriver
from horovod_tpu.runner import rendezvous as jrdv
from horovod_tpu.runner.hosts import HostInfo as JHostInfo
from horovod_tpu_torch.common.metrics import registry
from horovod_tpu_torch.elastic.discovery import HostDiscovery
from horovod_tpu_torch.elastic.driver import ElasticDriver
from horovod_tpu_torch.runner import rendezvous as rdv
from horovod_tpu_torch.runner.hosts import HostInfo


def _driver(port: bool, hosts, **kw):
    """The port's driver (or the JAX package's) over a fixed host list,
    with a KV store in place of the HTTP server."""
    base, info, cls = ((HostDiscovery, HostInfo, ElasticDriver) if port
                       else (JHostDiscovery, JHostInfo, JElasticDriver))

    class Fake(base):
        def __init__(self):
            self.hosts = [info(h, s) for h, s in hosts]

        def find_available_hosts_and_slots(self):
            return list(self.hosts)

    kw.setdefault("min_np", 2)
    d = cls(Fake(), ["true"], **kw)
    d.host_manager.refresh()
    d._server = types.SimpleNamespace(
        store=(rdv if port else jrdv).KVStore())
    return d


@pytest.fixture(autouse=True)
def _standby(monkeypatch):
    monkeypatch.setenv("HOROVOD_WARM_STANDBY", "1")


def _both(hosts, scenario):
    """Run ``scenario(driver)`` on the port's driver and the JAX one;
    returns their observations, which must agree."""
    got = scenario(_driver(True, hosts))
    want = scenario(_driver(False, hosts))
    assert got == want
    return got


def test_knob_starts_a_driver():
    """HOROVOD_WARM_STANDBY=1 raised before the standby was ported."""
    d = _driver(True, [("a", 2), ("b", 2)])
    assert d._warm_standby == 1


def test_reservation_holds_excess_host():
    def scenario(d):
        a = d.compute_assignment()
        return a.world_size, a.hostnames, sorted(d._standby_current)

    assert _both([("a", 2), ("b", 2)], scenario) == (2, ["a"], ["b"])


@pytest.mark.parametrize("hosts", [[("a", 2)], [("a", 1), ("b", 1)]])
def test_tight_capacity_reserves_nothing(hosts):
    def scenario(d):
        a = d.compute_assignment()
        return a.hostnames, sorted(d._standby_current)

    got = _both(hosts, scenario)
    assert got == ([h for h, _ in hosts], [])


def test_host_failure_swaps_standby_in():
    def scenario(d):
        d.compute_assignment()
        d._standby_warmers["b"] = None  # a tracked (fake) warmer
        d.handle_host_failure("a")
        a = d.compute_assignment()
        return ("b" in d._standby_released, a.hostnames, a.world_size,
                d._standby_swapins,
                d._server.store.get(rdv.STANDBY_SCOPE, "release.b"))

    before = registry.snapshot().get("driver.standby.swapins", 0.0)
    assert _both([("a", 2), ("b", 2)], scenario) == (True, ["b"], 2, 1,
                                                     b"1")
    assert registry.snapshot()["driver.standby.swapins"] - before == 1


def test_released_standby_is_never_rereserved():
    def scenario(d):
        d.compute_assignment()
        d._standby_warmers["b"] = None
        d._release_standby("test")
        a = d.compute_assignment()
        # the pool may backfill another host as the next standby, but
        # never "b" again
        return sorted(d._standby_current), a.hostnames

    got = _both([("a", 2), ("b", 2), ("c", 2)], scenario)
    assert "b" not in got[0] and "b" in got[1]


def test_armed_standby_is_released_first():
    def scenario(d):
        d._warm_standby = 2
        d.compute_assignment()
        for hn in ("b", "c"):
            d._standby_warmers[hn] = None
        put = (rdv if isinstance(d, ElasticDriver) else jrdv).put_standby
        put(d._server.store, "b", "staging")
        put(d._server.store, "c", "armed", {"exes": 1})
        return d._release_standby("test"), sorted(d._standby_current)

    assert _both([("a", 2), ("b", 2), ("c", 2)], scenario) == ("c",
                                                              ["b", "c"])


def test_serve_saturation_releases_standby():
    def scenario(d):
        d.compute_assignment()
        d._standby_warmers["b"] = None
        d._maybe_scale_up(
            {"decode": {"workers": 2, "free_slots": 3, "free_pages": 8}})
        idle = d._scaleup_reason
        d._maybe_scale_up(
            {"decode": {"workers": 2, "free_slots": 0, "free_pages": 0}})
        return idle, d._scaleup_reason, "b" in d._standby_released

    idle, reason, released = _both([("a", 2), ("b", 2)], scenario)
    assert idle is None and released
    assert reason == "serve scaleup: standby b absorbs saturated role(s) " \
                     "decode"


def test_saturation_reaches_the_restart_through_the_serve_poll():
    """The port's serve-capacity poll feeds the scale-up, and the next
    heartbeat poll returns its reason; the restart stamp it writes is
    warm and of kind scaleup, which a worker of the next epoch
    publishes as serve.scaleup_ms and elastic.restart_warm."""
    from horovod_tpu_torch.elastic.worker import WorkerNotificationManager

    d = _driver(True, [("a", 2), ("b", 2)])
    d.compute_assignment()
    d._standby_warmers["b"] = None
    for rank in range(2):
        rdv.put_announcement(d._server.store, rank, {
            "ts": 1.0 + rank, "port": 8000 + rank, "role": "decode",
            "free_slots": 0, "free_pages": 0})
    reason = d._poll_heartbeats(1e9)
    assert reason.startswith("serve scaleup: standby b")
    assert d._reset(reason)
    stamp = rdv.read_restart_stamp(d._server.store)
    assert stamp["warm"] is True and stamp["kind"] == "scaleup"
    mgr = WorkerNotificationManager.__new__(WorkerNotificationManager)
    mgr._publish_restart_ms(d._server.store, str(stamp["epoch"]))
    snap = registry.snapshot()
    assert snap["elastic.restart_warm"] == 1.0
    assert snap["serve.scaleup_ms"] == snap["elastic.restart_ms"] >= 0.0


def test_quarantine_releases_a_standby():
    def scenario(d):
        d.compute_assignment()
        d._standby_warmers["b"] = None
        kept = d._try_blacklist(["a"], "straggler quarantine")
        return kept, sorted(d._standby_released), \
            d.compute_assignment().hostnames

    assert _both([("a", 2), ("b", 2)], scenario) == (True, ["b"], ["b"])


@pytest.mark.parametrize("state,detail", [
    ("announce", None),
    ("staging", None),
    ("armed", {"exes": 1, "exe_bytes": 4096, "ckpt_step": 7}),
    ("released", {"exes": 0, "exe_bytes": 0, "ckpt_step": None}),
])
def test_standby_channel_equals_the_reference(state, detail):
    """``put_standby``/``read_standbys`` hold the JAX package's
    payloads for the same state (the stamp aside), and a release marker
    is no announcement."""
    stores = [rdv.KVStore(), jrdv.KVStore()]
    rdv.put_standby(stores[0], "standby-1", state, detail)
    jrdv.put_standby(stores[1], "standby-1", state, detail)
    for store in stores:
        store.put(rdv.STANDBY_SCOPE, "release.standby-1", b"1")
    got, want = rdv.read_standbys(stores[0]), jrdv.read_standbys(stores[1])
    for view in (got, want):
        assert set(view) == {"standby-1"}
        assert view["standby-1"].pop("ts") > 0
    assert got == want


def test_standby_lifecycle_announce_stage_release(tmp_path, monkeypatch):
    """The warmer over the port's KV: announce, stage (torch, the
    entries of the topology loaded into Inductor's caches, the latest
    checkpoint), armed with what it staged, released by the driver's
    marker. ``device="cpu"``: no context and no kernel library here."""
    import torch

    from horovod_tpu_torch.common import exe_cache
    from horovod_tpu_torch.elastic.standby import StandbyWarmer

    monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", str(tmp_path / "ind"))
    base = str(tmp_path / "cache")
    torch._dynamo.reset()
    x, w = torch.ones(4, 8), torch.ones(8, 2)
    compiled = torch.compile(lambda x, w: torch.mm(x, w), fullgraph=True,
                             backend=exe_cache.backend(base=base))
    assert torch.equal(compiled(x, w), x @ w)
    torch._dynamo.reset()
    assert exe_cache.flush(10)
    store = rdv.KVStore()
    seen = []
    put = rdv.put_standby

    def record(client, host, state, detail=None):
        seen.append(state)
        put(client, host, state, detail)

    monkeypatch.setattr(rdv, "put_standby", record)
    w = StandbyWarmer(store, "standby-1", exe_cache_base=base, device="cpu")
    monkeypatch.setattr(w._stop, "wait", lambda t: store.put(
        rdv.STANDBY_SCOPE, "release.standby-1", b"1"))
    assert w.run() == 0
    assert seen == ["announce", "staging", "armed", "armed", "released"]
    st = rdv.read_standbys(store)["standby-1"]
    assert st["state"] == "released"
    assert st["exes"] == 1 and st["exe_bytes"] > 0
    assert st["device"] == "cpu" and st["kernels"] == 0
    assert st["stage_s"] >= st["import_s"] >= 0.0


def test_warmer_stages_the_card_by_default(monkeypatch):
    """No device named: the local rank's card, never the CPU."""
    import torch

    from horovod_tpu_torch.elastic.standby import StandbyWarmer

    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without a card")
    w = StandbyWarmer(rdv.KVStore(), "h")
    with pytest.raises(RuntimeError, match="CUDA"):
        w.stage()
