"""The collective-schedule audit in the port (``horovod_tpu_torch/
analysis/sched_audit.py``, ``HOROVOD_SCHED_AUDIT``) against the JAX
package's (oracle ``tests/test_analysis.py``: ``TestScheduleRecorder``,
``TestDriverSchedDivergence``, ``TestMultiProcessSkewedSchedule``).

One gloo world of 8 ranks for the file (the JAX package's 8-device mesh,
so the folded shapes are the same), two nodes of 4 with the two-level
route on, runs the same fused dispatches as the JAX ``FusionManager``:
flat and two-level, grouped, bf16, a process set. Every rank's
fingerprint equals the JAX package's, hex for hex. Then rank 1 adds one
dispatch the others do not, the ranks publish through a live rendezvous
KV with their heartbeats fresh, and the port's elastic driver restarts
the gang with reason ``sched_divergence`` naming rank 1 and the first
divergent dispatch, as the JAX functions name it."""

import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from horovod_tpu.analysis import sched_audit as jsched
from horovod_tpu_torch.analysis import sched_audit
from test_torch_collectives import _run, file_store

N = 8
INTRA = 4
SKEW_STEP = 5

# (name, shape, op, compression, grouped): the fused dispatches, in order
SEQ = [
    (None, (32,), "Sum", None, False),
    ("grad/w", (64,), "Average", None, False),
    (None, [(16,), (3, 4)], "Sum", None, True),
    (None, (8,), "Min", None, False),
    ("bf16", (32,), "Sum", "bf16", False),
    ("flat", (12,), "Sum", "join", False),
]
PSET = [0, 1, 2, 3]


def _dispatch(hvd, seq, tensor_of):
    """Run ``seq`` through ``hvd``'s eager API (either package)."""
    for name, shape, op, comp, grouped in seq:
        kw = {"op": getattr(hvd, op)}
        if name is not None:
            kw["name"] = name
        if comp == "bf16":
            kw["compression"] = hvd.Compression.bf16
        if grouped:
            hvd.grouped_allreduce([tensor_of(s) for s in shape], **kw)
        elif comp == "join":
            with hvd.join_ranks([]):  # a join mask keeps the batch flat
                hvd.allreduce(tensor_of(shape), **kw)
        else:
            hvd.allreduce(tensor_of(shape), **kw)


def _sched_worker(rank, n, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import sched_audit as sa
    from horovod_tpu_torch.common.config import TrainConfig
    from horovod_tpu_torch.runner.rendezvous import (_client_from_cfg,
                                                     put_heartbeat)

    hvd.init(device="cpu", store=file_store(outdir, n))
    ps = hvd.add_process_set(PSET)
    own = hvd.add_process_set([1])
    out = {}
    sa.reset()
    _dispatch(hvd, SEQ, lambda s: torch.full(s, float(rank + 1)))
    out["seq"] = sa.recorder().snapshot()
    out["hier_dispatches"] = hvd.common.basics.state().fusion.hier_dispatches
    if rank in PSET:
        hvd.allreduce(torch.ones(5), op=hvd.Sum, process_set=ps)
        out["pset"] = sa.recorder().snapshot()
    # the skew: rank 1 runs one dispatch the others never enter
    sa.reset()
    for _ in range(3):
        hvd.allreduce(torch.ones(32), op=hvd.Sum)
    if rank == 1:
        hvd.allreduce(torch.ones(48), op=hvd.Sum, process_set=own)
    client = _client_from_cfg(TrainConfig.from_env())
    put_heartbeat(client, rank)
    out["published"] = sa.publish(step=SKEW_STEP, rank=rank)
    out["skew"] = sa.recorder().snapshot()
    hvd.shutdown()
    torch.save(out, f"{outdir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's world, publishing into a live rendezvous KV."""
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer

    server = RendezvousServer()
    port = server.start()
    try:
        outs = _run(tmp_path_factory.mktemp("sched"), N, Path(__file__),
                    "_sched_worker", 180,
                    {"HOROVOD_INTRA_SIZE": str(INTRA),
                     "HOROVOD_HIERARCHICAL": "on",
                     "HOROVOD_SCHED_AUDIT": "1",
                     "HOROVOD_GLOO_RENDEZVOUS_ADDR": "127.0.0.1",
                     "HOROVOD_GLOO_RENDEZVOUS_PORT": str(port)})
        yield outs, server
    finally:
        server.stop()


@pytest.fixture(scope="module")
def jax_snapshots():
    """The JAX package's fingerprints of the same dispatches, on its
    8-device mesh with the same two-level split."""
    import horovod_tpu as jhvd

    mp = pytest.MonkeyPatch()
    mp.setenv("HOROVOD_INTRA_SIZE", str(INTRA))
    mp.setenv("HOROVOD_HIERARCHICAL", "on")
    mp.setenv("HOROVOD_SCHED_AUDIT", "1")
    jhvd.shutdown()
    jhvd.init()
    try:
        mesh = jhvd.mesh()

        def tensor_of(s):
            return jhvd.shard_from_rank_fn(
                lambda r: np.full(s, r + 1.0, np.float32), mesh)

        ps = jhvd.add_process_set(PSET)
        jsched.reset()
        _dispatch(jhvd, SEQ, tensor_of)
        seq = jsched.recorder().snapshot()
        jhvd.allreduce(tensor_of((5,)), op=jhvd.Sum, process_set=ps)
        pset = jsched.recorder().snapshot()
        from horovod_tpu.common import basics as jbasics

        hier = jbasics._state.fusion.hier_dispatches
    finally:
        jsched.reset()
        jhvd.shutdown()
        mp.undo()
    return {"seq": seq, "pset": pset, "hier": hier}


def test_same_dispatches_same_fingerprint_as_jax(world, jax_snapshots):
    outs, _ = world
    want = jax_snapshots["seq"]
    for rank, out in enumerate(outs):
        got = out["seq"]
        assert got["dispatches"] == want["dispatches"] == len(SEQ), rank
        assert got["ring"] == want["ring"], rank
        assert got["fingerprint"] == want["fingerprint"], rank
    # the two-level route ran in both: every Sum/Average float batch
    # but the joined one
    assert outs[0]["hier_dispatches"] == jax_snapshots["hier"] == 4


def test_process_set_dispatch_folds_as_jax(world, jax_snapshots):
    outs, _ = world
    for rank in PSET:
        assert outs[rank]["pset"] == jax_snapshots["pset"], rank
    assert all("pset" not in outs[r] for r in range(N) if r not in PSET)


def test_skewed_rank_named_as_the_reference_names_it(world):
    outs, _ = world
    entries = {r: dict(o["skew"], step=SKEW_STEP) for r, o in
               enumerate(outs)}
    assert sched_audit.find_divergent(entries) == \
        jsched.find_divergent(entries) == (SKEW_STEP, (1,))
    bad, good = entries[1], entries[0]
    assert sched_audit.first_divergent_index(bad, good) == \
        jsched.first_divergent_index(bad, good) == 3


def test_driver_flags_sched_divergence_before_stall_window(world,
                                                           monkeypatch):
    """The ranks published over HTTP into the live KV with fresh
    heartbeats; the driver quarantines rank 1's host with reason
    sched_divergence while no stall window has run out."""
    from horovod_tpu_torch.elastic.discovery import HostDiscovery
    from horovod_tpu_torch.elastic.driver import ElasticDriver
    from horovod_tpu_torch.runner.hosts import HostInfo
    from horovod_tpu_torch.runner.rendezvous import (read_heartbeats,
                                                     read_sched_fingerprints)

    outs, server = world
    assert all(o["published"] for o in outs)
    monkeypatch.setenv("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", "300")

    class Fake(HostDiscovery):
        def find_available_hosts_and_slots(self):
            return [HostInfo(f"h{r}", 1) for r in range(N)]

    d = ElasticDriver(Fake(), ["true"], min_np=1)
    d.host_manager.refresh()
    d._server = server
    d._blocks = [{"HOROVOD_RANK": str(r), "HOROVOD_HOSTNAME": f"h{r}"}
                 for r in range(N)]
    beats = read_heartbeats(server.store)
    assert sorted(beats) == list(range(N))
    assert max(time.time() - ts for ts in beats.values()) < 300
    assert sorted(read_sched_fingerprints(server.store)) == list(range(N))
    d._last_audit_poll = -1e9
    reason = d._poll_audit(time.monotonic())
    assert reason == (f"sched_divergence: ranks 1 at audit step {SKEW_STEP} "
                      "(first divergent dispatch #3)")
    assert d.host_manager.is_blacklisted("h1")
    assert not d.host_manager.is_blacklisted("h0")
    d._last_audit_poll = -1e9
    assert d._poll_audit(time.monotonic()) is None  # judged once


# ------------------------------------------- the driver on a fake KV


def _driver_with_store():
    from horovod_tpu_torch.elastic.discovery import HostDiscovery
    from horovod_tpu_torch.elastic.driver import ElasticDriver
    from horovod_tpu_torch.runner.hosts import HostInfo
    from horovod_tpu_torch.runner.rendezvous import KVStore

    class Fake(HostDiscovery):
        def find_available_hosts_and_slots(self):
            return [HostInfo("a", 2), HostInfo("b", 6)]

    d = ElasticDriver(Fake(), ["true"], min_np=1)
    d.host_manager.refresh()
    d._server = types.SimpleNamespace(store=KVStore())
    d._blocks = [{"HOROVOD_RANK": str(r), "HOROVOD_HOSTNAME": h}
                 for r, h in enumerate(["a"] * 2 + ["b"] * 6)]
    return d


def _recorders(extra_on_bad=True):
    good = sched_audit.ScheduleRecorder()
    for _ in range(3):
        good.record("allreduce:2", ("t", (32,), "float32"))
    g = good.snapshot()
    if extra_on_bad:
        good.record("allreduce:2", ("EXTRA", (48,), "float32"))
    return g, good.snapshot()


def test_driver_quarantine_reason_and_dispatch_index():
    from horovod_tpu_torch.common.metrics import registry
    from horovod_tpu_torch.runner.rendezvous import put_sched

    d = _driver_with_store()
    good, bad = _recorders()
    before = registry.snapshot().get("driver.sched_divergence_restarts", 0)
    for rank in range(8):
        snap = bad if rank == 1 else good
        put_sched(d._server.store, rank, 9, snap["fingerprint"],
                  snap["dispatches"], snap["ring"])
    d._last_audit_poll = -1e9
    reason = d._poll_audit(time.monotonic())
    assert reason == ("sched_divergence: ranks 1 at audit step 9 (first "
                      "divergent dispatch #3)")
    assert d.host_manager.is_blacklisted("a")
    assert not d.host_manager.is_blacklisted("b")
    assert registry.snapshot()["driver.sched_divergence_restarts"] \
        - before == 1
    d._last_audit_poll = -1e9
    assert d._poll_audit(time.monotonic()) is None


def test_sched_agreement_falls_through_to_param_audit():
    from horovod_tpu_torch.runner.rendezvous import put_audit, put_sched

    d = _driver_with_store()
    good, _ = _recorders()
    for rank in range(8):
        put_sched(d._server.store, rank, 4, good["fingerprint"],
                  good["dispatches"], good["ring"])
        put_audit(d._server.store, rank, 4, "good" if rank != 2 else "evil")
    d._last_audit_poll = -1e9
    reason = d._poll_audit(time.monotonic())
    assert reason is not None and reason.startswith("divergence")
    assert "2" in reason


# ------------------------------------------------- the recorder itself


@pytest.mark.parametrize("n,extra", [(3, 0), (299, 1), (300, 0),
                                     (130, 2)])
def test_recorder_equals_the_reference(n, extra):
    """Rolling fingerprint, ring and first divergent index, digest for
    digest, including full rings."""
    recs = [sched_audit.ScheduleRecorder(), jsched.ScheduleRecorder()]
    for r in recs:
        for i in range(n):
            r.record("allreduce:2", ("t", (i % 7,), "float32"),
                     wire="int8" if i % 5 == 0 else None, pset=i % 3)
    good = [r.snapshot() for r in recs]
    for r in recs:
        for _ in range(extra):
            r.record("allreduce:2", ("EXTRA", (48,), "float32"))
    bad = [r.snapshot() for r in recs]
    assert good[0] == good[1] and bad[0] == bad[1]
    assert len(bad[0]["ring"]) == min(n + extra, 128)
    assert sched_audit.first_divergent_index(bad[0], good[0]) == \
        jsched.first_divergent_index(bad[1], good[1])


def test_disabled_by_env(monkeypatch):
    monkeypatch.setenv("HOROVOD_SCHED_AUDIT", "0")
    sched_audit.reset()
    sched_audit.record("allreduce:2", ("t", (4,), "float32"))
    assert sched_audit.recorder().dispatch_count == 0
    assert sched_audit.publish(step=1, rank=0) is False
    monkeypatch.setenv("HOROVOD_SCHED_AUDIT", "1")
    sched_audit.record("allreduce:2", ("t", (4,), "float32"))
    assert sched_audit.recorder().dispatch_count == 1
    sched_audit.reset()


@pytest.mark.parametrize("name,want", [
    ("allreduce.noname.7", "allreduce"),
    ("grouped_allreduce.noname.42.0", "grouped_allreduce.0"),
    ("grouped_allreduce.noname.9000.0", "grouped_allreduce.0"),
    ("my_grad/layer0", "my_grad/layer0"),
    ("", ""),
])
def test_entry_names_fold_as_the_reference(name, want):
    from horovod_tpu.ops.fusion import _sched_entry_name as jname
    from horovod_tpu_torch.ops.fusion import _sched_entry_name

    assert _sched_entry_name(name) == jname(name) == want


def test_kv_round_trip_equals_the_reference():
    from horovod_tpu.runner import rendezvous as jrdv
    from horovod_tpu_torch.runner import rendezvous as rdv

    stores = rdv.KVStore(), jrdv.KVStore()
    rdv.put_sched(stores[0], 3, 17, "abcd", 42, [[41, "ffff"]])
    jrdv.put_sched(stores[1], 3, 17, "abcd", 42, [[41, "ffff"]])
    for store in stores:
        store.put("sched", "bogus", b"not json")
    got, want = (rdv.read_sched_fingerprints(stores[0]),
                 jrdv.read_sched_fingerprints(stores[1]))
    assert set(got) == {3}
    assert got[3].pop("ts") > 0 and want[3].pop("ts") > 0
    assert got == want
