"""The port's elastic path (``horovod_tpu_torch/elastic/``) and audit,
after the JAX package's ``tests/test_elastic.py``,
``tests/test_hvdrun_elastic.py`` and ``tests/test_shim_elastic_state.py``:
``find_divergent``, the driver's assignments over the same fake
discovery, ``ElasticSampler``'s streams, all equal to the JAX package's;
``TorchState`` commit, restore and sync with the error-feedback
residuals; ``run``'s two exceptions; the driver's blacklist, reset
limit and notification; the deferred knobs; and the composed story end
to end through ``python -m horovod_tpu_torch.runner``: a rank's host
dies, the gang shrinks from 4 to 3, resumes from the durable commit and
consumes every sample once."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from typing import List

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.audit import find_divergent as jfind_divergent
from horovod_tpu.elastic.discovery import HostDiscovery as JHostDiscovery
from horovod_tpu.elastic.driver import ElasticDriver as JElasticDriver
from horovod_tpu.runner.hosts import HostInfo as JHostInfo
import importlib
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common import guard as _guard
from horovod_tpu_torch.common.metrics import registry
from horovod_tpu_torch.elastic import (
    ElasticDriver,
    ElasticSampler,
    HostDiscovery,
    HostDiscoveryScript,
    ObjectState,
    TorchState,
    WorkerNotificationManager,
)
from horovod_tpu_torch.runner.hosts import HostInfo
from horovod_tpu_torch.runner.rendezvous import (
    RendezvousServer,
    read_audit_digests,
    read_heartbeats,
)

from test_torch_collectives import _run, file_store

# ``hvd.audit`` is the function; the module by its name
audit = importlib.import_module("horovod_tpu_torch.audit")

REPO = Path(__file__).resolve().parent.parent
HERE = Path(__file__)


class FakeDiscovery(HostDiscovery):
    def __init__(self, hosts: List[HostInfo]):
        self.hosts = list(hosts)

    def find_available_hosts_and_slots(self):
        return list(self.hosts)


class JFakeDiscovery(JHostDiscovery):
    def __init__(self, hosts):
        self.hosts = list(hosts)

    def find_available_hosts_and_slots(self):
        return list(self.hosts)


DIVERGENCE_CASES = [
    {},
    {0: {"step": 5, "digest": "a"}},
    {0: {"step": 5, "digest": "a"}, 1: {"step": 5, "digest": "a"}},
    {0: {"step": 5, "digest": "a"}, 1: {"step": 5, "digest": "b"},
     2: {"step": 5, "digest": "a"}},
    {0: {"step": 5, "digest": "b"}, 1: {"step": 5, "digest": "a"}},
    {0: {"step": 6, "digest": "x"}, 1: {"step": 5, "digest": "a"},
     2: {"step": 5, "digest": "b"}, 3: {"step": 5, "digest": "b"}},
    {0: {"step": "bad"}, 1: {"step": 2, "digest": "a"},
     2: {"step": 2, "digest": "c"}},
]


@pytest.mark.parametrize("digests", DIVERGENCE_CASES)
def test_find_divergent_equals_jax(digests):
    assert audit.find_divergent(digests) == jfind_divergent(digests)


def test_tree_digest_sees_bits_dtypes_and_paths():
    tree = {"w": torch.arange(6.0).reshape(2, 3), "opt": {0: [torch.ones(2),
                                                              3]}}
    d = audit.tree_digest(tree)
    assert d == audit.tree_digest({"opt": {0: [torch.ones(2), 3]},
                                   "w": torch.arange(6.0).reshape(2, 3)})
    flipped = torch.arange(6.0).reshape(2, 3)
    flipped.view(torch.int32)[0, 0] ^= 1
    assert audit.tree_digest({"w": flipped, "opt": tree["opt"]}) != d
    assert audit.tree_digest({"w": tree["w"].double(),
                              "opt": tree["opt"]}) != d
    assert audit.tree_digest({"v": tree["w"], "opt": tree["opt"]}) != d
    assert audit.tree_meta_digest({"w": torch.zeros(2, 3),
                                   "opt": {0: [torch.zeros(2), 4]}}) == \
        audit.tree_meta_digest(tree)
    assert audit.tree_digest({"b": torch.ones(3, dtype=torch.bfloat16)})


def test_audit_cadence_and_publication(monkeypatch):
    server = RendezvousServer()
    port = server.start()
    monkeypatch.setenv("HOROVOD_GLOO_RENDEZVOUS_ADDR", "127.0.0.1")
    monkeypatch.setenv("HOROVOD_GLOO_RENDEZVOUS_PORT", str(port))
    monkeypatch.setenv("HOROVOD_AUDIT_STEPS", "4")
    audit._reset_client()
    try:
        tree = {"w": torch.ones(3)}
        assert audit.maybe_audit(tree, step=3) is None
        digest = audit.maybe_audit(tree, step=8, rank=2)
        assert digest == audit.tree_digest(tree)
        assert read_audit_digests(server.store)[2]["step"] == 8
        assert registry.snapshot()["audit.last_digest_step"] == 8
        assert audit.maybe_audit(tree, step=9, every=0) is None
    finally:
        audit._reset_client()
        server.stop()


@pytest.mark.parametrize("sequence", [
    [[("a", 4), ("b", 4)]],
    [[("a", 4), ("b", 4)], [("b", 4)]],
    [[("a", 2)], [("a", 2), ("b", 2), ("c", 2)]],
    [[("b", 1), ("a", 3)], []],
])
@pytest.mark.parametrize("min_np,max_np,per_host", [(2, 6, None), (1, None,
                                                                   None),
                                                    (4, 8, 2)])
def test_compute_assignment_equals_jax(sequence, min_np, max_np, per_host):
    mine = FakeDiscovery([])
    ref = JFakeDiscovery([])
    a = ElasticDriver(mine, ["true"], min_np, max_np,
                      slots_per_host=per_host)
    b = JElasticDriver(ref, ["true"], min_np, max_np,
                       slots_per_host=per_host)
    for step in sequence:
        mine.hosts = [HostInfo(h, s) for h, s in step]
        ref.hosts = [JHostInfo(h, s) for h, s in step]
        assert a.host_manager.refresh() == b.host_manager.refresh()
        got, want = a.compute_assignment(), b.compute_assignment()
        assert (got is None) == (want is None)
        if got is not None:
            assert [vars(s) for s in got.slots] == [vars(s)
                                                    for s in want.slots]


class _Proc:
    def __init__(self, rc):
        self.rc = rc

    def poll(self):
        return self.rc


def test_failure_blacklists_the_dead_ranks_host_only():
    """Two names of one machine: the signalled rank's host goes; the
    survivors that failed after it keep theirs."""
    d = ElasticDriver(FakeDiscovery([HostInfo("127.0.0.1", 1),
                                     HostInfo("localhost", 3)]),
                      ["true"], 2, 4)
    d.host_manager.refresh()
    blocks = [{"HOROVOD_HOSTNAME": h, "HOROVOD_RANK": str(r)}
              for r, h in enumerate(["127.0.0.1"] + ["localhost"] * 3)]
    d._procs = [_Proc(1), _Proc(-9), _Proc(1), _Proc(None)]
    d._blocks = blocks
    assert d._poll_gang() == -9
    assert d.host_manager.blacklisted == ["localhost"]
    d2 = ElasticDriver(FakeDiscovery([]), ["true"], 1)
    d2._procs, d2._blocks = [_Proc(-9), _Proc(1)], blocks[:2]
    assert d2._poll_gang() == -9
    assert d2.host_manager.blacklisted == ["127.0.0.1"]
    d2._procs = [_Proc(0), _Proc(0)]
    assert d2._poll_gang() == 0


# (exit codes, each rank's host, the host that died): remote hosts keep
# the JAX driver's rule, every failed worker's host goes
REMOTE_FAILURES = [
    # the dead host holds the higher ranks: its ssh sessions end 255,
    # the survivors' collectives 1
    ([1, 1, 255, 255], ["hostA", "hostA", "hostB", "hostB"], "hostB"),
    ([1, None, -9, None], ["hostA", "hostA", "hostB", "hostB"], "hostB"),
    ([None, 255, 1, 0], ["hostA", "hostB", "hostC", "hostD"], "hostB"),
]


@pytest.mark.parametrize("codes,hosts,dead", REMOTE_FAILURES)
def test_remote_failures_blacklist_as_the_jax_driver(codes, hosts, dead):
    slots = {h: hosts.count(h) for h in hosts}
    blocks = [{"HOROVOD_HOSTNAME": h, "HOROVOD_RANK": str(r)}
              for r, h in enumerate(hosts)]
    d = ElasticDriver(FakeDiscovery([HostInfo(h, s)
                                     for h, s in slots.items()]),
                      ["true"], 1, 4)
    ref = JElasticDriver(JFakeDiscovery([JHostInfo(h, s)
                                         for h, s in slots.items()]),
                         ["true"], 1, 4)
    for drv_ in (d, ref):
        drv_.host_manager.refresh()
        drv_._procs = [_Proc(rc) for rc in codes]
        drv_._blocks = blocks
    assert d._poll_gang() == codes[hosts.index(dead)]
    ref._poll_gang()
    assert dead in d.host_manager.blacklisted
    assert d.host_manager.blacklisted == ref.host_manager.blacklisted


def test_reset_limit_and_epoch():
    d = ElasticDriver(FakeDiscovery([HostInfo("a", 2)]), ["true"], 1,
                      reset_limit=2)
    server = d._rendezvous()
    try:
        assert d._reset("one") and d._reset("two")
        assert d.epoch == 2
        from horovod_tpu_torch.runner.rendezvous import read_restart_stamp

        assert read_restart_stamp(server.store)["epoch"] == 2
        assert not d._reset("three")
    finally:
        d.shutdown()


def test_driver_notifies_the_worker_manager(monkeypatch):
    d = ElasticDriver(FakeDiscovery([HostInfo("localhost", 1)]), ["true"],
                      1)
    server = d._rendezvous()
    for k, v in {"HOROVOD_GLOO_RENDEZVOUS_ADDR": "127.0.0.1",
                 "HOROVOD_GLOO_RENDEZVOUS_PORT": str(server.port),
                 "HOROVOD_SECRET_KEY": d._secret.hex(),
                 "HOROVOD_ELASTIC_EPOCH": "0", "HOROVOD_PROCESS_ID": "0",
                 "HOROVOD_RANK": "0", "HOROVOD_HOSTNAME": "localhost"}.items():
        monkeypatch.setenv(k, v)
    mgr = WorkerNotificationManager()
    mgr.init()
    try:
        assert server.store.get("workers.0", "0") is not None
        assert 0 in read_heartbeats(server.store) or mgr._hb_stop is not None
        d._notify_workers("hosts_updated")
        with pytest.raises(hvd.HostsUpdatedInterrupt):
            mgr.raise_if_updated()
        mgr.raise_if_updated()  # cleared
    finally:
        mgr.shutdown()
        d.shutdown()


def test_rebalance_driver_publishes_weights_for_a_flagged_rank(monkeypatch):
    """HOROVOD_REBALANCE=1 starts a driver (it raised before the
    rebalance was ported); the heartbeat poll down-weights a rank
    flagged for 2 fresh stamps, and a worker reads the weight."""
    import json as _json

    from horovod_tpu_torch.elastic import worker as wk
    from horovod_tpu_torch.runner.rendezvous import (
        HEARTBEAT_SCOPE, KVStore, read_rebalance_weights)

    monkeypatch.setenv("HOROVOD_REBALANCE", "1")
    monkeypatch.setenv("HOROVOD_STRAGGLER_QUARANTINE_POLLS", "0")
    d = ElasticDriver(FakeDiscovery([HostInfo("a", 4)]), ["true"], 1)
    d._server = type("S", (), {"store": KVStore()})()
    for beat in range(2):
        for r in range(4):
            d._server.store.put(HEARTBEAT_SCOPE, str(r), _json.dumps({
                "ts": 1e9 + beat, "step": 10,
                "step_ms_p50": 400.0 if r == 2 else 100.0}).encode())
        d._last_hb_poll = -1e9
        assert d._poll_heartbeats(0.0) is None
    assert read_rebalance_weights(d._server.store) == {
        0: 1.0, 1: 1.0, 2: 0.25, 3: 1.0}
    assert registry.snapshot()["driver.rebalance.active"] == 1
    monkeypatch.setattr(wk, "_kv_client", lambda: d._server.store)
    wk._reset_rebalance_cache()
    assert wk.rebalance_weight(rank=2) == 0.25
    assert wk.rebalance_weight(rank=0) == 1.0


def test_driver_quarantines_stragglers_by_default(monkeypatch):
    """The JAX driver's default (3 consecutive fresh heartbeats) holds
    in the port: a host whose ranks stay stragglers is blacklisted and
    the gang restarts without it; HOROVOD_STRAGGLER_QUARANTINE_POLLS
    sets the count and 0 observes only."""
    import json as _json

    from horovod_tpu_torch.runner.rendezvous import HEARTBEAT_SCOPE, KVStore

    monkeypatch.delenv("HOROVOD_STRAGGLER_QUARANTINE_POLLS", raising=False)
    d = ElasticDriver(FakeDiscovery([HostInfo("a", 1), HostInfo("b", 3)]),
                      ["true"], 1)
    assert d._quarantine_polls == 3
    d.host_manager.refresh()
    d._server = type("S", (), {"store": KVStore()})()
    d._blocks = [{"HOROVOD_RANK": str(r), "HOROVOD_HOSTNAME": h}
                 for r, h in enumerate("abbb")]
    reasons = []
    for beat in range(3):
        for r in range(4):
            d._server.store.put(HEARTBEAT_SCOPE, str(r), _json.dumps({
                "ts": 1e9 + beat, "step": 10,
                "step_ms_p50": 900.0 if r == 0 else 10.0}).encode())
        d._last_hb_poll = -1e9
        reasons.append(d._poll_heartbeats(0.0))
    assert reasons[:2] == [None, None] and "quarantine" in reasons[2]
    assert list(d.host_manager.blacklisted) == ["a"]
    monkeypatch.setenv("HOROVOD_STRAGGLER_QUARANTINE_POLLS", "0")
    assert ElasticDriver(FakeDiscovery([]), ["true"], 1)._quarantine_polls == 0


def test_driver_refuses_per_host_placement():
    with pytest.raises(ValueError, match="several cards"):
        ElasticDriver(FakeDiscovery([]), ["true"], 1, placement="per-host")


def test_discovery_script(tmp_path):
    script = tmp_path / "d.sh"
    script.write_text("#!/bin/sh\necho 127.0.0.1:1\necho localhost:3\n"
                      "echo bare\n")
    script.chmod(0o755)
    found = HostDiscoveryScript(str(script), default_slots=2)
    assert [(h.hostname, h.slots) for h in
            found.find_available_hosts_and_slots()] == [
        ("127.0.0.1", 1), ("localhost", 3), ("bare", 2)]


def test_object_state_and_guard_escalation_before_save():
    st = ObjectState(step=1, name="a")
    st.step = 5
    st.restore()
    assert st.step == 1
    g = _guard.guard()
    g.record_skip(1, 1, 1)
    st.step = 7
    with pytest.raises(hvd.HorovodInternalError):
        st.commit()
    st.restore()
    assert st.step == 1  # the escalated commit did not save
    st.step = 2
    st.commit()
    st.restore()
    assert st.step == 2


def _seed_opt(model, **kw):
    return hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.int8_block, error_feedback=True, **kw)


def _step(model, opt, seed, nan=False):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(4, 6, generator=g)
    opt.zero_grad(set_to_none=True)
    loss = model(x).square().mean()
    if nan:
        loss = loss + next(model.parameters()).reshape(-1)[0] * float("nan")
    loss.backward()
    opt.step()


@pytest.fixture
def world_of_one():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_torch_state_commit_and_restore(world_of_one):
    from horovod_tpu_torch.data import ShardedIndexSampler

    torch.manual_seed(0)
    model = torch.nn.Linear(6, 3)
    opt = _seed_opt(model)
    sampler = ShardedIndexSampler(20, seed=1)
    state = TorchState(model, opt, epoch=0)
    state.register_data("train", sampler)
    it = iter(sampler)
    _step(model, opt, 1)
    next(it)
    state.epoch = 1
    state.commit()
    saved = (audit.tree_digest(model.state_dict()),
             audit.tree_digest(opt.state_dict()))
    _step(model, opt, 2)
    next(it)
    next(it)
    state.epoch = 2
    assert audit.tree_digest(opt.state_dict()) != saved[1]
    state.restore()
    assert (audit.tree_digest(model.state_dict()),
            audit.tree_digest(opt.state_dict())) == saved
    assert state.epoch == 1 and sampler.state_dict()["cursor"] == 1
    assert opt.state_dict()["updates"] == 1 and opt.state_dict()[
        "ef_residuals"]
    _step(model, opt, 3)  # the restored state is the optimizer's own copy
    state.restore()
    assert audit.tree_digest(opt.state_dict()) == saved[1]
    with pytest.raises(TypeError, match="state_dict"):
        state.register_data("x", object())


def test_run_restores_on_internal_error_and_reinits(world_of_one):
    """The grad guard's escalation: a non-finite step, the commit raises,
    ``run`` drops the latch, restores the last commit and re-inits in
    place; the retry goes on from the commit."""
    torch.manual_seed(0)
    model = torch.nn.Linear(6, 3)
    opt = _seed_opt(model, grad_guard=True, guard_max_skips=1)
    state = TorchState(model, opt, step=0)
    resets, seen = [], []
    state.register_reset_callbacks([lambda: resets.append(1)])
    fusion0 = basics.state().fusion

    @hvd.elastic.run
    def train(state):
        while state.step < 4:
            step = state.step + 1
            seen.append(step)
            _step(model, opt, step, nan=(step == 3 and len(resets) == 0))
            state.step = step
            state.commit()
        return state.step

    assert train(state) == 4
    assert seen == [1, 2, 3, 3, 4] and resets == [1]
    assert basics.state().fusion is not fusion0  # re-initialized
    torch.manual_seed(0)
    ref = torch.nn.Linear(6, 3)
    ropt = _seed_opt(ref)
    for s in range(1, 5):
        _step(ref, ropt, s)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 ref.parameters()))


def test_run_keeps_the_state_on_hosts_updated(world_of_one):
    state = ObjectState(step=0)
    calls = []

    @hvd.elastic.run
    def train(state):
        calls.append(state.step)
        if len(calls) == 1:
            state.step = 5  # uncommitted progress survives
            raise hvd.HostsUpdatedInterrupt()
        return state.step

    assert train(state) == 5 and calls == [0, 5]


def _sync_worker(rank, n, outdir):
    hvd.init(device="cpu", store=file_store(outdir, n))
    from horovod_tpu_torch.data import ShardedIndexSampler

    torch.manual_seed(rank)  # every rank starts apart
    model = torch.nn.Linear(6, 3)
    opt = _seed_opt(model)
    _step(model, opt, 10 + rank)
    if rank == 1:  # apart without a collective of its own
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
                opt.state[p]["momentum_buffer"].mul_(2.0)
        opt._updates += 3
    sampler = ShardedIndexSampler(40, seed=2)
    it = iter(sampler)
    for _ in range(rank + 1):
        next(it)
    state = TorchState(model, opt, epoch=rank)
    state.register_data("train", sampler)
    res_before = {i: r.clone() for i, r in
                  opt.state_dict()["ef_residuals"].items()}
    state.sync()
    sd = opt.state_dict()
    torch.save({"params": [p.detach().clone() for p in model.parameters()],
                "momentum": [v["momentum_buffer"] for v in
                             sd["state"].values()],
                "updates": sd["updates"], "epoch": state.epoch,
                "cursor": sampler.state_dict()["cursor"],
                "res_kept": all(torch.equal(res_before[i], r) for i, r in
                                sd["ef_residuals"].items())},
               f"{outdir}/rank{rank}.pt")
    hvd.shutdown()


def test_torch_state_sync_makes_rank0s_state_everyones(tmp_path):
    outs = _run(tmp_path, 2, HERE, "_sync_worker", 120, None)
    a, b = outs
    assert all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
    assert all(torch.equal(x, y) for x, y in zip(a["momentum"],
                                                 b["momentum"]))
    assert (a["updates"], b["updates"]) == (1, 1)  # rank 1's 4 is gone
    assert (a["epoch"], b["epoch"]) == (0, 0)
    assert (a["cursor"], b["cursor"]) == (2, 2)
    assert a["res_kept"] and b["res_kept"]  # each rank's own carry


def test_elastic_sampler_equals_the_shim():
    from horovod_tpu.torch.elastic import ElasticSampler as JSampler

    ds = list(range(37))
    for replicas, rank in ((4, 1), (3, 2), (1, 0)):
        a = ElasticSampler(ds, seed=5, num_replicas=replicas, rank=rank)
        b = JSampler(ds, seed=5, num_replicas=replicas, rank=rank)
        assert list(a) == list(b) and len(a) == len(b)
        a.record_batch(0, 3)
        b.record_batch(0, 3)
        a.set_epoch(2)
        b.set_epoch(2)
        a.record_batch(1, 2)
        b.record_batch(1, 2)
        sd = a.state_dict()
        assert sd == b.state_dict()
        a2 = ElasticSampler(ds, seed=5, num_replicas=replicas + 1, rank=0)
        b2 = JSampler(ds, seed=5, num_replicas=replicas + 1, rank=0)
        a2.load_state_dict(sd)
        b2.load_state_dict(sd)
        assert list(a2) == list(b2)


# ------------------------------------------- the composed story, end to end

ELASTIC_WORKER = textwrap.dedent("""
    import json, os, sys, torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint as ck, data as hdata
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.metrics import registry
    from horovod_tpu_torch.testing import chaos
    root = sys.argv[1]
    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    epoch = basics.get_config().elastic_epoch
    torch.manual_seed(0)
    model = torch.nn.Linear(8, 1)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
        op=hvd.Average, compression=hvd.Compression.int8_block,
        error_feedback=True)
    ds = hdata.ShardedFileDataset(os.path.join(root, "data"), 2, seed=3)
    state = ck.DurableTorchState(os.path.join(root, "ck"), max_to_keep=2,
                                 model=model, optimizer=opt, step=0)
    state.register_data("train", ds)
    if epoch > 0:
        chaos.configure("")
    rec = {"rank": r, "size": n, "epoch": epoch,
           "resumed": state.resume_latest(), "resumed_step": state.step,
           "indices": {}, "losses": {}}
    def dump():
        with open(os.path.join(root, f"e{epoch}.r{r}.json"), "w") as f:
            json.dump(rec, f)
    @hvd.elastic.run
    def train(state):
        it = iter(ds)
        while state.step < 8:
            chaos.inject(f"train.step.rank{r}")
            x, idx = next(it)
            x = torch.as_tensor(x)
            opt.zero_grad(set_to_none=True)
            loss = torch.nn.functional.mse_loss(model(x[:, :8]), x[:, 8:])
            loss.backward()
            opt.step()
            state.step += 1
            state.commit()
            rec["indices"][state.step] = [int(i) for i in idx]
            rec["losses"][state.step] = float(loss)
            dump()
    train(state)
    rec["params"] = [p.detach().reshape(-1).tolist()
                     for p in model.parameters()]
    rec["restart_ms"] = registry.snapshot().get("elastic.restart_ms")
    dump()
    hvd.shutdown()
""")


@pytest.fixture(scope="module")
def elastic_run(tmp_path_factory):
    from horovod_tpu_torch.data import write_shards

    root = tmp_path_factory.mktemp("elastic")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 9)).astype(np.float32)
    write_shards(str(root / "data"), x, np.arange(64), rows_per_shard=16)
    (root / "w.py").write_text(ELASTIC_WORKER)
    script = root / "discover.sh"
    script.write_text("#!/bin/sh\necho 127.0.0.1:1\necho localhost:3\n")
    script.chmod(0o755)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               HOROVOD_FAULT_PLAN="train.step.rank0@4:kill")
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "4",
         "--gloo", "--min-np", "2", "--max-np", "4",
         "--host-discovery-script", str(script), sys.executable,
         str(root / "w.py"), str(root)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=240)
    recs = {}
    for p in root.glob("e*.r*.json"):
        rec = json.loads(p.read_text())
        recs[(rec["epoch"], rec["rank"])] = rec
    return proc, recs


def test_elastic_job_shrinks_and_succeeds(elastic_run):
    proc, recs = elastic_run
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    assert sorted(recs) == [(0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (1, 1),
                            (1, 2)]
    assert all(recs[(1, r)]["size"] == 3 for r in range(3))


def test_elastic_job_resumes_from_the_last_commit(elastic_run):
    _, recs = elastic_run
    assert all(not recs[(0, r)]["resumed"] for r in range(4))
    for r in range(3):
        assert recs[(1, r)]["resumed"] and recs[(1, r)]["resumed_step"] == 3
        assert recs[(1, r)]["restart_ms"] is not None


def test_elastic_job_consumes_every_sample_once(elastic_run):
    from horovod_tpu_torch.data import ShardedIndexSampler

    _, recs = elastic_run
    seen = [i for rec in recs.values() for idx in rec["indices"].values()
            for i in idx]
    order = ShardedIndexSampler(64, num_replicas=1, rank=0,
                                seed=3)._epoch_order()
    assert sorted(seen) == sorted(int(i) for i in order[:3 * 8 + 5 * 6])


def test_elastic_job_replicas_agree(elastic_run):
    _, recs = elastic_run
    finals = [recs[(1, r)]["params"] for r in range(3)]
    assert finals[0] == finals[1] == finals[2]
    losses = [v for r in range(3) for v in recs[(1, r)]["losses"].values()]
    assert all(np.isfinite(losses))
