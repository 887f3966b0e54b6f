"""The port's timelines against the JAX package's.

The eager timeline (``common/timeline.py``): the same enqueue/flush
sequence through both fusion managers must write the same events for
each tensor (names and phases; timestamps excluded; the fusion buffer's
copies, which the JAX manager stamps only on its bucket tier, apart),
the same CYCLE marks and the same counter tracks. The traced timeline
(``common/traced_timeline.py``) runs ``torch.profiler`` here; its
``collective_overlap_stats`` is held to the JAX function on the JAX
tests' synthetic traces and taught the card's names."""

import json

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common import traced_timeline as ptt

MEMCPY = ("MEMCPY_IN_FUSION_BUFFER", "MEMCPY_OUT_FUSION_BUFFER")


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _by_tensor(events):
    """{tensor name: [(event name, ph), ...]} plus the global rows' (pid
    0) CYCLE marks and counter names, in order."""
    names = {e["pid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    rows, glob = {}, []
    for e in events:
        if e.get("ph") == "M":
            continue
        if e.get("pid") == 0:
            glob.append((e["name"], e["ph"]))
        elif e["name"] not in MEMCPY:
            rows.setdefault(names[e["pid"]], []).append((e["name"], e["ph"]))
    return rows, glob


@pytest.fixture
def port_world(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_TIMELINE"):
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _enqueue_three(allreduce_async, synchronize, make):
    handles = [allreduce_async(make(i), name=f"t{i}", op="sum")
               for i in range(3)]
    return [synchronize(h) for h in handles]


def test_event_sequence_matches_the_jax_timeline(tmp_path, monkeypatch):
    import horovod_tpu as jhvd

    monkeypatch.setenv("HOROVOD_CYCLE_TIME", "100000")  # one JAX cycle
    jhvd.shutdown()
    jhvd.init()
    try:
        jpath = str(tmp_path / "jax.json")
        jhvd.start_timeline(jpath, mark_cycles=True)
        _enqueue_three(
            lambda x, name, op: jhvd.allreduce_async(x, name=name,
                                                     op=jhvd.Sum),
            jhvd.synchronize,
            lambda i: np.full((8, 4), float(i), np.float32))
        jhvd.stop_timeline()
    finally:
        jhvd.shutdown()
    monkeypatch.delenv("HOROVOD_CYCLE_TIME")
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    try:
        ppath = str(tmp_path / "port.json")
        hvd.start_timeline(ppath, mark_cycles=True)
        _enqueue_three(
            lambda x, name, op: hvd.allreduce_async(x, name=name, op=hvd.Sum),
            hvd.synchronize, lambda i: torch.full((4,), float(i)))
        hvd.stop_timeline()
    finally:
        hvd.shutdown()
    jrows, jglob = _by_tensor(_events(jpath))
    prows, pglob = _by_tensor(_events(ppath))
    assert set(prows) == {"t0", "t1", "t2"}
    assert prows == jrows
    assert prows["t0"] == [("QUEUE", "B"), ("ALLREDUCE", "B"),
                           ("ALLREDUCE_DEVICE", "X"), ("ALLREDUCE", "E"),
                           ("QUEUE", "E")]
    assert pglob == jglob


def test_fusion_buffer_copies_cycles_and_counters(tmp_path, port_world):
    path = str(tmp_path / "tl.json")
    hvd.start_timeline(path, mark_cycles=True)
    fusion = basics.state().fusion
    hvd.grouped_allreduce([torch.ones(3), torch.ones(5)], op=hvd.Sum,
                          name="g")
    hvd.allreduce(torch.ones(2), name="solo")
    hvd.stop_timeline()
    events = _events(path)
    names = {e["pid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M"}
    per = {}
    for e in events:
        if e.get("ph") != "M" and e["pid"] != 0:
            per.setdefault(names[e["pid"]], []).append(e["name"])
    grouped = [n for n in per if n != "solo"]
    assert len(grouped) == 2
    for n in grouped:  # a batch of two: the buffer's copy in and out
        assert per[n].count("MEMCPY_IN_FUSION_BUFFER") == 2
        assert per[n].count("MEMCPY_OUT_FUSION_BUFFER") == 2
    assert not set(MEMCPY) & set(per["solo"])
    cycles = [e for e in events if e["name"] == "CYCLE"]
    assert len(cycles) == fusion.cycles == 2
    dispatches = [e["args"]["fusion.dispatches"] for e in events
                  if e["name"] == "fusion.dispatches"]
    assert dispatches == [1, 1]
    # the device spans number the batches
    spans = {(e["ts"], e["dur"]) for e in events
             if e["name"] == "ALLREDUCE_DEVICE"}
    assert len(spans) == fusion.dispatched_batches == 2


def test_timeline_from_the_environment(tmp_path, monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    path = tmp_path / "env.json"
    monkeypatch.setenv("HOROVOD_TIMELINE", str(path))
    hvd.init(device="cpu")
    try:
        assert basics.state().fusion.timeline is basics.state().timeline
        hvd.allreduce(torch.ones(4), name="x")
    finally:
        hvd.shutdown()  # closes the timeline: the file is written
    assert ("QUEUE", "B") in {(e["name"], e.get("ph"))
                              for e in _events(path)}


def test_traced_timeline_on_torch_profiler(tmp_path, port_world):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.ReLU(),
                                torch.nn.Linear(64, 8))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(), overlap_buckets=2,
        overlap_min_bytes=0)
    path = str(tmp_path / "traced.json")
    hvd.start_timeline(path, traced=True)
    for i in range(2):
        with hvd.timeline_step("train", i):
            opt.zero_grad()
            model(torch.randn(4, 32)).pow(2).mean().backward()
            opt.step()
    hvd.stop_timeline()
    opt.remove_hooks()
    events = _events(path)
    names = {str(e.get("name", "")) for e in events}
    assert {"train#0", "train#1"} <= names
    assert {"hvd.overlap.bucket0", "hvd.overlap.bucket1"} <= names
    stats = basics.state().traced_timeline.last_overlap_stats
    assert stats["buckets"] == opt._overlap.schedule.n_buckets == 2
    assert set(stats) >= {"collective_us", "hidden_us", "exposed_us",
                          "spans"}


def _jax_synthetic_traces():
    plain = [
        {"ph": "X", "pid": 7, "tid": 1, "ts": 0, "dur": 100,
         "name": "all-reduce.1"},
        {"ph": "X", "pid": 7, "tid": 2, "ts": 20, "dur": 60,
         "name": "fusion.42"},
        {"ph": "X", "pid": 7, "tid": 1, "ts": 200, "dur": 50,
         "name": "all-gather.3"},
        {"ph": "X", "pid": 7, "tid": 1, "ts": 300, "dur": 10,
         "name": "all-reduce-start.9"},
    ]
    containers = [
        {"ph": "M", "pid": 7, "tid": 9, "name": "thread_name",
         "args": {"name": "Steps"}},
        {"ph": "M", "pid": 7, "tid": 8, "name": "thread_name",
         "args": {"name": "XLA Modules"}},
        {"ph": "M", "pid": 7, "tid": 2, "name": "thread_name",
         "args": {"name": "XLA Ops"}},
        {"ph": "X", "pid": 7, "tid": 9, "ts": 0, "dur": 1000,
         "name": "train 0"},
        {"ph": "X", "pid": 7, "tid": 8, "ts": 0, "dur": 1000,
         "name": "jit_step"},
        {"ph": "X", "pid": 7, "tid": 2, "ts": 100, "dur": 100,
         "name": "all-reduce.5"},
        {"ph": "X", "pid": 7, "tid": 2, "ts": 150, "dur": 30,
         "name": "fusion.9"},
    ]
    return [plain, containers]


@pytest.mark.parametrize("which", [0, 1], ids=["plain", "containers"])
def test_overlap_stats_equal_the_jax_function(which):
    from horovod_tpu.common.traced_timeline import (
        collective_overlap_stats as jstats,
    )

    events = _jax_synthetic_traces()[which]
    got = ptt.collective_overlap_stats(events)
    want = jstats(events)
    assert {k: got[k] for k in want} == want
    assert got["buckets"] == 0


def test_the_cards_names_are_classified():
    c = ptt._classify_collective
    assert c("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)") == \
        "ALLREDUCE"
    assert c("ncclKernel_AllGather_RING_LL_Sum_int8_t") == "ALLGATHER"
    assert c("ncclDevKernel_ReduceScatter_Sum_f32_RING_LL") == \
        "REDUCESCATTER"
    assert c("ncclDevKernel_SendRecv(ncclDevComm*)") == "ALLTOALL"
    assert c("ncclDevKernel_Broadcast_RING_LL") == "BROADCAST"
    assert c("gloo:all_reduce") == "ALLREDUCE"
    assert c("gloo:all_to_all") == "ALLTOALL"
    assert c("gloo:broadcast") == "BROADCAST"
    for launch in ("nccl:all_reduce", "c10d::allreduce_",
                   "record_param_comms"):
        assert c(launch) == "skip"
    assert c("aten::broadcast_tensors") is None
    assert c("hvd_flash_fwd_tc") is None
    assert c("hvd.overlap.bucket3") == "bucket"
    assert c("hvd.int8_wire.exchange") == "wire"
    # a device row: an NCCL kernel half under a compute kernel; the
    # device twin of a host range (gpu_user_annotation) is no compute
    events = [
        {"ph": "X", "pid": 0, "tid": 7, "ts": 0, "dur": 100,
         "cat": "kernel", "name": "ncclDevKernel_AllReduce_Sum_f32"},
        {"ph": "X", "pid": 0, "tid": 8, "ts": 50, "dur": 100,
         "cat": "kernel", "name": "hvd_flash_bwd_dq_tc"},
        {"ph": "X", "pid": 0, "tid": 9, "ts": 0, "dur": 1000,
         "cat": "gpu_user_annotation", "name": "hvd.overlap.bucket0"},
        {"ph": "X", "pid": 0, "tid": 9, "ts": 0, "dur": 1000,
         "cat": "gpu_user_annotation", "name": "train#0"},
        {"ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 10,
         "cat": "user_annotation", "name": "hvd.overlap.bucket1"},
    ]
    s = ptt.collective_overlap_stats(events)
    assert (s["collective_us"], s["hidden_us"], s["exposed_us"],
            s["spans"], s["buckets"]) == (100, 50, 50, 1, 2)
