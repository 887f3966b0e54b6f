"""The eager grad guard and the ``fusion.dispatch`` fault site of the
port against the JAX package.

The guard: with ``HOROVOD_GUARD=1`` every floating fused eager batch
but an alltoall's yields an ``all(isfinite)`` sentinel over its output,
kept unread until ``hvd.guard_check()`` (``FusionManager.guard_poll``)
counts the non-finite batches into ``guard.nonfinite_batches``. The
same sequence of batches (numpy-seeded values, a NaN or an Inf on one
rank) runs through the JAX manager on the 8-device CPU mesh and through
the port in a gloo world of 2; the counts, integers, must be equal.

The fault site mirrors ``tests/test_chaos.py``'s ``TestFusionChaos``
and ``tests/test_integrity.py``'s
``test_fusion_dispatch_nan_detected_by_eager_guard``: each transport
kind raises ``HorovodInternalError`` in both packages, ``hvd.elastic.run``
absorbs one with the same attempts, step and result, and ``nan`` is
caught by the eager guard with the same counts."""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_collectives import _run, file_store

N = 2
ROWS = 64


def _row(rank, bad=None):
    """Rank ``rank``'s seeded float32 row; ``bad`` poisons element 3."""
    x = np.random.default_rng(10 + rank).normal(size=ROWS).astype(
        np.float32)
    if bad is not None:
        x[3] = bad
    return x


def _sequence(rank):
    """The batches both packages run, as (kind, per-rank value) with the
    value a function of the rank; the non-finite ones are on rank 1 or 0,
    present in a world of 2 and of 8."""
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    return [
        ("allreduce", _row(rank)),
        ("allreduce", _row(rank, nan if rank == 1 else None)),
        ("allreduce_int", np.arange(8, dtype=np.int32) + rank),
        ("allgather", _row(rank, inf if rank == 0 else None)),
        ("broadcast", _row(rank, nan if rank == 0 else None)),
        ("grouped", [_row(rank), _row(rank, inf if rank == 1 else None)]),
        ("allreduce", _row(rank)),
    ]


EXPECTED = [4, 0]  # the polls: after the sequence, after one clean batch


def _guard_worker(rank, n, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.metrics import registry

    hvd.init(device="cpu", store=file_store(outdir, n))
    fusion = basics.state().fusion
    out = {"guard": fusion.guard}
    for kind, x in _sequence(rank):
        if kind == "grouped":
            hvd.grouped_allreduce([torch.from_numpy(v) for v in x],
                                  op=hvd.Sum)
        elif kind == "allgather":
            hvd.allgather(torch.from_numpy(x))
        elif kind == "broadcast":
            hvd.broadcast(torch.from_numpy(x), root_rank=0)
        else:
            hvd.allreduce(torch.from_numpy(x), op=hvd.Sum)
    # an alltoall carries no sentinel
    hvd.alltoall(torch.from_numpy(_row(rank, np.nan)))
    before = registry.snapshot().get("guard.nonfinite_batches", 0.0)
    hvd.guard_check()  # polls first
    out["check_counted"] = registry.snapshot().get(
        "guard.nonfinite_batches", 0.0) - before
    hvd.allreduce(torch.from_numpy(_row(rank)), op=hvd.Sum)
    out["polls"] = [out["check_counted"], fusion.guard_poll()]
    hvd.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def port_guard(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("guard"), N, Path(__file__),
                "_guard_worker", 180, {"HOROVOD_GUARD": "1"})


def _jax_polls(hvd):
    from horovod_tpu.common import basics

    fusion = basics.state().fusion
    fusion.guard = True
    fusion.guard_poll()
    n = hvd.size()
    seqs = [_sequence(r) for r in range(n)]
    for i, (kind, _) in enumerate(seqs[0]):
        rows = [s[i][1] for s in seqs]
        if kind == "grouped":
            hvd.grouped_allreduce(
                [np.stack([r[j] for r in rows]) for j in range(2)],
                op=hvd.Sum)
        elif kind == "allgather":
            hvd.allgather(np.stack(rows))
        elif kind == "broadcast":
            hvd.broadcast(np.stack(rows), root_rank=0)
        else:
            hvd.allreduce(np.stack(rows), op=hvd.Sum)
    polls = [fusion.guard_poll()]
    hvd.allreduce(np.stack([_row(r) for r in range(n)]), op=hvd.Sum)
    polls.append(fusion.guard_poll())
    return polls


def test_eager_guard_counts_equal_the_jax_manager(hvd, port_guard):
    want = _jax_polls(hvd)
    assert want == EXPECTED
    for out in port_guard:
        assert out["guard"] is True  # HOROVOD_GUARD=1 at init
        assert out["polls"] == [float(w) for w in want] == [4.0, 0.0]


def test_unguarded_manager_keeps_no_sentinel(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics

    for name in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_GUARD"):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    try:
        fusion = basics.state().fusion
        assert fusion.guard is False
        hvd.allreduce(torch.from_numpy(_row(0, np.nan)))
        assert fusion._guard_flags == [] and fusion.guard_poll() == 0
        # the sentinel list stays bounded when nobody polls
        fusion.guard = True
        for _ in range(300):
            hvd.allreduce(torch.ones(4))
        assert len(fusion._guard_flags) == 256
    finally:
        hvd.shutdown()


# ------------------------------------------------ the fusion.dispatch site


@pytest.fixture
def port_world(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.testing import chaos

    for name in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_GUARD",
                 "HOROVOD_FAULT_PLAN"):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    try:
        yield hvd
    finally:
        chaos.reset()
        hvd.shutdown()


@pytest.mark.parametrize("kind", ["reset", "timeout", "5xx"])
def test_dispatch_fault_surfaces_as_internal_error(hvd, port_world, kind):
    from horovod_tpu.testing import chaos as jchaos
    from horovod_tpu_torch.testing import chaos

    jchaos.configure(f"seed=6;fusion.dispatch@1:{kind}")
    try:
        with pytest.raises(hvd.HorovodInternalError):
            hvd.allreduce(np.ones((hvd.size(), 4), np.float32),
                          name="chaos_ar")
    finally:
        jchaos.reset()
    chaos.configure(f"seed=6;fusion.dispatch@1:{kind}")
    handle = port_world.allreduce_async(torch.ones(8, 4), name="chaos_ar")
    with pytest.raises(port_world.HorovodInternalError):
        handle.wait()
    # the fault fired once; the next batch goes through
    assert chaos.active().fired()[0]["site"] == "fusion.dispatch"
    assert torch.equal(port_world.allreduce(torch.ones(3)), torch.ones(3))


def _elastic_body(allreduce, ones, result):
    attempts = {"n": 0}

    def train(st):
        attempts["n"] += 1
        st.step += 1
        out = allreduce(ones)
        return st.step, result(out)
    return attempts, train


def test_elastic_run_absorbs_dispatch_fault(hvd, port_world):
    from horovod_tpu.elastic import ObjectState as JObjectState
    from horovod_tpu.elastic.worker import run as jrun
    from horovod_tpu.testing import chaos as jchaos
    from horovod_tpu_torch.elastic import ObjectState, run
    from horovod_tpu_torch.testing import chaos

    jchaos.configure("seed=6;fusion.dispatch@1:timeout")
    try:
        j_attempts, jtrain = _elastic_body(
            lambda x: hvd.allreduce(x, op=hvd.Average, name="chaos_el"),
            np.ones((hvd.size(), 4), np.float32), lambda o: np.asarray(o)[0])
        j_step, j_out = jrun(jtrain)(JObjectState(step=0))
    finally:
        jchaos.reset()
    chaos.configure("seed=6;fusion.dispatch@1:timeout")
    attempts, train = _elastic_body(
        lambda x: port_world.allreduce(x, op=port_world.Average,
                                       name="chaos_el"),
        torch.ones(4), lambda o: o.numpy())
    step, out = run(train)(ObjectState(step=0))
    assert (attempts["n"], step) == (j_attempts["n"], j_step) == (2, 1)
    np.testing.assert_array_equal(out, j_out)
    np.testing.assert_array_equal(out, np.ones(4, np.float32))


def test_fusion_dispatch_nan_detected_by_eager_guard(hvd, port_world):
    from horovod_tpu.common import basics as jbasics
    from horovod_tpu.common.metrics import registry as jregistry
    from horovod_tpu.testing import chaos as jchaos
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.metrics import registry
    from horovod_tpu_torch.testing import chaos

    def delta(reg, before):
        return reg.snapshot().get("guard.nonfinite_batches", 0.0) - \
            before.get("guard.nonfinite_batches", 0.0)

    jfusion = jbasics.state().fusion
    jfusion.guard = True
    jchaos.configure("fusion.dispatch@1:nan")
    try:
        jout = hvd.allreduce(hvd.replicate(np.ones((64,), np.float32)),
                             op=hvd.Sum)
        before = jregistry.snapshot()
        want = [not bool(np.isfinite(np.asarray(jout)).all()),
                jfusion.guard_poll(), delta(jregistry, before)]
        hvd.allreduce(hvd.replicate(np.ones((64,), np.float32)), op=hvd.Sum)
        want.append(jfusion.guard_poll())
    finally:
        jchaos.reset()
    fusion = basics.state().fusion
    fusion.guard = True
    chaos.configure("fusion.dispatch@1:nan")
    x = torch.ones(64)
    out = port_world.allreduce(x, op=port_world.Sum)
    before = registry.snapshot()
    got = [not bool(torch.isfinite(out).all()), fusion.guard_poll(),
           delta(registry, before)]
    port_world.allreduce(torch.ones(64), op=port_world.Sum)
    got.append(fusion.guard_poll())
    assert got == want == [True, 1, 1.0, 0]
    assert torch.isnan(out[0]) and torch.isfinite(out[1:]).all()
    assert torch.equal(x, torch.ones(64))  # the caller's tensor is clean
