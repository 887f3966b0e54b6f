"""The port's eager collectives and tensor fusion in gloo worlds of 2 and
4 processes on the CPU.

Each world runs once per module (the ``world`` fixture): every rank calls
``hvd.init(device="cpu", store=FileStore)`` and runs the same program of
collectives on integer-valued fp32 inputs, then the tests compare each
rank's results exactly with the closed forms that tests/test_ops_eager.py
uses (sums and means of integers are exact in fp32). Fusion: tensors
under the threshold go out in one batch; over it, in ⌈bytes /
threshold⌉ batches, with results identical to the unfused ones.

Ranks run as separate interpreters (``run_world``) with a deadline, so
a hung rank fails its test instead of eating the suite's time."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import adasum as port_adasum

REPO = Path(__file__).resolve().parent.parent
THRESHOLD = 1024  # bytes: HOROVOD_FUSION_THRESHOLD of the fusion cases


def run_world(tmp_path, n, worker, timeout=180, env=None):
    """Run ``worker(rank, n, outdir)`` of this file in ``n`` fresh
    interpreters (``HOROVOD_RANK``/``HOROVOD_SIZE`` set) and return what
    each rank saved with ``torch.save`` to ``outdir/rank<r>.pt``."""
    return _run(tmp_path, n, Path(__file__), worker, timeout, env)


def _run(tmp_path, n, module_file, worker, timeout, env):
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('w', "
        f"{str(module_file)!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        f"m.{worker}(int(sys.argv[1]), {n}, {str(tmp_path)!r})\n"
    )
    base = dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]),
                HOROVOD_SIZE=str(n), OMP_NUM_THREADS="1")
    base.update(env or {})
    procs = [
        subprocess.Popen([sys.executable, "-c", code, str(r)],
                         env=dict(base, HOROVOD_RANK=str(r)), cwd=REPO,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for r in range(n)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{worker}: a rank did not finish in {timeout} s")
    bad = [(r, p.returncode, log) for r, (p, log)
           in enumerate(zip(procs, logs)) if p.returncode]
    assert not bad, "\n".join(f"rank {r} rc {rc}:\n{log[-3000:]}"
                              for r, rc, log in bad)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(n)]


def file_store(outdir, n):
    import torch.distributed as dist

    return dist.FileStore(str(Path(outdir) / "store"), n)


# ------------------------------------------------------------- the worker


def _collectives_worker(rank, n, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics

    hvd.init(device="cpu", store=file_store(outdir, n))
    base = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    x = base + 10 * rank
    out = {"rank": hvd.rank(), "size": hvd.size()}
    out["sum"] = hvd.allreduce(x, op=hvd.Sum)
    out["avg"] = hvd.allreduce(x)
    out["avg_legacy"] = hvd.allreduce(x, average=True)
    out["scaled"] = hvd.allreduce(x, op=hvd.Average, prescale_factor=2.0,
                                  postscale_factor=3.0)
    out["min"] = hvd.allreduce(x, op=hvd.Min)
    out["max"] = hvd.allreduce(x, op=hvd.Max)
    out["prod"] = hvd.allreduce(torch.full((3,), float(rank + 1)),
                                op=hvd.Product)
    out["fp16"] = hvd.allreduce(x, op=hvd.Sum,
                                compression=hvd.Compression.fp16)
    out["bf16"] = hvd.allreduce(x, op=hvd.Sum,
                                compression=hvd.Compression.bf16)
    inplace = x.clone()
    hvd.allreduce_(inplace, op=hvd.Sum)
    out["inplace"] = inplace
    h = hvd.allreduce_async(x, op=hvd.Sum)
    hvd.poll(h)
    out["async"] = hvd.synchronize(h)
    out["grouped"] = hvd.grouped_allreduce(
        [x, torch.full((4,), float(rank)), torch.ones(1, 2, 2) * rank],
        op=hvd.Sum,
    )
    out["gather"] = hvd.allgather(torch.full((rank + 1, 3), float(rank)))
    out["bcast"] = hvd.broadcast(x, root_rank=n - 1)
    target = x.clone()
    hvd.broadcast_(target, root_rank=1)
    out["bcast_inplace"] = target
    ps = hvd.add_process_set([0, n - 1])
    out["set_id"] = ps.process_set_id
    if rank in (0, n - 1):
        out["set_sum"] = hvd.allreduce(x, op=hvd.Sum, process_set=ps)
        out["set_avg"] = hvd.allreduce(x, process_set=ps)
    hvd.barrier()
    out["adasum"] = hvd.allreduce(x, op=hvd.Adasum)

    # fusion: small tensors under the threshold share one batch; over
    # it, a batch closes whenever the next would pass the threshold
    fusion = basics.state().fusion
    small = [torch.full((16,), float(rank + i)) for i in range(8)]  # 64 B
    big = [torch.full((64,), float(rank * i)) for i in range(10)]  # 256 B
    for name, tensors in (("small", small), ("big", big)):
        before = fusion.dispatched_batches
        handles = [hvd.allreduce_async(t, op=hvd.Sum) for t in tensors]
        fused = [hvd.synchronize(h) for h in handles]
        out[f"{name}_batches"] = fusion.dispatched_batches - before
        out[f"{name}_fused"] = fused
        out[f"{name}_unfused"] = [hvd.allreduce(t, op=hvd.Sum)
                                  for t in tensors]
    out["threshold"] = fusion.threshold_bytes
    hvd.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    n = request.param
    outs = run_world(tmp_path_factory.mktemp(f"world{n}"), n,
                     "_collectives_worker",
                     env={"HOROVOD_FUSION_THRESHOLD": str(THRESHOLD)})
    return n, outs


def test_ranks_and_sizes(world):
    n, outs = world
    assert [o["rank"] for o in outs] == list(range(n))
    assert all(o["size"] == n for o in outs)


def test_allreduce_closed_forms(world):
    n, outs = world
    base = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    rsum = 10 * sum(range(n))
    total = n * base + rsum
    for o in outs:
        for key in ("sum", "inplace", "async", "fp16", "bf16"):
            assert torch.equal(o[key], total), key
        assert torch.equal(o["avg"], total / n)
        assert torch.equal(o["avg_legacy"], total / n)
        assert torch.equal(o["scaled"], 3.0 * (2.0 * total) / n)
        assert torch.equal(o["min"], base)
        assert torch.equal(o["max"], base + 10 * (n - 1))
        assert torch.equal(o["prod"], torch.full((3,), float(
            np.prod(np.arange(1, n + 1)))))
        rows = np.stack([(base + 10 * r).numpy().ravel()
                         for r in range(n)])
        np.testing.assert_allclose(
            o["adasum"].numpy().ravel(),
            port_adasum.adasum_vhdd_host(rows.astype(np.float64)),
            rtol=1e-5)


def test_grouped_allreduce(world):
    n, outs = world
    base = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    rsum = float(sum(range(n)))
    for o in outs:
        a, b, c = o["grouped"]
        assert torch.equal(a, n * base + 10 * rsum)
        assert torch.equal(b, torch.full((4,), rsum))
        assert torch.equal(c, torch.full((1, 2, 2), rsum))


def test_allgather_uneven_and_broadcast(world):
    n, outs = world
    want = torch.cat([torch.full((r + 1, 3), float(r)) for r in range(n)])
    root = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * (n - 1)
    for o in outs:
        assert torch.equal(o["gather"], want)
        assert torch.equal(o["bcast"], root)
        assert torch.equal(o["bcast_inplace"], root - 10 * (n - 2))


def test_process_set_allreduce(world):
    n, outs = world
    base = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    members = 2 * base + 10 * (n - 1)
    for r, o in enumerate(outs):
        # in a world of 2 the set is the world: the global set, id 0
        assert o["set_id"] == (0 if n == 2 else 1)
        if r in (0, n - 1):
            assert torch.equal(o["set_sum"], members)
            assert torch.equal(o["set_avg"], members / 2)
        else:
            assert "set_sum" not in o


def test_fusion_batches_by_threshold(world):
    n, outs = world
    for o in outs:
        assert o["threshold"] == THRESHOLD
        # 8 × 64 B = 512 B under 1024 B: one batch
        assert o["small_batches"] == 1
        # 10 × 256 B = 2560 B: ⌈2560 / 1024⌉ = 3 batches (4 + 4 + 2)
        assert o["big_batches"] == -(-10 * 256 // THRESHOLD) == 3
        for key in ("small", "big"):
            for got, want in zip(o[f"{key}_fused"], o[f"{key}_unfused"]):
                assert torch.equal(got, want)
        rsum = float(sum(range(n)))
        assert torch.equal(o["big_fused"][3], torch.full((64,), 3 * rsum))
