"""``hvd.SyncBatchNorm`` and the zoo's synced batch norm in worlds of 1
(this process) and 2 (gloo ranks), on the CPU.

Each rank takes its slice of one global batch, made with numpy from a
seed. The oracle is ``torch.nn.functional.batch_norm`` over the whole
global batch in one process (the reference's own contract,
tests/test_torch_shim.py:306): the output slice, the input gradient
slice of a fixed random cotangent, the weight and bias gradients summed
over the ranks (``DistributedOptimizer`` sums or averages them), and the
running statistics (the unbiased variance over the global count). The
zoo's :class:`~horovod_tpu_torch.models.layers.BatchNorm` with
``sync=True`` is held the same way to itself unsynced over the global
batch (Flax's rules: momentum 0.9 on the old value, the biased
variance). Tolerance: 1e-5 of each tensor's largest magnitude (fp32
sums in other orders); evaluation with running statistics exactly as
tests/test_torch_shim.py:359 computes it."""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.layers import BatchNorm

from test_torch_collectives import _run, file_store

GLOBAL = 4  # global batch; each of n ranks takes GLOBAL // n
C = 3
TOL = 1e-5


def _global():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(GLOBAL, C, 5, 5)).astype(np.float32) * 2 + 0.5
    dy = rng.normal(size=(GLOBAL, C, 5, 5)).astype(np.float32)
    w = rng.normal(size=C).astype(np.float32)
    b = rng.normal(size=C).astype(np.float32)
    return x, dy, w, b


def _rank_run(rank, n):
    """This rank's results for its slice: both modules, two training
    steps each (the running statistics move twice), then evaluation."""
    x, dy, w, b = _global()
    sl = slice(rank * GLOBAL // n, (rank + 1) * GLOBAL // n)
    out = {}
    for name, make in (
            ("sbn", lambda: hvd.SyncBatchNorm(C, device="cpu")),
            ("zoo", lambda: BatchNorm(C, sync=True, device="cpu"))):
        m = make()
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(w))
            m.bias.copy_(torch.from_numpy(b))
        for step in range(2):
            m.zero_grad()
            xs = torch.from_numpy(x[sl] * (step + 1)).requires_grad_()
            y = m(xs)
            y.backward(torch.from_numpy(dy[sl]))
        out[name] = {"y": y.detach(), "dx": xs.grad,
                     "dw": m.weight.grad, "db": m.bias.grad,
                     "mean": m.running_mean.clone(),
                     "var": m.running_var.clone()}
        xe = torch.from_numpy(x[sl])
        with torch.no_grad():
            if name == "sbn":
                out[name]["eval"] = m.eval()(xe)
            else:
                out[name]["eval"] = m(xe, train=False)
    return out


def _oracle(flax_rules: bool):
    """The same two steps over the global batch in one process."""
    x, dy, w, b = _global()
    mean, var = torch.zeros(C), torch.ones(C)
    wt, bt = (torch.from_numpy(a).requires_grad_() for a in (w, b))
    res = {}
    for step in range(2):
        xs = torch.from_numpy(x * (step + 1)).requires_grad_()
        wt.grad = bt.grad = None
        if flax_rules:  # Flax: 0.9 · old + 0.1 · biased batch variance
            y = F.batch_norm(xs, None, None, wt, bt, training=True, eps=1e-5)
            with torch.no_grad():
                bm = xs.mean((0, 2, 3))
                bv = xs.var((0, 2, 3), unbiased=False)
                mean, var = 0.9 * mean + 0.1 * bm, 0.9 * var + 0.1 * bv
        else:
            y = F.batch_norm(xs, mean, var, wt, bt, training=True,
                             momentum=0.1, eps=1e-5)
        y.backward(torch.from_numpy(dy))
        res = {"y": y.detach(), "dx": xs.grad, "dw": wt.grad.clone(),
               "db": bt.grad.clone(), "mean": mean.clone(),
               "var": var.clone()}
    with torch.no_grad():
        res["eval"] = F.batch_norm(torch.from_numpy(x), mean, var, wt, bt,
                                   training=False, eps=1e-5)
    return res


def _close(got, want, what):
    bound = TOL * max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= bound, f"{what}: {err:.3g} > {bound:.3g}"


def _check(ranks):
    n = len(ranks)
    for name, flax_rules in (("sbn", False), ("zoo", True)):
        want = _oracle(flax_rules)
        for key in ("y", "dx", "eval"):
            _close(torch.cat([r[name][key] for r in ranks]), want[key],
                   f"{name} {key}")
        for key in ("dw", "db"):
            _close(sum(r[name][key] for r in ranks), want[key],
                   f"{name} {key} summed over {n} ranks")
        for key in ("mean", "var"):
            for r in ranks:
                _close(r[name][key], want[key], f"{name} running {key}")


def _worker(rank, n, outdir):
    hvd.init(device="cpu", store=file_store(outdir, n))
    out = _rank_run(rank, n)
    hvd.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


def test_world_of_one(monkeypatch):
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    hvd.init(device="cpu")
    try:
        _check([_rank_run(0, 1)])
    finally:
        hvd.shutdown()


def test_gloo_world_of_two(tmp_path):
    _check(_run(tmp_path, 2, Path(__file__), "_worker", 180, None))


def test_eval_uses_running_stats():
    """tests/test_torch_shim.py:359's closed form; no collective, so no
    world is needed."""
    sbn = hvd.SyncBatchNorm(2, device="cpu")
    with torch.no_grad():
        sbn.running_mean.copy_(torch.tensor([1.0, -1.0]))
        sbn.running_var.copy_(torch.tensor([4.0, 0.25]))
    sbn.eval()
    out = sbn(torch.ones(3, 2))
    want = np.stack([np.full(3, 0.0),
                     np.full(3, 2.0 / np.sqrt(0.25 + 1e-5))], axis=1)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5)


def test_rejects_bad_inputs():
    sbn = hvd.SyncBatchNorm(3, device="cpu")
    with pytest.raises(ValueError, match="2D"):
        sbn(torch.ones(3))
    with pytest.raises(ValueError, match="channels"):
        sbn(torch.ones(2, 4))
