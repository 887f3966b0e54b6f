"""The port's accumulation window (``backward_passes_per_step``) against
the reference's torch shim.

The reference (``horovod_tpu.torch.DistributedOptimizer``) counts the
window once, by ``step()`` calls, and at the window's end reduces every
parameter that accumulated a gradient in it, whether or not it had one
on the last pass. Each scenario below drives the canonical loop
(``zero_grad``, a backward pass over some of the parameters, ``step``)
through the shim on the 8-device CPU mesh of tests/conftest.py and
through the port, in a world of one in this process and in a gloo world
of 2 (every rank on the same data, ``op=Average``), and compares the
parameters and the inner optimizer's step count after every pass within
1e-6 (fp32 sums of a few terms).

The scenarios: the shim's own three window tests
(tests/test_torch_shim.py: the summed micro-gradients, a parameter that
leaves the window, a parameter with no gradient on the window's last
pass), the two-window case that showed the port's fault (exact values),
and Adam over two windows of three passes, which must step once a
window. Also: two gradients of a parameter without a ``step()`` between
them raise."""

from pathlib import Path

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd

from test_torch_collectives import _run, file_store

# each pass: (indices of the parameters in the loss, the pass's weight c);
# the loss of a pass is sum over those p of (c·w·p + q/2·p²).sum(), with
# w drawn per (pass, parameter) from the scenario's seed (1 when
# ``unit``)
SCENARIOS = {
    # test_torch_shim.py:135: two passes of one parameter, SGD
    "sum_micro": dict(shapes=[(1, 2)], inner="sgd", lr=0.1, k=2,
                      passes=[((0,), 1.0), ((0,), 2.0)], unit=True),
    # test_torch_shim.py:215: both parameters in window 1, only the
    # first in window 2; Adam must leave the second where it was
    "inactive_param": dict(shapes=[(1, 2), (1, 2)], inner="adam", lr=0.1,
                           k=2, passes=[((0, 1), 1.0), ((0, 1), 1.0),
                                        ((0,), 1.0), ((0,), 1.0)],
                           unit=True),
    # test_torch_shim.py:255: the first parameter only on pass 1, the
    # second only on the last pass
    "boundary_none": dict(shapes=[(1, 2), (1, 2)], inner="sgd", lr=0.1,
                          k=2, passes=[((0,), 1.0), ((1,), 1.0)],
                          unit=True),
    # the fault's reproduction: b misses window 1's last pass
    "two_windows": dict(shapes=[(2,), (2,)], inner="sgd", lr=1.0, k=2,
                        passes=[((0, 1), 1.0), ((0,), 1.0), ((0, 1), 1.0),
                                ((0, 1), 1.0)], unit=True, zeros=True),
    # Adam over two windows of three passes, parameters in and out
    "adam_steps": dict(shapes=[(3,), (2, 2), (4,)], inner="adam", lr=0.05,
                       k=3, passes=[((0, 1), 1.0), ((1, 2), 0.5),
                                    ((0,), 2.0), ((0, 1, 2), 1.0),
                                    ((2,), 1.5), ((1,), 1.0)], q=0.3),
}


def _drive(name, make_opt):
    """Run scenario ``name`` with ``make_opt(inner, k)`` wrapping the
    inner optimizer; the parameters and the inner optimizer's step
    count after every pass."""
    sc = SCENARIOS[name]
    rng = np.random.default_rng(11)
    params = [
        torch.nn.Parameter(torch.zeros(s) if sc.get("zeros") else
                           torch.from_numpy(rng.normal(size=s)
                                            .astype(np.float32)))
        for s in sc["shapes"]
    ]
    if sc["inner"] == "sgd":
        inner = torch.optim.SGD(params, lr=sc["lr"])
    else:
        inner = torch.optim.Adam(params, lr=sc["lr"])
    steps = [0]
    inner_step = inner.step

    def counted(closure=None):
        steps[0] += 1
        return inner_step(closure)

    inner.step = counted
    opt = make_opt(inner, sc["k"])
    q = sc.get("q", 0.0)
    record = []
    for used, c in sc["passes"]:
        opt.zero_grad()
        loss = 0.0
        for i in used:
            w = (torch.ones(sc["shapes"][i]) if sc.get("unit") else
                 torch.from_numpy(rng.normal(size=sc["shapes"][i])
                                  .astype(np.float32)))
            p = params[i]
            loss = loss + (c * w * p + 0.5 * q * p * p).sum()
        loss.backward()
        opt.step()
        record.append({"params": [p.detach().clone() for p in params],
                       "steps": steps[0]})
    return record


def _port_opt(inner, k):
    return hvd.DistributedOptimizer(inner, backward_passes_per_step=k,
                                    op=hvd.Average)


@pytest.fixture
def reference(hvd):
    """The shim's result for a scenario; ``hvd`` (tests/conftest.py)
    brings the reference's mesh up."""
    import horovod_tpu.torch as hvd_torch

    return lambda name: _drive(
        name, lambda inner, k: hvd_torch.DistributedOptimizer(
            inner, backward_passes_per_step=k))


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["steps"] == w["steps"], f"pass {i}: inner steps"
        for j, (gp, wp) in enumerate(zip(g["params"], w["params"])):
            np.testing.assert_allclose(gp.numpy(), wp.numpy(), atol=1e-6,
                                       rtol=0, err_msg=f"pass {i} param {j}")


def _world_of_one(monkeypatch):
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    hvd.init(device="cpu")


def _window_worker(rank, n, outdir):
    hvd.init(device="cpu", store=file_store(outdir, n))
    out = {name: _drive(name, _port_opt) for name in SCENARIOS}
    hvd.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("window"), 2, Path(__file__),
                "_window_worker", 180, None)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_window_matches_reference_world_of_one(reference, name,
                                               monkeypatch):
    want = reference(name)
    _world_of_one(monkeypatch)
    try:
        got = _drive(name, _port_opt)
    finally:
        hvd.shutdown()
    _assert_same(got, want)
    windows = [(i + 1) // SCENARIOS[name]["k"] for i in range(len(got))]
    assert [r["steps"] for r in got] == windows  # once a window


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_window_matches_reference_gloo_world_of_2(reference, name,
                                                  gloo_world):
    want = reference(name)
    for out in gloo_world:
        _assert_same(out[name], want)


def test_two_windows_exact_values(monkeypatch):
    """The fault's reproduction: b had a gradient on window 1's first
    pass only. The reference gives b = [−1, −1] after window 1 and
    [−3, −3] after window 2 (SGD, lr 1, unit gradients); a takes both
    passes of both windows."""
    _world_of_one(monkeypatch)
    try:
        got = _drive("two_windows", _port_opt)
    finally:
        hvd.shutdown()
    a1, b1 = got[1]["params"]
    a2, b2 = got[3]["params"]
    assert torch.equal(b1, torch.tensor([-1.0, -1.0]))
    assert torch.equal(b2, torch.tensor([-3.0, -3.0]))
    assert torch.equal(a1, torch.tensor([-2.0, -2.0]))
    assert torch.equal(a2, torch.tensor([-4.0, -4.0]))
    # the middle of a window moves nothing
    assert torch.equal(got[0]["params"][1], torch.zeros(2))
    assert [r["steps"] for r in got] == [0, 1, 1, 2]


@pytest.mark.parametrize("k", [1, 2])
def test_second_gradient_without_step_raises(k, monkeypatch):
    _world_of_one(monkeypatch)
    try:
        p = torch.nn.Parameter(torch.ones(3))
        opt = hvd.DistributedOptimizer(torch.optim.SGD([p], lr=0.1),
                                       backward_passes_per_step=k)
        (p * 2).sum().backward()
        with pytest.raises(RuntimeError,
                           match=r"call step\(\) after every backward"):
            (p * 3).sum().backward()
        opt.remove_hooks()
    finally:
        hvd.shutdown()

