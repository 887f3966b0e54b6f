"""``DistributedOptimizer``'s remaining options in worlds of 1 (this
process) and 2 (gloo ranks), on the CPU, against the JAX package's
``horovod_tpu.DistributedOptimizer`` on the same per-rank gradients.

The reference runs as tests/test_integrity.py runs it: its update inside
``shard_map`` over a mesh of the first 1 or 2 of tests/conftest.py's CPU
devices, jitted, the parameters replicated. The same optax SGD (momentum
where the guard must keep the optimizer's state) stands beside
``torch.optim.SGD``, whose momentum rule is optax's ``trace``. Each
scenario's parameters, momentum, int8 residuals and guard status are
held to the reference's, step by step, within 1e-5 (fp32):

* ``backward_passes_per_step=2`` over 5 passes, with and without
  ``average_aggregated_gradients`` (the reference applies a window's
  sum, or its mean); ``flush()`` after them, which the JAX optimizer
  does not have, against the reference's torch shim
  (``horovod_tpu.torch.DistributedOptimizer.flush``) on the JAX mesh;
* ``average=False`` sums over the ranks, ``average=True`` averages,
  and either with ``op=`` raises as the reference does;
* ``prescale_factor``/``postscale_factor`` around the reduction;
* a process set of one of the two ranks reduces over that rank alone;
* the grad guard (tests/test_integrity.py:94-227's contract): a step
  whose reduced gradients hold a NaN (injected on rank 0 only) is
  skipped on every rank, parameters and momentum untouched and the skip
  counted; a good step resets the streak; ``guard_max_skips``
  consecutive skips latch an escalation that ``hvd.guard_check()``
  raises once as ``HorovodInternalError``; with the int8 wire and error
  feedback the residuals stay those of the last applied step, bit for
  bit, and within the wire's rounding of the reference's (the two draw
  different rounding bits: two quanta);
* the reference options of later slices raise, naming their ROADMAP
  item.

The gradients are small integers or halves, so most expected values
are exact in fp32; those constants are held too, as a second check."""

from pathlib import Path

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import guard as guard_mod

from test_torch_collectives import _run, file_store

N = 4  # parameter length
EF_N = 64  # the int8 scenario's parameter length
EF_GRAD = np.linspace(-1.0, 1.0, EF_N) * 0.37
GUARD_BAD = (False, True, False, True, True)  # NaN steps of the guard run


def _opt(params, lr=1.0, momentum=0.0, **kw):
    return hvd.DistributedOptimizer(
        torch.optim.SGD(params, lr=lr, momentum=momentum), **kw)


def _pass(p, g):
    """One backward pass whose gradient of ``p`` is ``g``."""
    (p * torch.as_tensor(g, dtype=torch.float32)).sum().backward()


def _windows(rank, **kw):
    """Five passes (gradients 1..5) at k = 2, then two flushes: the
    parameter after each pass and after each flush, and the flushes'
    returns."""
    p = torch.nn.Parameter(torch.zeros(N))
    opt = _opt([p], backward_passes_per_step=2, **kw)
    seen = []
    for i in range(1, 6):
        opt.zero_grad()
        _pass(p, np.full(N, float(i)))
        opt.step()
        seen.append(p.detach().clone())
    for _ in range(2):
        opt.flush()
        seen.append(p.detach().clone())
    opt.remove_hooks()
    return torch.stack(seen)


def _one_step(rank, grad, **kw):
    p = torch.nn.Parameter(torch.zeros(N))
    opt = _opt([p], **kw)
    _pass(p, grad)
    opt.step()
    opt.remove_hooks()
    return p.detach().clone()


def _guard_run(rank):
    """good, bad, good, bad, bad with SGD momentum; NaN on rank 0 only.
    Returns the parameters and momentum after each step, the guard's
    status, whether guard_check raised after each step."""
    guard_mod._reset_guard()
    p = torch.nn.Parameter(torch.zeros(N))
    opt = _opt([p], lr=0.5, momentum=0.5, grad_guard=True, guard_max_skips=2)
    rec = {"p": [], "m": [], "streak": [], "raised": [], "status": []}
    for bad in GUARD_BAD:
        opt.zero_grad()
        g = np.ones(N)
        if bad and rank == 0:
            g[1] = np.nan
        _pass(p, g)
        opt.step()
        rec["p"].append(p.detach().clone())
        rec["m"].append(opt.state[p]["momentum_buffer"].clone())
        rec["streak"].append(opt._streak)
        rec["status"].append(hvd.guard_status())
        try:
            hvd.guard_check()
            rec["raised"].append(False)
        except hvd.HorovodInternalError:
            rec["raised"].append(True)
    opt.remove_hooks()
    return rec


def _ef_grads(rank, bad):
    g = EF_GRAD.copy()
    if bad and rank == 0:
        g[3] = np.inf
    return g


def _guard_ef_run(rank):
    """The int8 wire with error feedback: a good step, then a bad one;
    the residual and the parameters after each."""
    p = torch.nn.Parameter(torch.zeros(EF_N))
    opt = _opt([p], lr=0.1, grad_guard=True,
               compression=hvd.Compression.int8, error_feedback=True)
    res, ps = [], []
    for bad in (False, True):
        opt.zero_grad()
        _pass(p, _ef_grads(rank, bad))
        opt.step()
        (r,) = opt.state_dict()["ef_residuals"].values()
        res.append(r.clone())
        ps.append(p.detach().clone())
    opt.remove_hooks()
    return {"residual": res, "p": ps}


def _scenarios(rank, n):
    ps = hvd.add_process_set([0])
    out = {
        "windows": _windows(rank),
        "windows_avg": _windows(rank, average_aggregated_gradients=True),
        "sum": _one_step(rank, np.ones(N), average=False),
        "average": _one_step(rank, np.full(N, 1.0 + rank), average=True),
        "scaled": _one_step(rank, np.ones(N), op=hvd.Sum,
                            prescale_factor=0.5, postscale_factor=3.0),
        "guard": _guard_run(rank),
        "guard_ef": _guard_ef_run(rank),
    }
    if rank == 0:  # only a member of the set reduces over it
        out["process_set"] = _one_step(rank, np.full(N, 1.0 + rank),
                                       process_set=ps)
    return out


def _worker(rank, n, outdir):
    hvd.init(device="cpu", store=file_store(outdir, n))
    out = _scenarios(rank, n)
    hvd.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world size: [each rank's results]} for worlds of 1 and 2."""
    import os

    saved = {v: os.environ.pop(v, None) for v in ("HOROVOD_RANK",
                                                  "HOROVOD_SIZE")}
    hvd.init(device="cpu")
    try:
        one = [_scenarios(0, 1)]
    finally:
        hvd.shutdown()
        os.environ.update({k: v for k, v in saved.items() if v is not None})
    two = _run(tmp_path_factory.mktemp("options"), 2, Path(__file__),
               "_worker", 180, None)
    return {1: one, 2: two}


# ------------------------------------------------- the JAX reference


def _jax_run(n, grads, p0, opt_kw, lr=1.0, momentum=None, ps_ranks=None):
    """``horovod_tpu.DistributedOptimizer(optax.sgd(lr, momentum),
    **opt_kw)`` on a mesh of the first ``n`` CPU devices, one jitted
    ``shard_map`` update a step (tests/test_integrity.py's harness).
    ``grads`` is ``[steps][rank] -> gradient``; ``ps_ranks`` registers a
    process set and passes it. Returns, after each step, rank 0's
    parameters, momentum (None without), error-feedback residual (None
    without), the guard's streak and the guard's status, and whether
    ``guard_check`` raised."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    import horovod_tpu as jhvd
    from horovod_tpu.common import guard as jguard
    from horovod_tpu.common.compat import shard_map

    kw = dict(opt_kw)
    if ps_ranks is not None:
        kw["process_set"] = jhvd.add_process_set(ps_ranks)
    opt = jhvd.DistributedOptimizer(optax.sgd(lr, momentum=momentum), **kw)
    mesh = Mesh(np.asarray(jax.devices()[:n]), (jhvd.WORLD_AXIS,))

    def body(g, state, params):
        updates, state = opt.update(g[0], state, params)
        return optax.apply_updates(params, updates), state

    step = jax.jit(shard_map(body, mesh=mesh,
                             in_specs=(P(jhvd.WORLD_AXIS), P(), P()),
                             out_specs=(P(), P()), check_vma=False))
    params = jnp.asarray(p0, jnp.float32)
    state = opt.init(params)
    rec = {"p": [], "m": [], "residual": [], "streak": [], "status": [],
           "raised": []}
    for g in grads:
        params, state = step(jnp.asarray(np.stack(g), jnp.float32), state,
                             params)
        jax.block_until_ready(params)
        rec["p"].append(np.asarray(params))
        rec["m"].append(None if momentum is None
                        else np.asarray(state.inner[0].trace))
        rec["residual"].append(None if state.residual is None
                               else np.asarray(state.residual))
        rec["streak"].append(None if state.guard_streak is None
                             else int(state.guard_streak))
        rec["status"].append(jguard.status())
        try:
            jguard.check()
            rec["raised"].append(False)
        except jhvd.HorovodInternalError:
            rec["raised"].append(True)
    return rec


def _reference(n):
    """Each scenario of ``_scenarios`` through the JAX optimizer, on the
    same per-rank gradients, in a world of ``n``."""
    from horovod_tpu.common import guard as jguard
    from horovod_tpu.ops.compression import Compression as JaxCompression
    from horovod_tpu.ops.reduction_ops import Sum as JaxSum

    def same(steps):  # every rank's gradient is the step's
        return [[np.asarray(g, np.float64)] * n for g in steps]

    def by_rank(fn, steps=1):
        return [[fn(r, i) for r in range(n)] for i in range(steps)]

    zeros = np.zeros(N)
    ramp = same([np.full(N, float(i)) for i in range(1, 6)])
    out = {
        "windows": _jax_run(n, ramp, zeros,
                            dict(backward_passes_per_step=2)),
        "windows_avg": _jax_run(n, ramp, zeros, dict(
            backward_passes_per_step=2, average_aggregated_gradients=True)),
        "sum": _jax_run(n, same([np.ones(N)]), zeros, dict(average=False)),
        "average": _jax_run(n, by_rank(lambda r, i: np.full(N, 1.0 + r)),
                            zeros, dict(average=True)),
        "scaled": _jax_run(n, same([np.ones(N)]), zeros, dict(
            op=JaxSum, prescale_factor=0.5, postscale_factor=3.0)),
        "process_set": _jax_run(n, by_rank(lambda r, i: np.full(N, 1.0 + r)),
                                zeros, {}, ps_ranks=[0]),
    }

    def guard_grad(r, i):
        g = np.ones(N)
        if GUARD_BAD[i] and r == 0:
            g[1] = np.nan
        return g

    jguard._reset_guard()
    out["guard"] = _jax_run(n, by_rank(guard_grad, len(GUARD_BAD)), zeros,
                            dict(grad_guard=True, guard_max_skips=2),
                            lr=0.5, momentum=0.5)
    jguard._reset_guard()
    out["guard_ef"] = _jax_run(
        n, by_rank(lambda r, i: _ef_grads(r, i == 1), 2), np.zeros(EF_N),
        dict(grad_guard=True, compression=JaxCompression.int8,
             error_feedback=True), lr=0.1)
    jguard._reset_guard()
    return out


@pytest.fixture(scope="module")
def reference():
    """{world size: the JAX optimizer's results} for worlds of 1 and 2,
    on tests/conftest.py's CPU mesh."""
    import horovod_tpu as jhvd

    jhvd.shutdown()
    jhvd.init()
    try:
        return {n: _reference(n) for n in (1, 2)}
    finally:
        jhvd.shutdown()


def _close(got, want):
    """fp32 within 1e-5."""
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=1e-5, atol=1e-5)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))


# after each of 5 passes (gradients 1..5, k = 2), then after 2 flushes
WINDOWS = [0, -3, -3, -10, -10, -15, -15]
WINDOWS_AVG = [0, -1.5, -1.5, -5, -5, -10, -10]


@pytest.mark.parametrize("key,want", [("windows", WINDOWS),
                                      ("windows_avg", WINDOWS_AVG)])
@pytest.mark.parametrize("n", [1, 2])
def test_windows_match_the_reference(worlds, reference, n, key, want):
    """Pass by pass, the JAX optimizer's window (5 passes at k = 2, the
    sum or with ``average_aggregated_gradients`` the mean); then the
    partial window the flush steps."""
    for r in worlds[n]:
        for i in range(5):
            _close(r[key][i], reference[n][key]["p"][i])
        _eq(r[key], np.repeat(want, N).reshape(-1, N))


@pytest.mark.parametrize("n", [1, 2])
def test_flush_steps_the_partial_window(worlds, n):
    for r in worlds[n]:
        _eq(r["windows"], np.repeat(WINDOWS, N).reshape(-1, N))


@pytest.mark.parametrize("n", [1, 2])
def test_average_aggregated_gradients(worlds, n):
    for r in worlds[n]:
        _eq(r["windows_avg"], np.repeat(WINDOWS_AVG, N).reshape(-1, N))


@pytest.mark.parametrize("n", [1, 2])
def test_average_false_sums(worlds, reference, n):
    for r in worlds[n]:
        _close(r["sum"], reference[n]["sum"]["p"][0])
        _close(r["average"], reference[n]["average"]["p"][0])
        _eq(r["sum"], np.full(N, -float(n)))
        # Average of 1 + rank over the ranks
        _eq(r["average"], np.full(N, -(1.0 + (n - 1) / 2)))


@pytest.mark.parametrize("n", [1, 2])
def test_pre_and_postscale(worlds, reference, n):
    for r in worlds[n]:
        _close(r["scaled"], reference[n]["scaled"]["p"][0])
        _eq(r["scaled"], np.full(N, -3.0 * 0.5 * n))


@pytest.mark.parametrize("n", [1, 2])
def test_process_set_of_one_rank(worlds, reference, n):
    """Rank 0's gradient alone, though rank 1's differs."""
    _close(worlds[n][0]["process_set"], reference[n]["process_set"]["p"][0])
    _eq(worlds[n][0]["process_set"], np.full(N, -1.0))


@pytest.mark.parametrize("n", [1, 2])
def test_guard_matches_the_reference(worlds, reference, n):
    """good, bad, good, bad, bad at ``guard_max_skips=2``, step by step:
    parameters and momentum (a skip leaves both), the streak (a good
    step resets it), the skip count, the longest streak, the latch and
    the one raise of ``guard_check``."""
    ref = reference[n]["guard"]
    for r in worlds[n]:
        g = r["guard"]
        for i in range(len(GUARD_BAD)):
            _close(g["p"][i], ref["p"][i])
            _close(g["m"][i], ref["m"][i])
        assert g["streak"] == ref["streak"] == [0, 1, 0, 1, 2]
        assert g["status"] == ref["status"]
        assert g["raised"] == ref["raised"]


@pytest.mark.parametrize("n", [1, 2])
def test_guard_skips_counts_and_escalates(worlds, n):
    # lr 0.5, momentum 0.5, g = 1: applied steps move m 1, 1.5, and p by
    # 0.5 m; skipped steps leave both
    want_m = [1.0, 1.0, 1.5, 1.5, 1.5]
    want_p = [-0.5, -0.5, -1.25, -1.25, -1.25]
    for r in worlds[n]:
        g = r["guard"]
        for i in range(5):
            _eq(g["p"][i], np.full(N, want_p[i]))
            _eq(g["m"][i], np.full(N, want_m[i]))
        assert [s["nonfinite_steps"] for s in g["status"]] == [0, 1, 1, 2, 3]
        assert g["status"][-1]["max_streak"] == 2
        # the second consecutive skip latches; check raises once
        assert g["raised"] == [False, False, False, False, True]


@pytest.mark.parametrize("n", [1, 2])
def test_guard_keeps_the_applied_residuals(worlds, reference, n):
    """The int8 wire with error feedback: the skipped step keeps the
    good step's residual and parameters, bit for bit, as the reference
    does; both residuals lie within the wire's rounding of the
    reference's (the rounding bits differ: Philox against jax.random;
    each residual is within one quantum of zero)."""
    ref = reference[n]["guard_ef"]
    np.testing.assert_array_equal(ref["residual"][1], ref["residual"][0])
    np.testing.assert_array_equal(ref["p"][1], ref["p"][0])
    quantum = float(np.abs(EF_GRAD).max()) / 127
    for r in worlds[n]:
        res, p = r["guard_ef"]["residual"], r["guard_ef"]["p"]
        assert float(res[0].abs().max()) > 0  # the wire did quantize
        assert torch.equal(res[1], res[0])
        assert torch.equal(p[1], p[0])
        assert torch.isfinite(p[1]).all()
    r0 = worlds[n][0]["guard_ef"]
    np.testing.assert_allclose(r0["residual"][0].numpy(), ref["residual"][0],
                               rtol=0, atol=2 * quantum * 1.0001)
    np.testing.assert_allclose(r0["p"][0].numpy(), ref["p"][0], rtol=0,
                               atol=0.1 * quantum * 1.0001)


def test_flush_matches_the_reference_shim(hvd):
    """Pass by pass against ``horovod_tpu.torch``'s optimizer (the JAX
    mesh of tests/conftest.py): the shim's window and flush."""
    import horovod_tpu.torch as hvd_torch

    p = torch.nn.Parameter(torch.zeros(N))
    opt = hvd_torch.DistributedOptimizer(torch.optim.SGD([p], lr=1.0),
                                         backward_passes_per_step=2)
    seen = []
    for i in range(1, 6):
        opt.zero_grad()
        _pass(p, np.full(N, float(i)))
        opt.step()
        seen.append(p.detach().clone())
    for _ in range(2):
        opt.flush()
        seen.append(p.detach().clone())
    _eq(torch.stack(seen), np.repeat(WINDOWS, N).reshape(-1, N))


def test_options_raise(monkeypatch):
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    hvd.init(device="cpu")
    try:
        p = [torch.nn.Parameter(torch.zeros(N))]
        with pytest.raises(ValueError, match="cannot both be set"):
            _opt(p, average=True, op=hvd.Sum)
        # local SGD (ROADMAP A11) is ported: in a world of one there is
        # no second slice, its option checks come first, and one local
        # step is the plain path
        for kw, match in ((dict(local_sgd_steps=4), "two-level topology"),
                          (dict(local_sgd_steps=4,
                                local_sgd_inter_wire="fp8"), "inter_wire"),
                          (dict(local_sgd_steps=4, op=hvd.Adasum),
                           "Sum/Average")):
            with pytest.raises(ValueError, match=match):
                _opt(p, **kw)
        _opt(p, local_sgd_inter_wire="int8", local_sgd_intra=2).remove_hooks()
        # the bucketed overlap (ROADMAP A8) is ported: its options are
        # accepted, and an explicit bucket count refuses Adasum
        _opt(p, overlap_buckets=2).remove_hooks()
        _opt(p, overlap_min_bytes=1024).remove_hooks()
        with pytest.raises(ValueError, match="overlap_buckets"):
            _opt(p, op=hvd.Adasum, overlap_buckets=2)
        # the plain path's spellings of those options are accepted
        _opt(p, overlap_buckets=0, local_sgd_steps=1).remove_hooks()
        monkeypatch.setenv("HOROVOD_GUARD", "1")
        assert _opt(p)._guard
    finally:
        hvd.shutdown()
