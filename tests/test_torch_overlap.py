"""The port's bucketed overlap (``horovod_tpu_torch/ops/overlap.py`` and
``DistributedOptimizer(overlap_buckets=)``) against the JAX package's
``ops/overlap.py``.

- ``build_bucket_schedule`` gives the JAX buckets and bytes, exactly, on
  the oracle's cases (``tests/test_overlap.py:57-110``) and on mixed
  trees; the schedule cache counts its hits and misses.
- In a gloo world of 2 processes (one shared world, ``_overlap_worker``)
  on inputs made from a numpy seed, rank r taking row r:
  ``bucketed_allreduce`` with Sum on fp32 is bitwise the per-tensor
  ``traced.allreduce`` (a sum of two numbers does not depend on the
  order) and within 2 ulp of JAX's ``bucketed_allreduce`` on 2 devices
  of the 8-device CPU mesh; the int8 buckets hold the stochastic
  contract (within the two-stage quantum budget of the exact sum, and
  the error-feedback identity: the output plus every rank's new
  residual is the exact sum, to fp32 rounding), with the residuals
  sliced per bucket; ``return_finite``, a process set and the join
  mask; ``overlap_boundary``'s gradients are bitwise the bucketed
  exchange of the local gradients; and the optimizer with overlap on is
  bitwise the optimizer with overlap off, with one and two backward
  passes a step, a parameter that never has a gradient, one that has
  it on some passes only, and one that stops receiving gradients after
  the first pass (neither path steps it again, nor changes its carried
  residual under error feedback). Stochastic rounding cannot match JAX's bits
  (Philox against ``jax.random``), so the quantized cases hold the
  contract, not JAX's values.
- The environment's defaults (``HOROVOD_OVERLAP*``) and the raise for
  an explicit ``overlap_buckets`` with Adasum, in a world of one.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_collectives import _run, file_store

N = 2
SHAPES = [(33, 7), (129,), (64,), (5, 5, 5), (3,)]
BLOCK = 64
ULP = np.finfo(np.float32).eps


def _tree_np(n, seed, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {f"p{i:02d}": rng.normal(size=(n,) + s).astype(np.float32)
            for i, s in enumerate(shapes)}


def _rank_tree(tree, rank):
    return {k: torch.from_numpy(v[rank].copy()) for k, v in tree.items()}


class _Net(torch.nn.Module):
    """A small MLP with a parameter used on the first pass of a window
    only and one never used."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.w1 = torch.nn.Parameter(torch.randn(6, 16, generator=g) * 0.3)
        self.b1 = torch.nn.Parameter(torch.zeros(16))
        self.sometimes = torch.nn.Parameter(torch.randn(16, generator=g))
        self.unused = torch.nn.Parameter(torch.randn(5, generator=g))
        self.w2 = torch.nn.Parameter(torch.randn(16, 3, generator=g) * 0.3)

    def forward(self, x, first):
        h = torch.tanh(x @ self.w1 + self.b1)
        if first:
            h = h * self.sometimes
        return h @ self.w2


class _LateNet(_Net):
    """:class:`_Net` with a parameter used on the first backward pass of
    the run only, which then stops receiving gradients."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(1)
        self.late = torch.nn.Parameter(torch.randn(3, generator=g))
        self.passes = 0

    def forward(self, x, first):
        out = super().forward(x, first)
        if self.passes == 0:
            out = out * self.late
        self.passes += 1
        return out


INNER = {
    "sgd": lambda ps: torch.optim.SGD(ps, lr=0.05, momentum=0.9),
    "sgd_wd": lambda ps: torch.optim.SGD(ps, lr=0.05, momentum=0.9,
                                         weight_decay=0.1),
    "adamw": lambda ps: torch.optim.AdamW(ps, lr=0.05),
}


def _train(hvd, rank, buckets, k, steps=3, net_cls=_Net, inner="sgd",
           **kw):
    net = net_cls()
    opt = hvd.DistributedOptimizer(
        INNER[inner](net.parameters()),
        named_parameters=net.named_parameters(), op=kw.pop("op", hvd.Sum),
        backward_passes_per_step=k, overlap_buckets=buckets,
        overlap_min_bytes=0, **kw)
    rng = np.random.default_rng(100 + rank)
    seen = []
    for _ in range(steps * k):
        x = torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32))
        first = opt._micro == 0
        net(x, first).pow(2).sum().backward()
        opt.step()
        opt.zero_grad()
        seen.append([p.detach().clone() for p in net.parameters()])
        if kw.get("error_feedback"):  # the carried residuals, by index
            seen[-1].append(dict(opt.state_dict()["ef_residuals"]))
    dispatched = opt._overlap.dispatched if opt._overlap else 0
    opt.remove_hooks()
    return seen, dispatched


def _overlap_worker(rank, n, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import overlap, traced

    hvd.init(device="cpu", store=file_store(outdir, n))
    out = {}
    tree = _rank_tree(_tree_np(n, 1), rank)
    out["sum"] = hvd.bucketed_allreduce(tree, op=hvd.Sum, n_buckets=3,
                                        min_bucket_bytes=0)
    out["per_tensor"] = {k: traced.allreduce(v, op=hvd.Sum)
                         for k, v in tree.items()}
    out["avg"] = hvd.bucketed_allreduce(tree, n_buckets=3,
                                        min_bucket_bytes=0)
    out["avg_per_tensor"] = {k: traced.allreduce(v) for k, v in tree.items()}
    out["scaled"] = hvd.bucketed_allreduce(
        tree, op=hvd.Sum, n_buckets=2, prescale_factor=0.5,
        postscale_factor=4.0, min_bucket_bytes=0)

    # int8 buckets with error feedback, and the per-row wire
    blocks = hvd.Compression.int8_block.with_block_size(BLOCK)
    zeros = {k: torch.zeros_like(v) for k, v in tree.items()}
    red, res, fin = hvd.bucketed_allreduce(
        tree, op=hvd.Sum, n_buckets=3, compression=blocks, residuals=zeros,
        seed=7, return_finite=True, min_bucket_bytes=0)
    out["q"], out["q_res"], out["q_finite"] = red, res, fin
    out["q_rows"] = hvd.bucketed_allreduce(
        tree, op=hvd.Sum, n_buckets=2, compression=hvd.Compression.int8,
        seed=3, min_bucket_bytes=0)

    # the guard's flag: one rank's inf reaches every rank's flag
    bad = dict(tree)
    bad["p01"] = bad["p01"].clone()
    if rank == 1:
        bad["p01"][5] = float("inf")
    out["finite_good"] = hvd.bucketed_allreduce(
        tree, n_buckets=3, return_finite=True, min_bucket_bytes=0)[1]
    out["finite_bad"] = hvd.bucketed_allreduce(
        bad, n_buckets=3, return_finite=True, min_bucket_bytes=0)[1]

    # a process set of rank 0 and the join mask that drops rank 1
    ps = hvd.add_process_set([0])
    out["set"] = hvd.bucketed_allreduce(tree, op=hvd.Sum, n_buckets=2,
                                        process_set=ps, min_bucket_bytes=0)
    out["mask"] = hvd.bucketed_allreduce(tree, n_buckets=2,
                                         mask=[True, False],
                                         min_bucket_bytes=0)
    for name, kw in (("adasum", dict(op=hvd.Adasum)),
                     ("q_set", dict(compression=blocks, process_set=ps)),
                     ("ef_fp32", dict(residuals=zeros))):
        try:
            hvd.bucketed_allreduce(tree, **kw)
            out[f"raise_{name}"] = None
        except (ValueError, NotImplementedError) as e:
            out[f"raise_{name}"] = type(e).__name__

    # the boundary: gradients come out as the bucketed exchange's
    net = _Net()
    params = dict(net.named_parameters())
    x = torch.from_numpy(np.random.default_rng(50 + rank).normal(
        size=(4, 6)).astype(np.float32))
    local = torch.autograd.grad(net(x, True).pow(2).sum(),
                                list(params.values()), allow_unused=True,
                                materialize_grads=True)
    out["boundary_want"] = hvd.bucketed_allreduce(
        dict(zip(params, local)), n_buckets=3, min_bucket_bytes=0)
    through = hvd.overlap_boundary(params, n_buckets=3, min_bucket_bytes=0)
    loss = torch.func.functional_call(net, through, (x, True)).pow(2).sum()
    loss.backward()
    out["boundary_got"] = {k: p.grad.clone() for k, p in params.items()}

    # the optimizer, overlap on and off
    for k in (1, 2):
        on, out[f"dispatched_k{k}"] = _train(hvd, rank, 3, k)
        off, _ = _train(hvd, rank, 0, k)
        out[f"opt_on_k{k}"], out[f"opt_off_k{k}"] = on, off
    # a parameter that stops receiving gradients after the first pass,
    # under optimizers whose state or decay would move it (C2)
    for k in (1, 2):
        for inner in ("sgd_wd", "adamw"):
            on, _ = _train(hvd, rank, 3, k, net_cls=_LateNet, inner=inner)
            off, _ = _train(hvd, rank, 0, k, net_cls=_LateNet, inner=inner)
            out[f"late_{inner}_k{k}"] = (on, off)
            on, _ = _train(hvd, rank, 3, k, net_cls=_LateNet, inner=inner,
                           compression=blocks, error_feedback=True)
            off, _ = _train(hvd, rank, 0, k, net_cls=_LateNet, inner=inner,
                            compression=blocks, error_feedback=True)
            out[f"late_ef_{inner}_k{k}"] = (on, off)
    avg_on, _ = _train(hvd, rank, 2, 1, op=hvd.Average)
    avg_off, _ = _train(hvd, rank, 0, 1, op=hvd.Average)
    out["opt_avg"] = (avg_on, avg_off)
    ef, _ = _train(hvd, rank, 2, 1, steps=2, compression=blocks,
                   error_feedback=True)
    exact, _ = _train(hvd, rank, 0, 1, steps=2)
    out["opt_ef"] = (ef, exact)
    out["schedule_stats"] = overlap.schedule_cache_stats()
    hvd.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    path = tmp_path_factory.mktemp("overlap")
    return _run(path, N, Path(__file__), "_overlap_worker", 150, None)


# ----------------------------------------------------------- the schedule


def _jax_schedule(leaves, n, min_bytes):
    from horovod_tpu.ops import overlap as joverlap

    return joverlap.build_bucket_schedule(leaves, n, min_bucket_bytes=min_bytes)


SCHEDULE_CASES = {
    # tests/test_overlap.py:57-110
    "reverse_balance": ([((64,), np.float32)] * 8, 4, 0),
    "dtype_boundary": ([((16,), np.float32), ((16,), np.float16),
                        ((16,), np.float16)], 1, 0),
    "min_bytes_merge": ([((64,), np.float32)] * 8, 8, 512),
    # mixed trees: a large leaf straddling a boundary, dtype runs, the
    # tail merge, more buckets than leaves
    "straddle": ([((1000,), np.float32), ((10,), np.float32),
                  ((3000, 2), np.float32), ((7,), np.float32),
                  ((500,), np.float32)], 3, 0),
    "dtype_runs": ([((100,), np.float32), ((100,), "bfloat16"),
                    ((50,), "bfloat16"), ((300,), np.float32),
                    ((20,), np.float16)], 2, 0),
    "tail_merge": ([((256,), np.float32)] * 5 + [((8,), np.float32)], 3,
                   2048),
    "many_buckets": ([((3,), np.float32), ((5,), np.float32)], 6, 0),
    "gpt_like": ([((50257 // 97, 64), np.float32), ((256, 64), np.float32),
                  ((64,), np.float32), ((64, 192), np.float32),
                  ((192,), np.float32), ((64, 64), np.float32),
                  ((64,), np.float32)] * 3, 4, 16384),
}


def _torch_dtype(d):
    return {np.float32: torch.float32, np.float16: torch.float16,
            "bfloat16": torch.bfloat16}[d]


@pytest.mark.parametrize("case", sorted(SCHEDULE_CASES))
def test_schedule_equals_jax(case):
    import jax.numpy as jnp
    from horovod_tpu_torch.ops import overlap

    specs, n, min_bytes = SCHEDULE_CASES[case]
    jleaves = [np.zeros(s, jnp.bfloat16 if d == "bfloat16" else d)
               for s, d in specs]
    tleaves = [torch.zeros(s, dtype=_torch_dtype(d)) for s, d in specs]
    want = _jax_schedule(jleaves, n, min_bytes)
    got = overlap.build_bucket_schedule(tleaves, n, min_bucket_bytes=min_bytes)
    assert got.buckets == want.buckets
    assert got.bucket_bytes == want.bucket_bytes
    assert got.total_bytes == want.total_bytes
    assert got.n_buckets == want.n_buckets
    if case == "reverse_balance":
        assert got.buckets == ((7, 6), (5, 4), (3, 2), (1, 0))
    if case == "min_bytes_merge":
        assert all(b >= 512 for b in got.bucket_bytes)


def test_leaves_without_gradient_pass_through():
    """None plays the part of JAX's float0 cotangent."""
    from horovod_tpu_torch.ops import overlap

    s = overlap.build_bucket_schedule([torch.zeros(8), None], 2)
    assert s.passthrough == (1,) and s.buckets == ((0,),)
    with pytest.raises(ValueError, match="n_buckets"):
        overlap.build_bucket_schedule([torch.zeros(8)], 0)


def test_schedule_cache_hits_and_misses():
    from torch.utils import _pytree as pytree

    from horovod_tpu_torch.common import metrics
    from horovod_tpu_torch.ops import overlap

    overlap.reset_schedule_cache()
    tree = {"a": torch.zeros(32), "b": torch.zeros(16),
            "c": torch.zeros(8, 4)}
    leaves, spec = pytree.tree_flatten(tree)
    for _ in range(5):
        sched = overlap.schedule_for(leaves, spec, 2)
    stats = overlap.schedule_cache_stats()
    assert (stats["misses"], stats["hits"], stats["size"]) == (1, 4, 1)
    overlap.schedule_for(leaves, spec, 3)
    assert overlap.schedule_cache_stats()["misses"] == 2
    overlap._publish(sched)
    snap = metrics.registry.snapshot()
    assert snap["overlap.buckets"] == sched.n_buckets
    assert snap["overlap.bucket_bytes_total"] == sched.total_bytes == 320
    assert snap["overlap.bucket_bytes_max"] == max(sched.bucket_bytes)
    assert snap["overlap.bucket_bytes_min"] == min(sched.bucket_bytes)
    overlap.reset_schedule_cache()
    assert overlap.schedule_cache_stats() == {"hits": 0, "misses": 0,
                                              "disk_hits": 0, "size": 0}


# ------------------------------------------------- the bucketed exchange


def _jax_bucketed(tree_np, n, **kw):
    """JAX's bucketed_allreduce on n devices, rank r's leaves row r."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from horovod_tpu.ops import overlap as joverlap

    mesh = Mesh(np.asarray(jax.devices()[:n]), ("hvd",))
    fn = jax.jit(jax.shard_map(
        lambda t: jax.tree_util.tree_map(
            lambda v: v[None], joverlap.bucketed_allreduce(
                jax.tree_util.tree_map(lambda v: v[0], t), **kw)),
        mesh=mesh, in_specs=P("hvd"), out_specs=P("hvd"), check_vma=False))
    return jax.tree_util.tree_map(np.asarray, fn(tree_np))


def test_sum_fp32_bitwise_per_tensor_and_close_to_jax(world):
    from horovod_tpu.ops.reduction_ops import Average, Sum

    tree = _tree_np(N, 1)
    jsum = _jax_bucketed(tree, N, op=Sum, n_buckets=3, min_bucket_bytes=0,
                         hier_stages=None)
    javg = _jax_bucketed(tree, N, op=Average, n_buckets=3,
                         min_bucket_bytes=0, hier_stages=None)
    for r, o in enumerate(world):
        for k in tree:
            assert torch.equal(o["sum"][k], o["per_tensor"][k]), k
            assert torch.equal(o["avg"][k], o["avg_per_tensor"][k]), k
            for got, want in ((o["sum"][k], jsum[k][r]),
                              (o["avg"][k], javg[k][r])):
                tol = 2 * ULP * np.abs(want).max()
                assert np.abs(got.numpy() - want).max() <= tol, k
            want = tree[k].astype(np.float64).sum(0) * 2.0
            assert np.abs(o["scaled"][k].numpy() - want).max() <= (
                4 * ULP * np.abs(want).max())


def _quantum_budget(tree):
    """Two stochastic roundings of under one quantum each: stage 1 on
    every rank's blocks, stage 2 on the summed shard; a block's quantum
    is at most its largest magnitude / 127."""
    stage1 = sum(max(np.abs(v[r]).max() for v in tree.values())
                 for r in range(N))
    total = max(np.abs(v.sum(0)).max() for v in tree.values())
    return 1.01 * (stage1 + total) / 127


def test_quantized_buckets_hold_the_contract(world):
    tree = _tree_np(N, 1)
    budget = _quantum_budget(tree)
    for key in ("q", "q_rows"):
        for o in world:
            for k, v in tree.items():
                err = np.abs(o[key][k].numpy() - v.sum(0)).max()
                assert err <= budget, (key, k, err, budget)
            for k in tree:  # every rank takes the same dequantized values
                assert torch.equal(o[key][k], world[0][key][k])
    # error feedback: the output plus every rank's carry is the exact sum
    for k, v in tree.items():
        carry = sum(o["q_res"][k].double() for o in world)
        got = world[0]["q"][k].double() + carry
        want = torch.from_numpy(v.astype(np.float64).sum(0))
        assert (got - want).abs().max() <= 8 * ULP * float(want.abs().max())
        assert world[0]["q_res"][k].shape == v.shape[1:]
    assert all(bool(o["q_finite"]) for o in world)


def test_finite_flag_process_set_mask_and_raises(world):
    tree = _tree_np(N, 1)
    for r, o in enumerate(world):
        assert bool(o["finite_good"]) and not bool(o["finite_bad"])
        for k, v in tree.items():
            # the set [0]: rank 0 reduces alone, rank 1 keeps its input
            np.testing.assert_array_equal(o["set"][k].numpy(), v[r])
            # the mask drops rank 1: Average over the one live rank
            np.testing.assert_array_equal(o["mask"][k].numpy(), v[0])
        assert o["raise_adasum"] == "ValueError"
        assert o["raise_q_set"] == "NotImplementedError"
        assert o["raise_ef_fp32"] == "ValueError"


def test_boundary_gradients_are_the_bucketed_exchange(world):
    for o in world:
        assert set(o["boundary_got"]) == set(o["boundary_want"])
        for k, want in o["boundary_want"].items():
            assert torch.equal(o["boundary_got"][k], want), k
        # the unused parameter's gradient is the reduction of zeros
        assert torch.equal(o["boundary_got"]["unused"],
                           torch.zeros_like(o["boundary_got"]["unused"]))
    for k in world[0]["boundary_got"]:
        assert torch.equal(world[0]["boundary_got"][k],
                           world[1]["boundary_got"][k])


# ------------------------------------------------------------ the optimizer


@pytest.mark.parametrize("k", [1, 2])
def test_optimizer_overlap_bitwise_equal_to_fused(world, k):
    """Sum on fp32: overlap on and off give the same bits after every
    pass, with a parameter that never has a gradient (zeros reduce to
    zeros and leave it where it was) and one that has it on the first
    pass of a window only; one collective a bucket a window. A parameter
    used on the run's first pass only is then left alone (its ``.grad``
    stays None) under SGD with momentum and weight decay and under
    AdamW, with and without the int8_block wire's error feedback, whose
    carried residual it keeps."""
    for o in world:
        on, off = o[f"opt_on_k{k}"], o[f"opt_off_k{k}"]
        assert len(on) == len(off) == 3 * k
        for step, (a, b) in enumerate(zip(on, off)):
            for i, (x, y) in enumerate(zip(a, b)):
                assert torch.equal(x, y), (step, i)
        assert torch.equal(on[-1][3], on[0][3])  # "unused" never moved
        assert o[f"dispatched_k{k}"] == 3 * 3  # 3 buckets, 3 windows
    for a, b in zip(world[0][f"opt_on_k{k}"][-1], world[1][f"opt_on_k{k}"][-1]):
        assert torch.equal(a, b)
    # a parameter used on the first pass only is stepped once, then left
    # alone by SGD with momentum and weight decay and by AdamW, on both
    # paths, bitwise; under int8_block with error feedback the buckets'
    # and the fused batches' roundings differ by construction (blocks
    # and seeds), so there the parameter's freeze and its carried
    # residual are held bitwise on each path
    late = 5  # _LateNet's parameter order: w1, b1, sometimes, unused, w2
    for o in world:
        for inner in ("sgd_wd", "adamw"):
            on, off = o[f"late_{inner}_k{k}"]
            for step, (a, b) in enumerate(zip(on, off)):
                for i, (x, y) in enumerate(zip(a, b)):
                    assert torch.equal(x, y), (inner, step, i)
            for path in o[f"late_ef_{inner}_k{k}"]:
                first = path[k - 1]  # the end of the first window
                for later in path[k:]:
                    assert torch.equal(later[late], first[late]), inner
                    assert torch.equal(later[-1][late], first[-1][late])


def test_optimizer_overlap_average_and_error_feedback(world):
    for o in world:
        on, off = o["opt_avg"]
        for a, b in zip(on[-1], off[-1]):
            assert torch.equal(a, b)
        ef, exact = o["opt_ef"]
        for a, b in zip(ef[-1][:-1], exact[-1]):
            # two SGD-momentum steps on int8 gradients stay near the
            # exact ones (the wire's error is a few quanta of gradients
            # of order one, times the learning rate)
            assert (a - b).abs().max() < 0.05
    for a, b in zip(world[0]["opt_ef"][0][-1][:-1],
                    world[1]["opt_ef"][0][-1][:-1]):
        assert torch.equal(a, b)
    assert world[0]["schedule_stats"]["misses"] >= 1


def test_env_defaults_and_explicit_adasum_raise(monkeypatch):
    import horovod_tpu_torch as hvd

    for var in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOROVOD_OVERLAP", "1")
    monkeypatch.setenv("HOROVOD_OVERLAP_BUCKETS", "3")
    monkeypatch.setenv("HOROVOD_OVERLAP_MIN_BYTES", "0")
    hvd.init(device="cpu")
    try:
        cfg = hvd.get_config()
        assert (cfg.overlap, cfg.overlap_buckets, cfg.overlap_min_bytes) == (
            True, 3, 0)
        net = _Net()
        sgd = torch.optim.SGD(net.parameters(), lr=0.1)
        opt = hvd.DistributedOptimizer(sgd)
        assert opt._overlap is not None
        assert opt._overlap.schedule.n_buckets == 3
        opt.remove_hooks()
        # the environment's default falls back to fusion for Adasum
        opt = hvd.DistributedOptimizer(sgd, op=hvd.Adasum)
        assert opt._overlap is None
        opt.remove_hooks()
        for op in (hvd.Adasum, hvd.Min, hvd.Max, hvd.Product):
            with pytest.raises(ValueError, match="overlap_buckets"):
                hvd.DistributedOptimizer(sgd, op=op, overlap_buckets=2)
        opt = hvd.DistributedOptimizer(sgd, overlap_buckets=0)
        assert opt._overlap is None
        opt.remove_hooks()
    finally:
        hvd.shutdown()
    monkeypatch.delenv("HOROVOD_OVERLAP")
    hvd.init(device="cpu")
    try:
        assert not hvd.get_config().overlap
        opt = hvd.DistributedOptimizer(torch.optim.SGD(_Net().parameters(),
                                                       lr=0.1))
        assert opt._overlap is None
        opt.remove_hooks()
    finally:
        hvd.shutdown()
