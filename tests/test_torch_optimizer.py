"""The port's DistributedOptimizer against the JAX package's.

A small MLP trains for a few steps of SGD with momentum. The port runs in
a gloo world of 2, each rank holding half of the global batch; the JAX
``horovod_tpu.DistributedOptimizer(optax.sgd(lr, momentum))`` runs on
the 8-device CPU mesh of tests/conftest.py, each device holding an
eighth. Both average to the full-batch gradient, so the trajectories
agree within 1e-5 (fp32 sums in another order). Also:
``backward_passes_per_step=2`` with ``zero_grad`` between the passes
(the summed micro-gradients equal the full-batch step at twice the
rate), ``gradient_predivide_factor``, ``broadcast_parameters``,
``broadcast_optimizer_state`` and ``broadcast_object``, and the options
of later slices (the bucketed overlap) and misuse raising."""

from pathlib import Path

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd

from test_torch_collectives import _run, file_store

LR, MOMENTUM, STEPS = 0.1, 0.9, 5
GLOBAL_BATCH = 16


def _data():
    rng = np.random.default_rng(7)
    params = {
        "w1": rng.normal(size=(4, 8)).astype(np.float32) * 0.5,
        "b1": rng.normal(size=(8,)).astype(np.float32) * 0.1,
        "w2": rng.normal(size=(8, 2)).astype(np.float32) * 0.5,
        "b2": np.zeros(2, np.float32),
    }
    x = rng.normal(size=(GLOBAL_BATCH, 4)).astype(np.float32)
    y = rng.normal(size=(GLOBAL_BATCH, 2)).astype(np.float32)
    return params, x, y


class _MLP(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for k, v in params.items():
            setattr(self, k, torch.nn.Parameter(torch.from_numpy(v.copy())))

    def forward(self, x):
        return torch.tanh(x @ self.w1 + self.b1) @ self.w2 + self.b2


def _train(model, opt, x, y, steps, micro):
    """``steps`` optimizer steps, each of ``micro`` backward passes over
    equal slices of (x, y), ``zero_grad`` before every pass."""
    traj = []
    xs, ys = torch.chunk(x, micro), torch.chunk(y, micro)
    for _ in range(steps):
        for i in range(micro):
            opt.zero_grad(set_to_none=True)
            ((model(xs[i]) - ys[i]) ** 2).mean().backward()
            result = opt.step()
            if i < micro - 1:
                assert result is None  # the middle of a window
        traj.append({k: v.detach().clone()
                     for k, v in model.state_dict().items()})
    return traj


def _optimizer_worker(rank, n, outdir):
    params, x, y = _data()
    shard = slice(rank * GLOBAL_BATCH // n, (rank + 1) * GLOBAL_BATCH // n)
    x, y = torch.from_numpy(x[shard]), torch.from_numpy(y[shard])
    hvd.init(device="cpu", store=file_store(outdir, n))
    out = {}
    for name, kw, micro in (("k1", {}, 1),
                            ("k2", {"backward_passes_per_step": 2}, 2),
                            ("predivide", {"gradient_predivide_factor": 4.0},
                             1)):
        model = _MLP(params)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM),
            named_parameters=model.named_parameters(), op=hvd.Average, **kw,
        )
        out[name] = _train(model, opt, x, y, STEPS, micro)
        opt.remove_hooks()
    # broadcasts: rank 1 starts elsewhere and takes rank 0's state
    model = _MLP({k: v + rank for k, v in params.items()})
    sgd = torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM)
    if rank == 0:
        ((model(x) - y) ** 2).mean().backward()
        sgd.step()
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(sgd, root_rank=0)
    out["bcast_params"] = {k: v.clone() for k, v in model.state_dict().items()}
    out["bcast_momentum"] = [sgd.state[p]["momentum_buffer"].clone()
                             for p in model.parameters()]
    out["bcast_object"] = hvd.broadcast_object({"rank": rank}, root_rank=1)
    out["allgather_object"] = hvd.allgather_object(rank * 10)
    hvd.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def port_world(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("opt"), 2, Path(__file__),
                "_optimizer_worker", 180, None)


def _jax_trajectory(lr):
    """The JAX DistributedOptimizer on the 8-device CPU mesh, the global
    batch split evenly over the devices."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    import horovod_tpu as hvd_j

    params, x, y = _data()
    hvd_j.shutdown()
    hvd_j.init()
    try:
        opt = hvd_j.DistributedOptimizer(optax.sgd(lr, momentum=MOMENTUM))

        def loss(p, xb, yb):
            pred = jnp.tanh(xb @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
            return jnp.mean((pred - yb) ** 2)

        def step(p, state, xb, yb):
            g = jax.grad(loss)(p, xb, yb)
            upd, state = opt.update(g, state, p)
            return optax.apply_updates(p, upd), state

        world = hvd_j.WORLD_AXIS
        f = jax.jit(jax.shard_map(
            step, mesh=hvd_j.mesh(), in_specs=(P(), P(), P(world), P(world)),
            out_specs=(P(), P()), check_vma=False,
        ))
        p = {k: jnp.asarray(v) for k, v in params.items()}
        state = opt.init(p)
        traj = []
        for _ in range(STEPS):
            p, state = f(p, state, jnp.asarray(x), jnp.asarray(y))
            traj.append({k: np.asarray(v) for k, v in p.items()})
        return traj
    finally:
        hvd_j.shutdown()


def _assert_trajectory(got, want, atol=1e-5):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            np.testing.assert_allclose(g[k].numpy(), w[k], atol=atol, rtol=0,
                                       err_msg=f"step {i} {k}")


def test_trajectory_matches_jax(port_world):
    want = _jax_trajectory(LR)
    for out in port_world:
        _assert_trajectory(out["k1"], want)
    # and it moved: the last step differs from the first
    assert not np.allclose(want[0]["w1"], want[-1]["w1"])


def test_backward_passes_per_step_sums_micro_gradients(port_world):
    """Two passes of half the shard, summed: the full-shard gradient
    twice over, so the trajectory is the full-batch one at 2·lr."""
    want = _jax_trajectory(2 * LR)
    for out in port_world:
        _assert_trajectory(out["k2"], want)


def test_gradient_predivide_factor(port_world):
    for out in port_world:
        _assert_trajectory(out["predivide"],
                           [{k: v.numpy() for k, v in s.items()}
                            for s in out["k1"]], atol=1e-6)


def test_broadcasts(port_world):
    root = port_world[0]
    for out in port_world:
        for k, v in root["bcast_params"].items():
            assert torch.equal(out["bcast_params"][k], v)
        for got, want in zip(out["bcast_momentum"], root["bcast_momentum"]):
            assert torch.equal(got, want)
        assert out["bcast_object"] == {"rank": 1}
        assert out["allgather_object"] == [0, 10]


def test_unported_options_raise(monkeypatch):
    for name in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    try:
        model = _MLP(_data()[0])
        sgd = torch.optim.SGD(model.parameters(), lr=LR)
        # the bucketed overlap (ROADMAP A8) is ported: accepted for
        # Sum/Average, refused for an op that does not commute with the
        # buckets' concatenation
        hvd.DistributedOptimizer(sgd, overlap_buckets=2).remove_hooks()
        with pytest.raises(ValueError, match="overlap_buckets"):
            hvd.DistributedOptimizer(sgd, op=hvd.Adasum, overlap_buckets=2)
        with pytest.raises(ValueError, match="Adasum"):
            hvd.DistributedOptimizer(sgd, op=hvd.Adasum,
                                     compression=hvd.Compression.int8)
        with pytest.raises(ValueError, match="quantized-wire"):
            hvd.DistributedOptimizer(sgd, error_feedback=True)
        with pytest.raises(ValueError, match="predivide"):
            hvd.DistributedOptimizer(sgd, op=hvd.Sum,
                                     gradient_predivide_factor=2.0)
        opt = hvd.DistributedOptimizer(sgd)
        ((model(torch.ones(2, 4))) ** 2).mean().backward()
        with pytest.raises(RuntimeError, match="again before step"):
            ((model(torch.ones(2, 4))) ** 2).mean().backward()
        opt.remove_hooks()
    finally:
        hvd.shutdown()
