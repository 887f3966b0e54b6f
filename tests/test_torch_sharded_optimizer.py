"""``ShardedDistributedOptimizer``'s construction, in a world of one on the
CPU: the differential probe (the JAX package's ``_probe_nonelementwise``,
``horovod_tpu/sharded_optimizer.py:110-208``, on a ``torch.optim``
class and its defaults) lets the elementwise optimizers through and
refuses those whose step changes when the parameters are sharded, as
``tests/test_sharded_optimizer.py``'s ``TestNonElementwiseGuard`` does
for optax; ``HOROVOD_SHARDED_OPT_PROBE=0`` skips it. Then the
constructor's refusals, which carry the JAX package's messages, and the
environment's defaults (``HOROVOD_ZERO_STAGE``, ``HOROVOD_ZERO_WIRE``,
never ``HOROVOD_FUSION_WIRE``)."""

import pytest
import torch


@pytest.fixture
def hvd(monkeypatch):
    import horovod_tpu_torch as hvd

    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_ZERO_STAGE",
                "HOROVOD_ZERO_WIRE", "HOROVOD_FUSION_WIRE",
                "HOROVOD_SHARDED_OPT_PROBE", "HOROVOD_OVERLAP"):
        monkeypatch.delenv(var, raising=False)
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _params():
    g = torch.Generator().manual_seed(0)
    return [torch.nn.Parameter(torch.randn(12, 7, generator=g)),
            torch.nn.Parameter(torch.randn(7, generator=g))]


class _ClipSGD(torch.optim.SGD):
    """SGD that clips the global gradient norm inside ``step()``: the
    optax chain ``clip_by_global_norm(1.0), sgd`` as a torch optimizer."""

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]
                  if p.grad is not None]
        torch.nn.utils.clip_grad_norm_(params, 1.0)
        return super().step(closure)


class _ClipAdam(torch.optim.Adam):
    """Adam after a global-norm clip: its first update is
    scale-invariant, so only a multi-step probe sees the clip."""

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]
                  if p.grad is not None]
        torch.nn.utils.clip_grad_norm_(params, 1.0)
        return super().step(closure)


ELEMENTWISE = {
    "sgd_momentum": lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
    "sgd_nesterov_wd": lambda ps: torch.optim.SGD(
        ps, lr=0.1, momentum=0.9, nesterov=True, weight_decay=1e-2),
    "adam": lambda ps: torch.optim.Adam(ps, lr=1e-3),
    "adamw": lambda ps: torch.optim.AdamW(ps, lr=1e-3, weight_decay=1e-2),
    "rmsprop": lambda ps: torch.optim.RMSprop(ps, lr=1e-3, momentum=0.5),
    "adagrad": lambda ps: torch.optim.Adagrad(ps, lr=0.1),
}

NOT_ELEMENTWISE = {
    # shape-gated coupling: the second moment of a 2-D tensor is factored
    # into row and column statistics, a flat shard's is not
    "adafactor": lambda ps: torch.optim.Adafactor(ps, lr=1e-2),
    "clip_then_sgd": lambda ps: _ClipSGD(ps, lr=0.1),
    "clip_then_adam": lambda ps: _ClipAdam(ps, lr=1e-3),
}


@pytest.mark.parametrize("name", sorted(ELEMENTWISE))
def test_probe_accepts_elementwise(hvd, name):
    from horovod_tpu_torch.sharded_optimizer import _probe_nonelementwise

    inner = ELEMENTWISE[name](_params())
    assert not _probe_nonelementwise(type(inner), inner.defaults)
    opt = hvd.ShardedDistributedOptimizer(inner)
    # the inner optimizer is rebuilt over the shards with the group's
    # options
    group = opt._inner.param_groups[0]
    for k, v in inner.param_groups[0].items():
        if k != "params":
            assert group[k] == v, k
    assert group["params"] == opt._shards


@pytest.mark.parametrize("name", sorted(NOT_ELEMENTWISE))
def test_probe_refuses_not_elementwise(hvd, name):
    with pytest.raises(ValueError, match="not elementwise") as e:
        hvd.ShardedDistributedOptimizer(NOT_ELEMENTWISE[name](_params()))
    assert "clip_grad_norm_" in str(e.value)
    assert "HOROVOD_SHARDED_OPT_PROBE=0" in str(e.value)


def test_probe_opt_out(hvd, monkeypatch):
    monkeypatch.setenv("HOROVOD_SHARDED_OPT_PROBE", "0")
    hvd.ShardedDistributedOptimizer(torch.optim.Adafactor(_params(), lr=1e-2))


def _make(hvd, **kw):
    return hvd.ShardedDistributedOptimizer(
        torch.optim.SGD(_params(), lr=0.1), **kw)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(op="adasum"), NotImplementedError, "Sum/Average"),
    (dict(zero_stage=4), ValueError, "zero_stage"),
    (dict(wire="fp8"), ValueError, "wire"),
    (dict(wire="auto"), NotImplementedError, "A12"),
    (dict(wire="bf16", error_feedback=True), ValueError, "error_feedback"),
    (dict(zero_stage=3, wire="int8", error_feedback=True), ValueError,
     "stage"),
    (dict(local_sgd_steps=4), ValueError, "two-level topology"),
    (dict(local_sgd_steps=4, local_sgd_intra=2), ValueError,
     "two-level topology"),
    (dict(local_sgd_steps=4, zero_stage=3), NotImplementedError,
     "zero_stage<=2"),
    (dict(overlap_buckets=-1), ValueError, "overlap_buckets"),
], ids=["adasum", "stage4", "fp8", "auto", "ef_bf16", "ef_stage3",
        "local_sgd", "local_sgd_intra", "local_sgd_stage3",
        "negative_buckets"])
def test_constructor_refusals(hvd, kw, exc, match):
    if kw.get("op") == "adasum":
        kw["op"] = hvd.Adasum
    with pytest.raises(exc, match=match):
        _make(hvd, **kw)


def test_refuses_two_param_groups(hvd):
    a, b = _params()
    with pytest.raises(ValueError, match="one param group"):
        hvd.ShardedDistributedOptimizer(torch.optim.SGD(
            [{"params": [a]}, {"params": [b], "lr": 0.5}], lr=0.1))


def test_ops_and_average(hvd):
    assert _make(hvd)._op == hvd.Average
    assert _make(hvd, average=False)._op == hvd.Sum
    assert _make(hvd, op=hvd.Sum)._op == hvd.Sum
    for op in (hvd.Min, hvd.Max, hvd.Product):
        with pytest.raises(NotImplementedError):
            _make(hvd, op=op)


def test_environment_defaults(monkeypatch):
    import horovod_tpu_torch as hvd

    for var in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOROVOD_ZERO_STAGE", "2")
    monkeypatch.setenv("HOROVOD_ZERO_WIRE", "bf16")
    monkeypatch.setenv("HOROVOD_FUSION_WIRE", "int8")
    monkeypatch.setenv("HOROVOD_FUSION_WIRE_BLOCK", "256")
    hvd.init(device="cpu")
    try:
        cfg = hvd.get_config()
        assert (cfg.zero_stage, cfg.zero_wire) == (2, "bf16")
        opt = _make(hvd)
        # the fused wire's knob does not reach the sharded legs
        assert (opt._stage, opt._wire, opt._block) == (2, "bf16", 256)
        opt.remove_hooks()
        assert _make(hvd, zero_stage=1, wire="fp32")._wire == "fp32"
    finally:
        hvd.shutdown()
    monkeypatch.setenv("HOROVOD_ZERO_STAGE", "5")
    with pytest.raises(ValueError, match="HOROVOD_ZERO_STAGE"):
        hvd.init(device="cpu")
    monkeypatch.delenv("HOROVOD_ZERO_STAGE")
    monkeypatch.delenv("HOROVOD_ZERO_WIRE")
    monkeypatch.delenv("HOROVOD_FUSION_WIRE")
    hvd.init(device="cpu")
    try:
        opt = _make(hvd)
        assert (opt._stage, opt._wire) == (1, "fp32")
    finally:
        hvd.shutdown()


def test_stage3_frees_parameters_and_unshards(hvd):
    """Stage 3 keeps the parameters' shapes without storage; in a world
    of one ``unshard_params`` writes them back bit for bit, and
    ``value_and_grad`` frees them again."""
    model = torch.nn.Linear(5, 3)
    want = [p.detach().clone() for p in model.parameters()]
    opt = hvd.ShardedDistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), zero_stage=3,
        named_parameters=model.named_parameters())
    assert all(p.untyped_storage().nbytes() == 0
               for p in model.parameters())
    assert [tuple(p.shape) for p in model.parameters()] == [(3, 5), (3,)]
    full = opt.gather_params(model)
    assert set(full) == {"weight", "bias"}
    assert torch.equal(full["weight"], want[0])
    opt.unshard_params()
    assert all(torch.equal(p, w) for p, w in zip(model.parameters(), want))
    x = torch.randn(4, 5)
    loss, grads = opt.value_and_grad(lambda: model(x).pow(2).sum(),
                                     model)()
    assert all(p.untyped_storage().nbytes() == 0
               for p in model.parameters())
    assert set(grads) == {"weight", "bias"}
    assert grads["weight"].shape == (15,)
    with pytest.raises(ValueError, match="zero_stage 1-2"):
        _make(hvd).load_param_shards([])
