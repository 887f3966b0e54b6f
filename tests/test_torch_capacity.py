"""The MoE capacity tuner and its step harness against the JAX package.

``CapacityTuner`` is numpy in both packages: on the same feed of load
counters and seconds (made from a numpy seed) the port's choices, drop
rates, imbalances and ``state_dict`` must equal the JAX tuner's exactly,
and each module must read the other's ``capacity`` cache file.
``tune_capacity``, the harness that runs a whole step a trial, must make
the same choice on every rank of a gloo world of 4 (dp 2 × ep 2, each
rank's step slowed by its own seeded jitter, the two ep instances
routing different tokens) through ``moe_ffn``; and the composed model's
step hands its ``MoEStats`` to the harness."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from horovod_tpu_torch.common import autotune as pat
from test_torch_collectives import _run, file_store

N = 4


def _jat():
    from horovod_tpu.common import autotune as jat

    return jat


def _feed_both(jt, pt, seed):
    """The same 30 observations into both tuners: each asks its tuner
    for the key's factor, and the two must agree at every step."""
    rng = np.random.default_rng(seed)
    keys = [("moe", 4, 8192, 1024), ("moe", 2, 4096, 64)]
    for _ in range(30):
        key = keys[int(rng.integers(len(keys)))]
        cj, cp = jt.choose(key), pt.choose(key)
        assert cp == cj
        hist = rng.integers(0, 400, size=4).astype(float).tolist()
        total = float(sum(hist)) + float(rng.integers(0, 300))
        dropped = float(rng.integers(0, int(total * 0.4) + 1))
        secs = float(rng.uniform(0.01, 0.2))
        jt.observe_load(key, cj, hist, dropped=dropped, total=total,
                        seconds=secs)
        pt.observe_load(key, cp, hist, dropped=dropped, total=total,
                        seconds=secs)
    return keys


@pytest.mark.parametrize("trials,max_drop", [(1, 0.2), (2, 0.05)])
def test_same_feed_same_choices_and_state(trials, max_drop, tmp_path):
    jat = _jat()
    jt = jat.CapacityTuner(trials=trials, max_drop_rate=max_drop)
    pt = pat.CapacityTuner(trials=trials, max_drop_rate=max_drop)
    assert pt.CANDIDATES == jt.CANDIDATES == (1.0, 1.25, 1.5, 2.0)
    keys = _feed_both(jt, pt, seed=trials)
    for key in keys:
        assert pt.choose(key) == jt.choose(key)
        for c in pt.candidates:
            assert pt.drop_rate(key, c) == jt.drop_rate(key, c)
            assert pt.imbalance(key, c) == jt.imbalance(key, c)
            assert pt.goodput(key, c) == jt.goodput(key, c)
            assert pt.needs_trial(key, c) == jt.needs_trial(key, c)
    assert json.dumps(pt.state_dict()) == json.dumps(jt.state_dict())
    # each module reads the other's cache file
    fp = "w1-l1-cpu"
    assert pat.persist(pt, "capacity", fp, str(tmp_path / "p"))
    assert jat.persist(jt, "capacity", fp, str(tmp_path / "j"))
    pj = pat.CapacityTuner(trials=trials, max_drop_rate=max_drop)
    jp = jat.CapacityTuner(trials=trials, max_drop_rate=max_drop)
    assert pat.warm_start(pj, "capacity", fp, str(tmp_path / "j")) == \
        len(jt._obs)
    assert jat.warm_start(jp, "capacity", fp, str(tmp_path / "p")) == \
        len(pt._obs)
    assert json.dumps(pj.state_dict()) == json.dumps(jt.state_dict())
    assert json.dumps(jp.state_dict()) == json.dumps(pt.state_dict())
    for key in keys:
        assert pj.choose(key) == jp.choose(key) == jt.choose(key)


def test_drop_rate_prior_and_the_overflow_fallback():
    """A candidate over ``max_drop_rate`` after its trials is never
    exploited, and when every candidate overflows the largest buffer
    wins, in both packages."""
    jat = _jat()
    for mod in (pat, _jat()):
        t = mod.CapacityTuner(trials=1, candidates=(1.0, 2.0),
                              max_drop_rate=0.1)
        key = ("m",)
        # 1.0 is fastest but drops 30 %; 2.0 is slower and drops none
        t.observe_load(key, 1.0, [50.0, 20.0], dropped=30.0, total=100.0,
                       seconds=0.01)
        t.observe_load(key, 2.0, [50.0, 50.0], dropped=0.0, total=100.0,
                       seconds=1.0)
        assert t.choose(key) == 2.0
        assert t.imbalance(key, 1.0) == pytest.approx(50.0 / 35.0)
        t2 = mod.CapacityTuner(trials=1, candidates=(1.0, 2.0),
                               max_drop_rate=0.1)
        for c in (1.0, 2.0):
            t2.observe_load(key, c, [1.0], dropped=5.0, total=10.0,
                            seconds=0.1)
        assert t2.choose(key) == 2.0
    assert jat.CapacityTuner().max_drop_rate == \
        pat.CapacityTuner().max_drop_rate == 0.2


def test_capacity_trial_feeds_agreed_counters_in_a_world_of_one(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.metrics import registry
    from horovod_tpu_torch.parallel.moe import (MoEStats, capacity_trial,
                                                tune_capacity)

    for name in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    try:
        seen = []

        def run(cf):
            seen.append(cf)
            kept = 100.0 if cf >= 1.5 else 80.0
            return MoEStats(expert_tokens=torch.tensor([kept - 30.0, 30.0]),
                            dropped=torch.tensor(100.0 - kept),
                            total=torch.tensor(100.0))

        tuner = pat.CapacityTuner(trials=1)
        cf, (hist, dropped, total), s = capacity_trial(run, ("k",), tuner)
        assert cf == 1.0 and hist == [50.0, 30.0] and (dropped, total) == (
            20.0, 100.0) and s > 0
        assert registry.snapshot()["moe.capacity_factor"] == 1.0
        choice, curve = tune_capacity(run, ("k",), tuner)
        assert seen == [1.0, 1.25, 1.5, 2.0]
        assert sorted(curve) == [1.25, 1.5, 2.0]
        # 1.0 and 1.25 drop 20 % (= max_drop_rate: still allowed)
        assert curve[1.25]["drop_rate"] == 0.2 and choice in tuner.candidates
        assert choice == tuner.choose(("k",))
    finally:
        hvd.shutdown()


# ------------------------------------------------- agreement across ranks


def _capacity_worker(rank, n, outdir):
    import random
    import time

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.mesh import Mesh, MeshSpec
    from horovod_tpu_torch.parallel.moe import init_moe_params, moe_ffn, \
        tune_capacity

    hvd.init(device="cpu", store=file_store(outdir, n))
    mesh = Mesh(MeshSpec(dp=2, ep=2), range(n))
    ep = mesh.axis("ep")
    g = torch.Generator().manual_seed(7)  # the same experts on every rank
    params = init_moe_params(g, 16, 32, 2, 4)
    params = type(params)(*(p.requires_grad_() for p in params))
    # each ep instance routes its own tokens (dp coordinate), with a skew
    # toward expert 0 so that small factors drop tokens
    tg = torch.Generator().manual_seed(100 + 10 * mesh.coords["dp"]
                                       + mesh.coords["ep"])
    x = torch.randn(64, 16, generator=tg)
    x[:, :4] += 2.0
    jitter = random.Random(rank)

    def run(cf):
        time.sleep(jitter.random() * 0.02)  # this rank's own clock skew
        y, st = moe_ffn(params, x, axis=ep, capacity_factor=cf,
                        return_stats=True)
        y.sum().backward()
        return st

    tuner = pat.CapacityTuner(trials=1)
    choice, curve = tune_capacity(run, ("moe", n, 64, 16), tuner)
    out = {"choice": choice, "curve": {str(k): v for k, v in curve.items()},
           "state": json.dumps(tuner.state_dict()),
           "drop_rates": [tuner.drop_rate(("moe", n, 64, 16), c)
                          for c in tuner.candidates]}
    hvd.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def capacity_world(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("capacity"), N, Path(__file__),
                "_capacity_worker", 180, None)


def test_harness_choice_agrees_across_the_world(capacity_world):
    first = capacity_world[0]
    for out in capacity_world:
        assert out["choice"] == first["choice"]
        assert out["state"] == first["state"]  # the same readings
        assert out["curve"].keys() == first["curve"].keys()
    # the skewed tokens overflow the smallest buffer, not the largest
    rates = first["drop_rates"]
    assert rates[0] > 0 and rates[-1] <= rates[0]
    assert first["choice"] in (1.0, 1.25, 1.5, 2.0)


def test_composed_step_hands_its_moe_stats_to_the_harness(monkeypatch):
    """``make_train_step(moe_stats=True)``: the step's MoEStats at the
    factor the harness passes, and a choice from ``tune_capacity``."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.mesh import Mesh, MeshSpec
    from horovod_tpu_torch.parallel.moe import tune_capacity
    from horovod_tpu_torch.parallel.transformer import (
        ParallelTransformerConfig, make_sharded_params, make_train_step)

    for name in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    try:
        cfg = ParallelTransformerConfig(num_layers=2, n_experts=4)
        mesh = Mesh(MeshSpec(), [0])
        params = make_sharded_params(cfg, mesh,
                                     torch.Generator().manual_seed(0),
                                     device="cpu")
        step = make_train_step(cfg, mesh, device="cpu", moe_stats=True)
        rng = np.random.default_rng(0)
        tokens = torch.from_numpy(rng.integers(0, 256, (4, 16)))
        labels = torch.from_numpy(rng.integers(0, 256, (4, 16)))
        box = {"p": params}

        def run(cf):
            box["p"], _ = step(box["p"], tokens, labels, capacity_factor=cf)
            return step.moe_stats

        tuner = pat.CapacityTuner(trials=1)
        choice, curve = tune_capacity(run, ("composed",), tuner)
        assert sorted(curve) == [1.0, 1.25, 1.5, 2.0]
        st = step.moe_stats
        assert float(st.total) == 4 * 16
        assert float(st.expert_tokens.sum() + st.dropped) == 4 * 16
        assert curve[2.0]["drop_rate"] <= curve[1.0]["drop_rate"]
        assert choice in tuner.candidates
    finally:
        hvd.shutdown()
