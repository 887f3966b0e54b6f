"""The port's autotune (``horovod_tpu_torch/common/autotune.py``) against
the JAX package's module, and the tuners' agreement across ranks.

The GP, expected improvement, the Bayesian optimizer, the parameter
manager and the goodput bandits are numpy in both packages: on the same
samples (made from a numpy seed) they must give the same numbers and the
same choices, and the bandits' state must survive a ``state_dict`` round
trip and the ``HOROVOD_TUNER_CACHE`` files. A gloo world of 4 then runs
``HOROVOD_FUSION_WIRE=auto``, ``HOROVOD_AUTOTUNE=1`` and
``overlap_buckets="auto"`` with each rank's clock jittered by its own
seed, while a process set of two ranks runs allreduces of the same
bucket tier, and adds fusion cycles, on its members only: every rank
must make the same choices (the readings are agreed, a set's keys name
its ranks, and the threshold's samples close at the world optimizer's
steps), and on integer-valued fp32 the results must equal a fixed-wire
run's bit for bit. The JAX modules are imported inside the tests, so
the world's ranks import no JAX."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from horovod_tpu_torch.common import autotune as pat
from test_torch_collectives import _run, file_store

N = 4


def _jax_autotune():
    from horovod_tpu.common import autotune as jat

    return jat


def test_gp_and_ei_equal_the_jax_module():
    jat = _jax_autotune()
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(12, 2))
    y = rng.normal(size=12)
    q = rng.uniform(size=(64, 2))
    gj, gp = jat.GaussianProcess(), pat.GaussianProcess()
    gj.fit(x, y)
    gp.fit(x, y)
    (mj, sj), (mp, sp) = gj.predict(q), gp.predict(q)
    np.testing.assert_array_equal(mp, mj)
    np.testing.assert_array_equal(sp, sj)
    np.testing.assert_array_equal(
        pat.expected_improvement(mp, sp, best=float(y.max())),
        jat.expected_improvement(mj, sj, best=float(y.max())))


def test_bayesian_optimizer_proposes_the_same_points():
    jat = _jax_autotune()
    rng = np.random.default_rng(1)
    jbo, pbo = jat.BayesianOptimizer(), pat.BayesianOptimizer()
    jbo._gp = jat.GaussianProcess()  # the numpy GP on both sides
    for _ in range(8):
        pj, pp = jbo.suggest(), pbo.suggest()
        assert pp == pj
        score = float(rng.normal())
        jbo.observe(pj[0], pj[1], score)
        pbo.observe(pp[0], pp[1], score)
    assert pbo.best() == jbo.best()


def test_parameter_manager_same_feed_same_thresholds(tmp_path):
    jat = _jax_autotune()
    kw = dict(initial_threshold=1 << 26, initial_cycle_ms=1.0,
              warmup_samples=1, steps_per_sample=2, max_samples=4)
    jpm = jat.ParameterManager(log_path=str(tmp_path / "j.log"), **kw)
    jpm._optimizer._gp = jat.GaussianProcess()
    ppm = pat.ParameterManager(log_path=str(tmp_path / "p.log"), **kw)
    rng = np.random.default_rng(2)
    seen = []
    for _ in range(12):
        b, s = int(rng.integers(1, 1 << 24)), float(rng.uniform(0.01, 1))
        jpm.record(bytes_=b, seconds=s, wire_bytes=b + 64)
        ppm.record(bytes_=b, seconds=s, wire_bytes=b + 64)
        assert ppm.current() == jpm.current()
        seen.append(ppm.current()[0])
    assert ppm.frozen and jpm.frozen and len(set(seen)) > 1
    assert (tmp_path / "p.log").read_text() == \
        (tmp_path / "j.log").read_text()
    # agree: the sample's bytes and seconds pass through it at each
    # boundary, and its answer is what the manager scores
    calls = []
    apm = pat.ParameterManager(
        agree=lambda b, s: calls.append((b, s)) or (b, 2 * s), **kw)
    for _ in range(4):
        apm.record(bytes_=8, seconds=0.5)
    assert calls == [(16, 1.0), (16, 1.0)]


def _counting_clock(step=0.01):
    t = [0.0]

    def clock():
        t[0] += step
        return t[0]
    return clock


def test_eager_loop_thresholds_equal_the_jax_manager(monkeypatch, tmp_path):
    """``HOROVOD_AUTOTUNE=1`` in a loop of bare ``hvd.allreduce`` calls
    closed by ``hvd.step_end()``, under an injected clock: each step is
    one record, and the thresholds the port applies equal the JAX
    manager's for the same records."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics

    jat = _jax_autotune()
    for name in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_FUSION_WIRE"):
        monkeypatch.delenv(name, raising=False)
    env = {"HOROVOD_AUTOTUNE": "1", "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
           "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "2",
           "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "4"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    hvd.init(device="cpu")
    try:
        fusion = basics.state().fusion
        pm = basics.state().parameter_manager
        pm._agree = None  # a world of one: nothing to agree
        fusion._clock = _counting_clock()
        feed, applied = [], []
        inner = pm.record
        pm.record = lambda **kw: feed.append(kw) or inner(**kw)
        rng = np.random.default_rng(3)
        for step in range(12):
            for _ in range(int(rng.integers(1, 4))):
                hvd.allreduce(torch.ones(int(rng.integers(1, 5000))))
            hvd.step_end()
            applied.append(fusion.threshold_bytes)
        assert len(feed) == 12 and pm.frozen
    finally:
        hvd.shutdown()
    jpm = jat.ParameterManager(initial_threshold=1 << 26,
                               initial_cycle_ms=1.0,
                               warmup_samples=1, steps_per_sample=2,
                               max_samples=4)
    jpm._optimizer._gp = jat.GaussianProcess()
    want = []
    for kw in feed:
        jpm.record(**kw)
        want.append(jpm.current()[0])
    assert applied == want and len(set(applied)) > 1


def test_a_step_end_after_an_optimizer_step_records_once(monkeypatch):
    """One record a step whether the step is closed by the optimizer, by
    ``hvd.step_end()``, or by both."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics

    for name in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_FUSION_WIRE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    hvd.init(device="cpu")
    try:
        pm = basics.state().parameter_manager
        records = []
        pm.record = lambda **kw: records.append(kw)
        w = torch.nn.Parameter(torch.ones(16))
        opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1))
        for step in range(3):  # the optimizer, then step_end
            opt.zero_grad()
            (w * w).sum().backward()
            opt.step()
            hvd.step_end()
        assert len(records) == 3
        for step in range(2):  # step_end alone
            hvd.allreduce(torch.ones(4))
            hvd.step_end()
        assert len(records) == 5
        for step in range(2):  # the optimizer alone
            opt.zero_grad()
            (w * w).sum().backward()
            opt.step()
        assert len(records) == 7
        opt.remove_hooks()
    finally:
        hvd.shutdown()


def _feed(tuner, rng, keys):
    for _ in range(20):
        key = keys[int(rng.integers(len(keys)))]
        c = tuner.choose(*key) if type(tuner).__name__ == "OverlapTuner" \
            else tuner.choose(key[0], key[1], itemsize=4)
        yield key, c
        tuner.record(key[0], c, key[1], float(rng.uniform(0.1, 2.0)))


@pytest.mark.parametrize("kind", ["wire", "overlap"])
def test_bandits_choose_alike_and_round_trip(kind, tmp_path):
    jat = _jax_autotune()
    if kind == "wire":
        tj, tp = jat.WireTuner(trials=2), pat.WireTuner(trials=2)
        keys = [(("allreduce", 1 << 20, "float32"), 4 << 20),
                (("allreduce", 1 << 10, "float32"), 4 << 10)]
    else:
        tj = jat.OverlapTuner(min_bucket_bytes=1 << 16, trials=2)
        tp = pat.OverlapTuner(min_bucket_bytes=1 << 16, trials=2)
        keys = [(("step", 1), 1 << 20), (("step", 2), 1 << 17)]
    got_j = list(_feed(tj, np.random.default_rng(3), keys))
    got_p = list(_feed(tp, np.random.default_rng(3), keys))
    assert got_p == got_j
    assert json.dumps(tp.state_dict()) == json.dumps(tj.state_dict())
    # a state_dict round trip, and the cache files: a fresh tuner
    # warm-started from the persisted file chooses as the live one
    fresh = type(tp)(**({"trials": 2} if kind == "wire" else
                        {"min_bucket_bytes": 1 << 16, "trials": 2}))
    assert fresh.load_state_dict(tp.state_dict()) == len(tp._obs)
    assert fresh.state_dict() == tp.state_dict()
    path = pat.persist(tp, kind, fingerprint="w1-l1-cpu",
                       base=str(tmp_path))
    assert path == str(tmp_path / f"{kind}-w1-l1-cpu.json")
    warm = type(tp)(**({"trials": 2} if kind == "wire" else
                       {"min_bucket_bytes": 1 << 16, "trials": 2}))
    assert pat.warm_start(warm, kind, "w1-l1-cpu", str(tmp_path)) > 0
    for key, nbytes in keys:
        assert warm.choose(key, nbytes) == tp.choose(key, nbytes)
    # the JAX module reads the port's file the same way
    jwarm = jat.WireTuner(trials=2) if kind == "wire" else \
        jat.OverlapTuner(min_bucket_bytes=1 << 16, trials=2)
    assert jat.warm_start(jwarm, kind, "w1-l1-cpu", str(tmp_path)) == \
        len(tp._obs)


def test_shared_capacity_tuner_warm_starts_and_persists(monkeypatch,
                                                       tmp_path):
    """``shared_capacity_tuner`` starts from the ``capacity`` cache file
    (goodput and the load ledger) and persists back to it, as the JAX
    module's does (``tests/test_moe_wire.py``'s shared accessors)."""
    monkeypatch.setenv("HOROVOD_TUNER_CACHE", str(tmp_path))
    for name in ("HOROVOD_SIZE", "HOROVOD_RANK", "HOROVOD_INTRA_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert pat.tuner_cache_path("wire").startswith(str(tmp_path))
    assert pat.topology_fingerprint().startswith("w1-l1-")
    seed = pat.CapacityTuner(trials=1)
    seed.observe_load(("k",), 1.25, [3.0, 5.0], dropped=2.0, total=10.0,
                      seconds=0.5)
    path = pat.persist(seed, "capacity")
    assert path == pat.tuner_cache_path("capacity")
    pat.reset_shared_tuners()
    try:
        tuner = pat.shared_capacity_tuner(trials=1)
        assert pat.shared_capacity_tuner() is tuner
        assert not tuner.needs_trial(("k",), 1.25)
        assert tuner.drop_rate(("k",), 1.25) == 0.2
        assert any(name == "capacity"
                   for _, (_, name, _) in pat._persist_registry)
        tuner.observe_load(("k",), 2.0, [4.0, 4.0], dropped=0.0,
                           total=8.0, seconds=0.25)
        assert pat.persist(tuner, "capacity") == path
        again = pat.CapacityTuner(trials=1)
        assert pat.warm_start(again, "capacity") == 2
        assert again.state_dict() == tuner.state_dict()
    finally:
        pat.reset_shared_tuners()


# ------------------------------------------------- agreement across ranks


def _jittered(seed: int):
    """A clock whose every reading adds up to 50 ms of this rank's own
    noise: each rank's local timings rank the candidates differently."""
    import random
    import time

    rnd = random.Random(seed)
    return lambda: time.monotonic() + rnd.random() * 0.05


def _agreement_worker(rank, n, outdir):
    import os

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import autotune, basics

    out = {}

    def run(tag, jitter):
        hvd.init(device="cpu", store=file_store(outdir + f"/{tag}", n))
        # what rank 0 read from the cache and broadcast at init
        states = json.dumps(autotune._world["states"], sort_keys=True)
        fusion = basics.state().fusion
        pair = hvd.add_process_set([0, 1])
        member = pair.included(rank)
        if jitter:
            fusion._clock = _jittered(100 + rank)
        g = torch.Generator().manual_seed(rank)
        # batches of 24 KiB (a 32 KiB tier), under the int8 floor: the
        # menu is fp32 and bf16, exact on these small integers
        xs = [torch.randint(-8, 9, (2048,), generator=g).float()
              for _ in range(3)]
        res, pair_res, wires = [], [], []
        for i in range(9):
            if member:  # the same tier, on ranks 0 and 1 only
                pair_res.append(hvd.grouped_allreduce(
                    [x * (i % 2 + 2) for x in xs], op=hvd.Sum,
                    process_set=pair))
            res.append(hvd.grouped_allreduce([x * (i % 3 + 1) for x in xs],
                                             op=hvd.Sum))
            wires.append(fusion.last_wire_format)
        choices = dict(fusion.wire_choices)
        out[tag] = dict(res=res, pair_res=pair_res, wires=wires,
                        states=states,
                        choices={k: c for k, c in choices.items()
                                 if "ranks" not in k},
                        pair_choices={k: c for k, c in choices.items()
                                      if "ranks" in k},
                        pair_trials=fusion.wire_trials)
        # the bucket count: integer gradients, Sum, plain SGD
        autotune.reset_shared_tuners()
        params = [torch.nn.Parameter(torch.zeros(256 * (j + 1)))
                  for j in range(6)]
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(params, lr=0.5), op=hvd.Sum,
            overlap_buckets="auto" if jitter else 1, overlap_min_bytes=0)
        if jitter:
            opt._tuning.tuner.trials = 1
            opt._tuning.clock = _jittered(200 + rank)
        counts, thresholds = [], []
        for step in range(7):
            if member:  # cycles the other ranks do not run
                pair_res.append(hvd.allreduce(xs[0], op=hvd.Sum,
                                              process_set=pair))
            opt.zero_grad()
            loss = sum((p * torch.randint(-4, 5, p.shape, generator=g)
                        .float()).sum() for p in params)
            loss.backward()
            opt.step()
            counts.append(opt._overlap.schedule.n_buckets)
            thresholds.append(fusion.threshold_bytes)
        out[tag]["params"] = [p.detach().clone() for p in params]
        out[tag]["counts"] = counts
        out[tag]["thresholds"] = thresholds
        opt.remove_hooks()
        hvd.shutdown()

    def eager(tag):
        """A loop of bare allreduces closed by ``hvd.step_end()``, the
        pair's members running extra cycles: the threshold's samples
        close at the steps, so every rank applies the same thresholds."""
        hvd.init(device="cpu", store=file_store(outdir + f"/{tag}", n))
        fusion = basics.state().fusion
        fusion._clock = _jittered(300 + rank)
        pair = hvd.add_process_set([0, 1])
        g = torch.Generator().manual_seed(rank)
        thresholds = []
        for step in range(8):
            if pair.included(rank):  # cycles the other ranks do not run
                for _ in range(2):
                    hvd.allreduce(torch.ones(512), op=hvd.Sum,
                                  process_set=pair)
            hvd.allreduce(torch.randint(-8, 9, (4096,), generator=g)
                          .float(), op=hvd.Sum)
            hvd.step_end()
            thresholds.append(fusion.threshold_bytes)
        out[tag] = dict(thresholds=thresholds,
                        frozen=basics.state().parameter_manager.frozen)
        hvd.shutdown()

    run("tuned", True)
    eager("eager")
    os.environ["HOROVOD_FUSION_WIRE"] = "fp32"
    os.environ["HOROVOD_AUTOTUNE"] = "0"
    run("fixed", False)
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def agreement(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("agree")
    for tag in ("tuned", "eager", "fixed"):
        (tmp / tag).mkdir()
    env = {"HOROVOD_FUSION_WIRE": "auto", "HOROVOD_AUTOTUNE": "1",
           "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
           "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "1",
           "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "4",
           "HOROVOD_TUNER_CACHE": str(tmp / "cache")}
    return _run(tmp, N, Path(__file__), "_agreement_worker", 240, env)


def test_skewed_clocks_make_the_same_choices(agreement):
    tuned = [o["tuned"] for o in agreement]
    for key in ("wires", "thresholds", "choices", "counts"):
        assert all(t[key] == tuned[0][key] for t in tuned), key
    # the pair's members agree with each other, under keys of their own
    pair = tuned[:2]
    assert pair[0]["pair_choices"] == pair[1]["pair_choices"] != {}
    assert pair[0]["pair_trials"] == pair[1]["pair_trials"]
    assert all(t["pair_choices"] == {} for t in tuned[2:])
    assert all(k[-3:] == ("ranks", 0, 1) for k in pair[0]["pair_choices"])
    # the wire tuner tried both candidates of the menu, and the
    # parameter manager moved the threshold
    assert set(tuned[0]["wires"]) == {"fp32", "bf16"}
    assert len(set(tuned[0]["thresholds"])) > 1
    # the bucket count was explored (1 first, then the others)
    assert tuned[0]["counts"][0] == 1 and len(set(tuned[0]["counts"])) > 1
    # the tuned world persisted its tuners at shutdown; the next world's
    # rank 0 read them at init and every rank holds the same states
    fixed = [o["fixed"] for o in agreement]
    assert all(t["states"] == "{}" for t in tuned)
    assert all(f["states"] == fixed[0]["states"] for f in fixed)
    assert set(json.loads(fixed[0]["states"])) == {"wire", "overlap"}


def test_eager_loop_makes_the_same_choices(agreement):
    """The eager loop of the gloo world of 4: the same thresholds on
    every rank, moved from the initial 64 MiB, and frozen."""
    eager = [o["eager"] for o in agreement]
    assert all(e["thresholds"] == eager[0]["thresholds"] for e in eager)
    assert len(set(eager[0]["thresholds"])) > 1
    assert all(e["frozen"] for e in eager)


def test_tuned_results_equal_a_fixed_wire_run(agreement):
    for o in agreement:
        for part in ("res", "pair_res"):
            assert len(o["tuned"][part]) == len(o["fixed"][part])
            for got, want in zip(o["tuned"][part], o["fixed"][part]):
                for a, b in zip(got, want) if isinstance(got, list) \
                        else [(got, want)]:
                    assert torch.equal(a, b)
        for a, b in zip(o["tuned"]["params"], o["fixed"]["params"]):
            assert torch.equal(a, b)
