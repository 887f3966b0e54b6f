"""The port's copies of the retry ladder (``horovod_tpu_torch/common/
retry.py``) and of the fault injection (``horovod_tpu_torch/testing/
chaos.py``) against the JAX package's modules, on the same inputs: the
plan syntax and its errors, ``site@N`` firing once, probabilistic fires
under a seed (one ``random.Random`` stream a site, so both draw the same
sequence), data kinds, the counters, the environment's plan; the
ladder's delays, attempts and deadline under an injected sleep and
seeded jitter, the exception classes, ``from_env``, and the circuit
breaker. Both sides must give the same results exactly."""

import random
import urllib.error

import pytest

from horovod_tpu_torch.common import metrics as port_metrics
from horovod_tpu_torch.common import retry as port_retry
from horovod_tpu_torch.testing import chaos as port_chaos


def _jax():
    from horovod_tpu.common import metrics, retry
    from horovod_tpu.testing import chaos

    return retry, chaos, metrics


PLANS = [
    "seed=42;kv.request@2:reset;heartbeat:p=0.1:delay:ms=200;train.step@5:kill",
    "local_sgd.sync@1:reset;local_sgd.sync@2:reset",
    "seed=7;local_sgd.sync@1:timeout",
    "a:p=0.5:5xx:n=3;b@3:nan;c:bitflip",
]


def _rules(plan):
    return [(r.site, r.kind, r.at, r.p, r.ms, r.remaining)
            for r in plan.rules], plan.seed


@pytest.mark.parametrize("spec", PLANS)
def test_plan_parsing_matches(spec):
    _, chaos, _ = _jax()
    assert _rules(port_chaos.FaultPlan.parse(spec)) == _rules(
        chaos.FaultPlan.parse(spec))


@pytest.mark.parametrize("spec,match", [
    ("a:frobnicate", "unknown token"),
    ("a@2:p=0.5", "exclusive"),
])
def test_plan_errors_match(spec, match):
    _, chaos, _ = _jax()
    for mod in (port_chaos, chaos):
        with pytest.raises(ValueError, match=match):
            mod.FaultPlan.parse(spec)


def _drive(chaos, spec, sites, hits):
    """Hit ``sites`` in turn ``hits`` times; the outcome of each hit."""
    plan = chaos.FaultPlan.parse(spec)
    seen = []
    for _ in range(hits):
        for site in sites:
            try:
                seen.append(plan.fire(site))
            except Exception as e:  # noqa: BLE001 — the outcome compared
                seen.append(type(e).__name__)
    return seen, plan.fired(), {s: plan.hits(s) for s in sites}


@pytest.mark.parametrize("spec,sites", [
    ("local_sgd.sync@2:reset", ["local_sgd.sync"]),
    ("seed=3;x:p=0.3:timeout;y:p=0.7:5xx", ["x", "y"]),
    ("seed=11;x:p=0.5:reset:n=2", ["x"]),
    ("a@2:nan;b:bitflip:n=1", ["a", "b"]),
])
def test_fires_match(spec, sites):
    _, chaos, _ = _jax()
    assert _drive(port_chaos, spec, sites, 12) == _drive(
        chaos, spec, sites, 12)


def test_at_n_fires_once_and_counts():
    port_chaos.configure("s@2:reset")
    base = port_metrics.registry.snapshot()
    try:
        assert port_chaos.inject("s") is None
        with pytest.raises(ConnectionResetError):
            port_chaos.inject("s")
        assert port_chaos.inject("s") is None
        assert port_chaos.active().hits("s") == 3
    finally:
        port_chaos.reset()
    snap = port_metrics.registry.snapshot()
    assert snap["faults_injected"] - base.get("faults_injected", 0) == 1
    assert snap["chaos.s.reset"] - base.get("chaos.s.reset", 0) == 1


def test_env_plan_loads_and_reset_rereads(monkeypatch):
    monkeypatch.setenv("HOROVOD_FAULT_PLAN", "seed=5;e@1:timeout")
    port_chaos.reset()
    try:
        with pytest.raises(TimeoutError):
            port_chaos.inject("e")
        assert port_chaos.active().seed == 5
        monkeypatch.delenv("HOROVOD_FAULT_PLAN")
        port_chaos.reset()
        assert port_chaos.active() is None
        assert port_chaos.inject("e") is None
    finally:
        port_chaos.reset()


# ------------------------------------------------------------ the ladder


class _Flaky:
    def __init__(self, fails, exc=ConnectionResetError):
        self.fails, self.calls, self.exc = fails, 0, exc

    def __call__(self):
        self.calls += 1
        if self.calls <= self.fails:
            raise self.exc("flaky")
        return "ok"


def _ladder(retry, fails, exc=ConnectionResetError, **kw):
    slept = []
    pol = retry.RetryPolicy("test.site", rng=random.Random(3),
                            sleep=slept.append, **kw)
    fn = _Flaky(fails, exc)
    try:
        out = pol.call(fn)
    except Exception as e:  # noqa: BLE001 — the outcome compared
        out = (type(e).__name__, getattr(e, "attempts", None))
    return out, fn.calls, slept


@pytest.mark.parametrize("fails,kw", [
    (0, {}),
    (2, {"attempts": 3, "backoff_ms": 10.0}),
    (5, {"attempts": 3, "backoff_ms": 10.0}),
    (5, {"attempts": 6, "backoff_ms": 100.0, "backoff_max_ms": 250.0}),
    (5, {"attempts": 6, "backoff_ms": 1000.0, "deadline_s": 1.5}),
])
def test_ladder_matches(fails, kw):
    retry, _, _ = _jax()
    assert _ladder(port_retry, fails, **kw) == _ladder(retry, fails, **kw)


def test_not_retryable_raises_at_once():
    retry, _, _ = _jax()
    for mod in (port_retry, retry):
        out, calls, slept = _ladder(mod, 3, PermissionError)
        assert out == ("PermissionError", None) and calls == 1 and not slept


def test_classification_matches():
    retry, chaos, _ = _jax()
    cases = [ConnectionResetError(), TimeoutError(), OSError(),
             PermissionError(), ValueError(),
             urllib.error.HTTPError("u", 503, "x", None, None),
             urllib.error.HTTPError("u", 429, "x", None, None),
             urllib.error.HTTPError("u", 404, "x", None, None),
             port_chaos.InjectedServerError("s"),
             chaos.InjectedServerError("s")]
    assert [port_retry.default_retryable(e) for e in cases] == [
        retry.default_retryable(e) for e in cases]


def test_from_env_matches(monkeypatch):
    retry, _, _ = _jax()
    for var, val in (("HOROVOD_RETRY_ATTEMPTS", "7"),
                     ("HOROVOD_RETRY_BACKOFF_MS", "12.5"),
                     ("HOROVOD_RETRY_DEADLINE_S", "9"),
                     ("HOROVOD_RETRY_CIRCUIT_THRESHOLD", "4")):
        monkeypatch.setenv(var, val)
    keys = ("attempts", "backoff_s", "backoff_max_s", "deadline_s",
            "attempt_timeout_s", "circuit_threshold", "circuit_cooldown_s")
    for kw in ({}, {"attempts": 2, "deadline_s": 0}):
        a = port_retry.RetryPolicy.from_env("s", **kw)
        b = retry.RetryPolicy.from_env("s", **kw)
        assert [getattr(a, k) for k in keys] == [getattr(b, k) for k in keys]


def test_backoff_delays_match():
    retry, _, _ = _jax()
    a = port_retry.backoff_delays(0.05, 1.0, rng=random.Random(9))
    b = retry.backoff_delays(0.05, 1.0, rng=random.Random(9))
    assert [next(a) for _ in range(10)] == [next(b) for _ in range(10)]


def _circuit(retry):
    retry._reset_breakers()
    pol = retry.RetryPolicy("circ", attempts=1, circuit_threshold=2,
                            circuit_cooldown_s=0.0, sleep=lambda s: None)
    seen = []
    for fails in (1, 1, 0, 0, 1, 1, 1):
        try:
            pol.call(_Flaky(fails), peer="p")
            seen.append("ok")
        except Exception as e:  # noqa: BLE001 — the outcome compared
            seen.append(type(e).__name__)
        seen.append(pol.circuit_state("p"))
    retry._reset_breakers()
    return seen


def test_circuit_matches():
    retry, _, _ = _jax()
    got = _circuit(port_retry)
    assert got == _circuit(retry)
    assert "RetryError" in got and "open" in got


def test_circuit_opens_and_fails_fast():
    port_retry._reset_breakers()
    pol = port_retry.RetryPolicy("circ2", attempts=1, circuit_threshold=2,
                                 circuit_cooldown_s=60.0,
                                 sleep=lambda s: None)
    for _ in range(2):
        with pytest.raises(port_retry.RetryError):
            pol.call(_Flaky(1), peer="q")
    assert pol.circuit_state("q") == "open"
    fn = _Flaky(0)
    with pytest.raises(port_retry.CircuitOpenError):
        pol.call(fn, peer="q")
    assert fn.calls == 0
    port_retry._reset_breakers()
