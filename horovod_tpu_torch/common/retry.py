"""Retry with backoff for the hops that may fail transiently.

A copy of ``horovod_tpu/common/retry.py`` (the JAX package's module
imports no JAX; the port keeps its own copy, as it keeps no import of
that package). One :class:`RetryPolicy` a call site, configured by the
``HOROVOD_RETRY_*`` variables (defaults in ``common/config.py``), with

* jittered exponential backoff between attempts,
* a per-attempt timeout hint and an overall deadline across attempts,
* retryable-exception classification (transport errors and 5xx retry;
  auth failures and 4xx never do),
* per-site ``retry.*`` counters in the metrics registry
  (``common/metrics.py``), and
* a per-peer circuit breaker: after N consecutive exhausted rounds
  against one peer the circuit opens and calls fail fast with
  :class:`CircuitOpenError` for a cooldown window.

Local SGD's round driver (``local_sgd.run_round``) retries each sync
round whole under a policy of site ``local_sgd.sync``. Each retry
annotates the active trace span (``common/tracing.py``) with its site,
attempt and backoff, as the JAX module does. Importable before
``hvd.init()``: :meth:`RetryPolicy.from_env` reads the environment.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

from .config import (
    DEFAULT_RETRY_ATTEMPTS as DEFAULT_ATTEMPTS,
    DEFAULT_RETRY_BACKOFF_MAX_MS as DEFAULT_BACKOFF_MAX_MS,
    DEFAULT_RETRY_BACKOFF_MS as DEFAULT_BACKOFF_MS,
    DEFAULT_RETRY_CIRCUIT_COOLDOWN_S as DEFAULT_CIRCUIT_COOLDOWN_S,
    DEFAULT_RETRY_CIRCUIT_THRESHOLD as DEFAULT_CIRCUIT_THRESHOLD,
    DEFAULT_RETRY_DEADLINE_S as DEFAULT_DEADLINE_S,
    DEFAULT_RETRY_ATTEMPT_TIMEOUT_S as DEFAULT_ATTEMPT_TIMEOUT_S,
    _env_float,
    _env_int,
)
from .logging import get_logger

_log = get_logger("retry")
# the fraction of each backoff delay randomized away (+/-): decorrelates
# a gang of workers hammering one recovering endpoint
DEFAULT_JITTER = 0.25


class RetryError(ConnectionError):
    """Every attempt failed (retryable each time) — the hop is down.

    Subclasses ``ConnectionError`` so existing ``except OSError`` /
    ``except ConnectionError`` sites treat an exhausted retry round
    exactly like the single-attempt failure they already handled.
    ``__cause__`` carries the last underlying exception."""

    def __init__(self, site: str, attempts: int, last: BaseException):
        super().__init__(
            f"{site}: {attempts} attempt(s) exhausted; last error: "
            f"{type(last).__name__}: {last}"
        )
        self.site = site
        self.attempts = attempts
        self.last = last


class CircuitOpenError(ConnectionError):
    """The per-peer circuit is open: recent rounds against this peer all
    exhausted their retries, so the policy fails fast instead of
    stalling the caller for another full backoff ladder."""

    def __init__(self, site: str, peer: str, until: float):
        super().__init__(
            f"{site}: circuit open for peer {peer!r} "
            f"(~{max(until - time.monotonic(), 0.0):.1f}s until half-open)"
        )
        self.site = site
        self.peer = peer


def default_retryable(exc: BaseException) -> bool:
    """Transport-shaped failures retry; protocol/auth failures don't.

    * anything flagging itself ``retryable = True`` (the chaos layer's
      injected 5xx does) -> retry
    * ``urllib.error.HTTPError`` -> retry only 429/5xx (a 404 is the KV
      polling miss, a 403 is an HMAC mismatch — retrying can't help)
    * ``PermissionError`` (bad RPC digest) -> never
    * ``ConnectionError`` / ``TimeoutError`` / other ``OSError`` -> retry
    """
    if getattr(exc, "retryable", False):
        return True
    try:
        from urllib.error import HTTPError
    except ImportError:  # pragma: no cover
        HTTPError = ()  # type: ignore[assignment]
    if isinstance(exc, HTTPError):
        return exc.code == 429 or 500 <= exc.code <= 599
    if isinstance(exc, PermissionError):
        return False
    return isinstance(exc, (ConnectionError, TimeoutError, OSError))


class _Breaker:
    """Consecutive-exhaustion counter + open-until stamp for one peer."""

    __slots__ = ("failures", "open_until", "half_open")

    def __init__(self) -> None:
        self.failures = 0
        self.open_until = 0.0
        self.half_open = False


# process-wide breaker table: the breaker must outlive the (often
# per-call) RetryPolicy objects, or a dead peer would never accumulate
# consecutive failures
_breakers: Dict[Tuple[str, str], _Breaker] = {}
_breakers_lock = threading.Lock()


def _reset_breakers() -> None:
    """Test hook: forget all circuit state."""
    with _breakers_lock:
        _breakers.clear()


def backoff_delays(
    initial_s: float,
    cap_s: float,
    jitter: float = DEFAULT_JITTER,
    rng: Optional[random.Random] = None,
) -> Iterator[float]:
    """Infinite jittered-doubling delay sequence — the shared backoff
    shape for both attempt retries and polling waits (the rendezvous
    ``wait`` loop uses this directly with cap ~1s)."""
    rng = rng or random
    delay = max(float(initial_s), 0.0)
    cap_s = max(float(cap_s), 0.001)
    while True:
        base = min(delay, cap_s)
        if jitter > 0:
            base *= 1.0 + jitter * (2.0 * rng.random() - 1.0)
        yield max(base, 0.0)
        delay = min(delay * 2.0 if delay > 0 else cap_s / 8, cap_s)


class RetryPolicy:
    """Jittered-exponential retry with deadline, classification,
    metrics, and a per-peer circuit breaker.

    One policy per *site* (a short dotted name like ``"kv.request"``);
    counters are published as ``retry.<site>.*`` plus process-wide
    ``retry.*_total`` aggregates.
    """

    def __init__(
        self,
        site: str,
        attempts: int = DEFAULT_ATTEMPTS,
        backoff_ms: float = DEFAULT_BACKOFF_MS,
        backoff_max_ms: float = DEFAULT_BACKOFF_MAX_MS,
        deadline_s: float = DEFAULT_DEADLINE_S,
        attempt_timeout_s: float = DEFAULT_ATTEMPT_TIMEOUT_S,
        retryable: Callable[[BaseException], bool] = default_retryable,
        circuit_threshold: int = DEFAULT_CIRCUIT_THRESHOLD,
        circuit_cooldown_s: float = DEFAULT_CIRCUIT_COOLDOWN_S,
        jitter: float = DEFAULT_JITTER,
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self.site = site
        self.attempts = max(int(attempts), 1)
        self.backoff_s = max(float(backoff_ms), 0.0) / 1e3
        self.backoff_max_s = max(float(backoff_max_ms), 1.0) / 1e3
        self.deadline_s = float(deadline_s)
        self.attempt_timeout_s = float(attempt_timeout_s)
        self.is_retryable = retryable
        self.circuit_threshold = max(int(circuit_threshold), 0)
        self.circuit_cooldown_s = max(float(circuit_cooldown_s), 0.0)
        self.jitter = float(jitter)
        # per-process decorrelation: two workers with identical configs
        # must not march their backoffs in lockstep against one server
        self._rng = rng or random.Random(f"{site}:{os.getpid()}")
        self._sleep = sleep

    @classmethod
    def from_env(cls, site: str, **overrides) -> "RetryPolicy":
        """Build from ``HOROVOD_RETRY_*`` (usable before hvd.init()),
        with the defaults and parsers of ``common/config.py``. Explicit
        keyword overrides win over env."""
        kw = dict(
            attempts=_env_int("HOROVOD_RETRY_ATTEMPTS", DEFAULT_ATTEMPTS),
            backoff_ms=_env_float(
                "HOROVOD_RETRY_BACKOFF_MS", DEFAULT_BACKOFF_MS
            ),
            backoff_max_ms=_env_float(
                "HOROVOD_RETRY_BACKOFF_MAX_MS", DEFAULT_BACKOFF_MAX_MS
            ),
            deadline_s=_env_float(
                "HOROVOD_RETRY_DEADLINE_S", DEFAULT_DEADLINE_S
            ),
            attempt_timeout_s=_env_float(
                "HOROVOD_RETRY_ATTEMPT_TIMEOUT_S", DEFAULT_ATTEMPT_TIMEOUT_S
            ),
            circuit_threshold=_env_int(
                "HOROVOD_RETRY_CIRCUIT_THRESHOLD", DEFAULT_CIRCUIT_THRESHOLD
            ),
            circuit_cooldown_s=_env_float(
                "HOROVOD_RETRY_CIRCUIT_COOLDOWN_S", DEFAULT_CIRCUIT_COOLDOWN_S
            ),
        )
        kw.update(overrides)
        return cls(site, **kw)

    # ------------------------------------------------------------ metrics

    def _count(self, which: str, inc: float = 1.0) -> None:
        from .metrics import registry as _metrics

        _metrics.counter(f"retry.{self.site}.{which}", inc)
        _metrics.counter(f"retry.{which}_total", inc)

    # ----------------------------------------------------- circuit breaker

    def _breaker(self, peer: str) -> _Breaker:
        key = (self.site, peer)
        with _breakers_lock:
            b = _breakers.get(key)
            if b is None:
                b = _breakers[key] = _Breaker()
            return b

    def _check_circuit(self, peer: Optional[str]) -> None:
        if peer is None or self.circuit_threshold <= 0:
            return
        b = self._breaker(peer)
        now = time.monotonic()
        with _breakers_lock:
            if b.failures < self.circuit_threshold:
                return
            if now < b.open_until:
                pass  # still open -> raise below (outside the lock)
            elif not b.half_open:
                # cooldown elapsed: let exactly one probe round through
                b.half_open = True
                return
            else:
                return  # a probe is already in flight; let callers race
        self._count("circuit_open")
        raise CircuitOpenError(self.site, peer, b.open_until)

    def _record_outcome(self, peer: Optional[str], ok: bool) -> None:
        if peer is None or self.circuit_threshold <= 0:
            return
        b = self._breaker(peer)
        with _breakers_lock:
            if ok:
                b.failures = 0
                b.open_until = 0.0
                b.half_open = False
                return
            b.failures += 1
            b.half_open = False
            if b.failures >= self.circuit_threshold:
                b.open_until = time.monotonic() + self.circuit_cooldown_s
        if b.failures == self.circuit_threshold:
            _log.warning(
                "%s: circuit OPEN for peer %s after %d consecutive "
                "exhausted rounds (cooldown %.1fs)",
                self.site, peer, b.failures, self.circuit_cooldown_s,
            )

    def circuit_state(self, peer: str) -> str:
        """'closed' | 'open' | 'half_open' — observability/test surface."""
        b = self._breaker(peer)
        with _breakers_lock:
            if b.failures < self.circuit_threshold:
                return "closed"
            if time.monotonic() < b.open_until and not b.half_open:
                return "open"
            return "half_open" if b.half_open else "open"

    # ---------------------------------------------------------------- call

    def call(self, fn: Callable, *args, peer: Optional[str] = None, **kwargs):
        """Run ``fn(*args, **kwargs)`` under the policy.

        Retries when ``is_retryable(exc)``; sleeps the jittered backoff
        between attempts; stops early when the overall deadline would be
        crossed; raises :class:`RetryError` (chained to the last
        failure) on exhaustion, or the original exception immediately
        when it isn't retryable. With ``peer`` set, consults/updates the
        per-peer circuit breaker. ``fn`` must be safe to re-run — every
        wired site is an idempotent GET/PUT/notify."""
        self._check_circuit(peer)
        deadline = (
            time.monotonic() + self.deadline_s
            if self.deadline_s > 0
            else None
        )
        delays = backoff_delays(
            self.backoff_s, self.backoff_max_s, self.jitter, self._rng
        )
        last: Optional[BaseException] = None
        for attempt in range(1, self.attempts + 1):
            self._count("attempts")
            try:
                out = fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — classified below
                if not self.is_retryable(e):
                    # surfaces immediately and does NOT move the
                    # breaker: an auth/4xx failure is a protocol
                    # problem, not evidence the peer is dead — only
                    # exhausted rounds open the circuit (success still
                    # closes it)
                    raise
                last = e
                if attempt >= self.attempts:
                    break
                delay = next(delays)
                if deadline is not None and (
                    time.monotonic() + delay >= deadline
                ):
                    _log.debug(
                        "%s: deadline would be crossed; stopping after "
                        "attempt %d", self.site, attempt,
                    )
                    break
                self._count("retries")
                _log.debug(
                    "%s: attempt %d/%d failed (%s: %s); retrying in "
                    "%.0fms", self.site, attempt, self.attempts,
                    type(e).__name__, e, delay * 1e3,
                )
                # pin this retry to the span it runs under (a thread-local
                # read when the request is untraced)
                from . import tracing as _tracing

                _tracing.annotate(
                    f"retry:{self.site}#{attempt}@{delay * 1e3:.0f}ms"
                )
                self._sleep(delay)
            else:
                self._record_outcome(peer, ok=True)
                return out
        self._count("exhausted")
        self._record_outcome(peer, ok=False)
        assert last is not None
        # report the attempts that actually RAN — the deadline may have
        # stopped the round short of the configured budget
        raise RetryError(self.site, attempt, last) from last
