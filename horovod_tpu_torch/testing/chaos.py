"""Deterministic fault injection: seeded faults at named sites.

A copy of ``horovod_tpu/testing/chaos.py`` (the JAX package's module
imports no JAX). A :class:`FaultPlan` is a list of rules bound to named
injection sites; a site calls :func:`inject` with its name. The port
wires these:

========================  ====================================================
site                      where it fires
========================  ====================================================
``local_sgd.sync``        each attempt of a local-SGD sync round, before its
                          first collective (``local_sgd.run_round``;
                          transport faults retry the round whole under the
                          RetryPolicy, and exhaustion defers the round,
                          counted in ``local_sgd.rounds_deferred``)
``kv.request``            each attempt of a rendezvous KV exchange (the
                          client's RetryPolicy absorbs transport faults)
``kv.server``             the KV server, before it answers (``5xx`` as a
                          real 503, reset/timeout as a dropped connection)
``kv.wait``               each poll of a KV wait
``service.client``        each attempt of a signed RPC (``runner/service.py``)
``service.server``        the RPC server, before it reads the frame
``heartbeat``             each stamp of the elastic worker's heartbeat
``checkpoint.save``       each save (``bitflip``: rank 0 flips a byte of the
                          committed step, which the digest must catch)
``checkpoint.restore``    each restore attempt
``preemption.drain``      between the drain hooks and the persist on SIGTERM
``fusion.dispatch``       each fused batch, before its collective
                          (``ops/fusion.py``): transport kinds raise
                          ``HorovodInternalError``, ``nan`` poisons element 0
                          of the batch's first floating payload
``serve.kv_transfer``     each HTTP attempt of a disaggregated fleet's
                          KV-page stream (``serving/kv_transfer.py``;
                          transport faults retry under the RetryPolicy,
                          exhaustion falls the request back to local decode,
                          counted in ``serve.transfer_fallbacks``, never a
                          client-visible 500)
``serve.worker_kill``     serving scheduler, top of every batcher round
                          (``serving/batcher.py`` ``step``; transport kinds
                          crash the scheduler: accepted requests abort and
                          the Router's replay path fires, ``serve.replays``;
                          ``kill`` SIGKILLs the worker for the subprocess
                          drills)
``serve.migrate``         each HTTP attempt of a live-migration stream
                          (``serving/kv_transfer.py`` ``migrate`` frame;
                          transport faults retry under the RetryPolicy,
                          exhaustion brings the sequence home for a local
                          decode, ``serve.transfer_fallbacks``, never a
                          dropped request)
========================  ====================================================

Sites the library does not own (a script's training loop, as
``train.step.rank<r>`` in ``chip_smoke.py``'s phase 18) can call
:func:`inject` with their own names; the plan does not care.

Plan syntax (``HOROVOD_FAULT_PLAN``, or ``@/path/to/file`` holding the
same text): rules separated by ``;``, tokens within a rule by ``:``.

    seed=42;local_sgd.sync@2:reset;train.step:p=0.1:delay:ms=200

* ``site@N``: fire on the N-th hit of the site (1-based), once.
* ``site:p=0.25``: fire each hit with probability 0.25, from a
  per-site seeded stream (deterministic given the site's hit order).
* kinds: ``delay`` (sleep ``ms``), ``reset`` (ConnectionResetError),
  ``timeout`` (TimeoutError), ``5xx`` (a retryable server error),
  ``kill`` (``SIGKILL`` to self). Default: ``reset``.
* data kinds, ``nan`` and ``bitflip``, never raise: :func:`inject`
  returns the fired kind and the site corrupts its own payload; a site
  that cannot corrupt anything ignores it (the counters still count it).
* ``ms=250``: the delay's duration (default 100).
* ``n=3``: at most this many fires of the rule (default: 1 for ``@N``
  rules, unlimited for the others).

Every fire bumps ``faults_injected`` and ``chaos.<site>.<kind>`` in the
metrics registry (``common/metrics.py``).
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time
from typing import Dict, List, Optional

from ..common.logging import get_logger

_log = get_logger("chaos")

KINDS = ("delay", "reset", "timeout", "5xx", "kill", "nan", "bitflip")

# Kinds that corrupt DATA instead of transport: fire() RETURNS them to
# the calling site (which owns the corruption) rather than raising.
DATA_KINDS = ("nan", "bitflip")


class InjectedServerError(RuntimeError):
    """The ``5xx`` fault: a transient server-side failure. Flagged
    ``retryable`` so ``common.retry.default_retryable`` classifies it
    without importing this module; HTTP handler sites catch it and
    answer a real 503 instead."""

    retryable = True
    code = 503

    def __init__(self, site: str):
        super().__init__(f"chaos: injected 503 at {site}")
        self.site = site


class FaultRule:
    """One parsed rule. ``at`` (1-based hit index) and ``p`` are
    mutually exclusive triggers; neither means fire on every hit."""

    def __init__(
        self,
        site: str,
        kind: str = "reset",
        at: Optional[int] = None,
        p: Optional[float] = None,
        ms: float = 100.0,
        n: Optional[int] = None,
    ) -> None:
        if kind not in KINDS:
            raise ValueError(
                f"fault kind {kind!r} not one of {'/'.join(KINDS)}"
            )
        if at is not None and p is not None:
            raise ValueError(f"{site}: '@{at}' and 'p={p}' are exclusive")
        self.site = site
        self.kind = kind
        self.at = at
        self.p = p
        self.ms = float(ms)
        # @N rules default to one shot; probabilistic/always rules to
        # unlimited (n= caps either)
        self.remaining = (
            int(n) if n is not None else (1 if at is not None else -1)
        )

    def __repr__(self) -> str:  # pragma: no cover — debug aid
        trig = (
            f"@{self.at}" if self.at is not None
            else (f":p={self.p}" if self.p is not None else "")
        )
        return f"<FaultRule {self.site}{trig}:{self.kind}>"


class FaultPlan:
    """Seeded, deterministic fault schedule over named sites."""

    def __init__(self, rules: List[FaultRule], seed: int = 0) -> None:
        self.rules = list(rules)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}
        self._fired: List[Dict] = []
        # One RNG stream PER SITE, seeded by (plan seed, site name):
        # probability draws depend only on the site's own hit order, so
        # unrelated sites interleaving differently across runs cannot
        # perturb each other's schedules.
        self._rngs: Dict[str, random.Random] = {}

    # ------------------------------------------------------------- parsing

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse the ``HOROVOD_FAULT_PLAN`` syntax (module docstring).
        ``@file`` specs are resolved by :func:`configure`/:func:`_load`,
        not here."""
        seed = 0
        rules: List[FaultRule] = []
        for raw in spec.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            if raw.startswith("seed="):
                seed = int(raw[len("seed="):])
                continue
            tokens = raw.split(":")
            head = tokens[0].strip()
            at: Optional[int] = None
            if "@" in head:
                head, _, at_s = head.partition("@")
                at = int(at_s)
            kw: Dict = {"site": head, "at": at}
            for tok in tokens[1:]:
                tok = tok.strip()
                if not tok:
                    continue
                if tok.startswith("p="):
                    kw["p"] = float(tok[2:])
                elif tok.startswith("ms="):
                    kw["ms"] = float(tok[3:])
                elif tok.startswith("n="):
                    kw["n"] = int(tok[2:])
                elif tok in KINDS:
                    kw["kind"] = tok
                else:
                    raise ValueError(
                        f"fault rule {raw!r}: unknown token {tok!r}"
                    )
            rules.append(FaultRule(**kw))
        return cls(rules, seed=seed)

    # ------------------------------------------------------------ read side

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)

    def fired(self) -> List[Dict]:
        """Injection log: ``{site, kind, hit}`` per fire, in order."""
        with self._lock:
            return [dict(f) for f in self._fired]

    # ------------------------------------------------------------ fire side

    def _rng(self, site: str) -> random.Random:
        rng = self._rngs.get(site)
        if rng is None:
            rng = self._rngs[site] = random.Random(f"{self.seed}:{site}")
        return rng

    def fire(self, site: str) -> Optional[str]:
        """Count a hit at ``site`` and materialize any due fault.
        Raises the fault's exception (reset/timeout/5xx), sleeps
        (delay), or SIGKILLs the process (kill). DATA kinds
        (nan/bitflip) are returned to the caller — the site owns the
        corruption; returns None when nothing fired."""
        due: Optional[FaultRule] = None
        hit = 0
        with self._lock:
            hit = self._hits.get(site, 0) + 1
            self._hits[site] = hit
            for rule in self.rules:
                if rule.site != site or rule.remaining == 0:
                    continue
                if rule.at is not None:
                    if hit != rule.at:
                        continue
                elif rule.p is not None:
                    if self._rng(site).random() >= rule.p:
                        continue
                if rule.remaining > 0:
                    rule.remaining -= 1
                due = rule
                break
            if due is not None:
                self._fired.append(
                    {"site": site, "kind": due.kind, "hit": hit}
                )
        if due is None:
            return None
        from ..common.metrics import registry as _metrics

        _metrics.counter("faults_injected")
        _metrics.counter(f"chaos.{site}.{due.kind}")
        _log.warning(
            "chaos: injecting %s at %s (hit %d)", due.kind, site, hit
        )
        if due.kind == "delay":
            time.sleep(due.ms / 1e3)
        elif due.kind == "reset":
            raise ConnectionResetError(
                f"chaos: injected connection reset at {site}"
            )
        elif due.kind == "timeout":
            raise TimeoutError(f"chaos: injected timeout at {site}")
        elif due.kind == "5xx":
            raise InjectedServerError(site)
        elif due.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        elif due.kind in DATA_KINDS:
            return due.kind
        return None


# ------------------------------------------------------------- global plan

_plan: Optional[FaultPlan] = None
_loaded = False
_load_lock = threading.Lock()


def _load() -> Optional[FaultPlan]:
    global _plan, _loaded
    with _load_lock:
        if not _loaded:
            _loaded = True
            spec = os.environ.get("HOROVOD_FAULT_PLAN", "").strip()
            if spec.startswith("@"):
                try:
                    with open(spec[1:]) as f:
                        spec = f.read().strip()
                except OSError as e:
                    _log.error("HOROVOD_FAULT_PLAN file unreadable: %s", e)
                    spec = ""
            if spec:
                _plan = FaultPlan.parse(spec)
                _log.warning(
                    "chaos: fault plan ACTIVE (%d rules, seed=%d)",
                    len(_plan.rules), _plan.seed,
                )
        return _plan


def active() -> Optional[FaultPlan]:
    """The process-wide plan (lazily loaded from env), or None."""
    if _loaded:
        return _plan
    return _load()


def configure(spec_or_plan) -> FaultPlan:
    """Install a plan programmatically (tests / smoke harnesses);
    accepts a spec string or a built FaultPlan."""
    global _plan, _loaded
    with _load_lock:
        _plan = (
            spec_or_plan
            if isinstance(spec_or_plan, FaultPlan)
            else FaultPlan.parse(spec_or_plan)
        )
        _loaded = True
        return _plan


def reset() -> None:
    """Drop the plan; the next :func:`active` re-reads the env."""
    global _plan, _loaded
    with _load_lock:
        _plan = None
        _loaded = False


def inject(site: str) -> Optional[str]:
    """The hook every instrumented site calls. Near-zero cost when no
    plan is configured (one global read + one branch). Transport kinds
    raise; DATA kinds (nan/bitflip) are returned so the site can
    corrupt its own payload — callers that can't corrupt ignore the
    return value."""
    p = _plan
    if p is None:
        if _loaded:
            return None
        p = _load()
        if p is None:
            return None
    return p.fire(site)
