"""Online autotuning: the fusion threshold by Bayesian optimization, and
the discrete wire and bucket-count choices by goodput bandits.

The counterpart of ``horovod_tpu/common/autotune.py`` (the reference's
``parameter_manager.cc`` and its GP/EI optimizer), the tuners numpy
only (the last section's agreement uses ``torch.distributed``):

- :class:`ParameterManager` (``HOROVOD_AUTOTUNE=1``) scores each sample
  window of steps by goodput (useful bytes a second), models the
  score as a Gaussian process over (log2 fusion threshold, cycle time)
  and proposes the next point by expected improvement. The port records
  the cycle dimension as the JAX manager does but acts on the threshold
  only: its fusion ticks at poll/wait/step, never by the clock
  (``HOROVOD_CYCLE_TIME`` waits for ROADMAP A3). ``agree`` makes the
  sample's numbers the same on every rank (:func:`agree_sample`), so
  every rank proposes the same threshold. **The one difference from the
  JAX manager:** it records every flush and closes a sample each
  ``steps_per_sample`` flushes; the port records a step, closed at a
  world ``DistributedOptimizer.step()`` or at ``hvd.step_end()``
  (``FusionManager.end_step``), so ``steps_per_sample`` counts steps.
  Every rank reaches those two points alike; a count of flushes is not
  alike across ranks once process sets run batches on their members
  only.
- :class:`WireTuner` picks the fused wire of each bucket tier
  (``HOROVOD_FUSION_WIRE=auto``), :class:`OverlapTuner` the bucketed
  exchange's bucket count and :class:`CapacityTuner` the MoE dispatch's
  capacity factor (driven by ``parallel/moe.py``'s
  :func:`~..parallel.moe.tune_capacity`), each by explore-then-exploit
  over its menu.
- Their observations persist under ``HOROVOD_TUNER_CACHE``, keyed by
  tuner name and :func:`topology_fingerprint`, so a restarted job
  skips straight to exploitation.
- How every rank comes to the same choices (one starting state, agreed
  readings, group-scoped keys) is the last section's, and only there.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

# Search bounds: threshold 1 KB .. 512 MB (log2 scale), cycle 0.1 .. 25 ms
# (the reference tunes the same two knobs over similar ranges).
_LOG2_THRESH_LO, _LOG2_THRESH_HI = 10.0, 29.0
_CYCLE_LO, _CYCLE_HI = 0.1, 25.0


class GaussianProcess:
    """GP regression with an RBF kernel on unit-box-normalized inputs
    (the reference's gaussian_process.cc)."""

    def __init__(self, noise: float = 0.8, length_scale: float = 0.2):
        self.noise = noise
        self.length_scale = length_scale
        self._x: Optional[np.ndarray] = None
        self._y_mean = 0.0
        self._y_std = 1.0
        self._alpha: Optional[np.ndarray] = None
        self._l_chol: Optional[np.ndarray] = None

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / self.length_scale**2)

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        self._x = np.atleast_2d(x)
        y = np.asarray(y, dtype=np.float64)
        self._y_mean = float(y.mean())
        self._y_std = float(y.std()) or 1.0
        yn = (y - self._y_mean) / self._y_std
        k = self._kernel(self._x, self._x)
        k[np.diag_indices_from(k)] += self.noise**2
        self._l_chol = np.linalg.cholesky(k)
        self._alpha = np.linalg.solve(
            self._l_chol.T, np.linalg.solve(self._l_chol, yn)
        )

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        x = np.atleast_2d(x)
        ks = self._kernel(x, self._x)
        mu = ks @ self._alpha
        v = np.linalg.solve(self._l_chol, ks.T)
        var = np.clip(1.0 - (v**2).sum(0), 1e-12, None)
        return mu * self._y_std + self._y_mean, np.sqrt(var) * self._y_std


def expected_improvement(
    mu: np.ndarray, sigma: np.ndarray, best: float, xi: float = 0.01
) -> np.ndarray:
    """EI acquisition (the reference's bayesian_optimization.cc)."""
    from math import erf, sqrt

    z = (mu - best - xi) / sigma
    cdf = 0.5 * (1.0 + np.vectorize(erf)(z / sqrt(2.0)))
    pdf = np.exp(-0.5 * z**2) / math.sqrt(2 * math.pi)
    return (mu - best - xi) * cdf + sigma * pdf


class BayesianOptimizer:
    """Propose-next-candidate loop over the (threshold, cycle) box."""

    def __init__(self, noise: float = 0.8, seed: int = 0):
        self._gp = GaussianProcess(noise=noise)
        self._rng = np.random.default_rng(seed)
        self._xs: List[np.ndarray] = []
        self._ys: List[float] = []

    @staticmethod
    def _normalize(threshold_log2: float, cycle_ms: float) -> np.ndarray:
        return np.array(
            [
                (threshold_log2 - _LOG2_THRESH_LO)
                / (_LOG2_THRESH_HI - _LOG2_THRESH_LO),
                (cycle_ms - _CYCLE_LO) / (_CYCLE_HI - _CYCLE_LO),
            ]
        )

    @staticmethod
    def _denormalize(p: np.ndarray) -> Tuple[int, float]:
        log2t = _LOG2_THRESH_LO + p[0] * (_LOG2_THRESH_HI - _LOG2_THRESH_LO)
        cycle = _CYCLE_LO + p[1] * (_CYCLE_HI - _CYCLE_LO)
        return int(2 ** round(log2t)), float(round(cycle, 2))

    def observe(self, threshold_bytes: int, cycle_ms: float, score: float):
        self._xs.append(
            self._normalize(math.log2(max(threshold_bytes, 1)), cycle_ms)
        )
        self._ys.append(score)

    def suggest(self) -> Tuple[int, float]:
        if len(self._xs) < 2:
            p = self._rng.uniform(size=2)
            return self._denormalize(p)
        self._gp.fit(np.stack(self._xs), np.array(self._ys))
        cands = self._rng.uniform(size=(256, 2))
        mu, sigma = self._gp.predict(cands)
        ei = expected_improvement(mu, sigma, best=max(self._ys))
        return self._denormalize(cands[int(np.argmax(ei))])

    def best(self) -> Tuple[int, float]:
        i = int(np.argmax(self._ys))
        return self._denormalize(self._xs[i])


class ParameterManager:
    """Drives sampling windows over live traffic (the reference's
    parameter_manager.cc Tune()/Step()). record() takes one step (the
    port's fusion manager feeds it at each step of a world
    DistributedOptimizer; the JAX one, each cycle); steps_per_sample of
    them make one score sample. ``agree`` ((bytes, seconds) -> (bytes,
    seconds)), called at every sample boundary, makes the sample's
    numbers the same on every rank."""

    def __init__(
        self,
        initial_threshold: int,
        initial_cycle_ms: float,
        warmup_samples: int = 3,
        steps_per_sample: int = 10,
        max_samples: int = 20,
        gp_noise: float = 0.8,
        log_path: Optional[str] = None,
        agree=None,
    ):
        self._agree = agree
        self._threshold = initial_threshold
        self._cycle_ms = initial_cycle_ms
        self._warmup_left = warmup_samples
        self._steps_per_sample = steps_per_sample
        self._max_samples = max_samples
        self._optimizer = BayesianOptimizer(noise=gp_noise)
        self._log_path = log_path
        self._bytes = 0
        self._wire_bytes = 0
        self._seconds = 0.0
        self._steps = 0
        self._samples = 0
        self._frozen = False

    @classmethod
    def from_config(cls, cfg, agree=None) -> "ParameterManager":
        return cls(
            agree=agree,
            initial_threshold=cfg.fusion_threshold_bytes,
            initial_cycle_ms=cfg.cycle_time_ms,
            warmup_samples=cfg.autotune_warmup_samples,
            steps_per_sample=cfg.autotune_steps_per_sample,
            max_samples=cfg.autotune_bayes_opt_max_samples,
            gp_noise=cfg.autotune_gaussian_process_noise,
            log_path=cfg.autotune_log,
        )

    def current(self) -> Tuple[int, float]:
        return self._threshold, self._cycle_ms

    @property
    def frozen(self) -> bool:
        return self._frozen

    def record(
        self,
        bytes_: int,
        seconds: float,
        wire_bytes: Optional[int] = None,
    ) -> None:
        """One flush sample. ``bytes_`` is USEFUL payload; ``wire_bytes``
        (>= bytes_) is what actually moved, bucket padding included. The
        score is goodput — useful bytes per second — so a parameter
        choice that pads more pays for its padding in time without
        being credited for the padded bytes; the wire/pad split is
        still logged and exported so the padding cost stays visible."""
        if self._frozen:
            return
        self._bytes += bytes_
        self._wire_bytes += wire_bytes if wire_bytes is not None else bytes_
        self._seconds += seconds
        self._steps += 1
        if self._steps < self._steps_per_sample:
            return
        if self._agree is not None:
            self._bytes, self._seconds = self._agree(self._bytes,
                                                     self._seconds)
        score = self._bytes / max(self._seconds, 1e-9)
        pad = self._wire_bytes - self._bytes
        self._log(score, note=f"pad_bytes={pad}" if pad else "")
        from .metrics import registry as _metrics

        _metrics.update(
            "autotune",
            {
                "score": score,
                "sample_bytes": self._bytes,
                "sample_wire_bytes": self._wire_bytes,
                "sample_pad_bytes": pad,
            },
        )
        self._bytes, self._wire_bytes = 0, 0
        self._seconds, self._steps = 0.0, 0
        if self._warmup_left > 0:
            self._warmup_left -= 1
            return
        self._samples += 1
        self._optimizer.observe(self._threshold, self._cycle_ms, score)
        if self._samples >= self._max_samples:
            self._threshold, self._cycle_ms = self._optimizer.best()
            self._frozen = True
            self._log(None, note="frozen")
        else:
            self._threshold, self._cycle_ms = self._optimizer.suggest()

    def _log(self, score, note: str = "") -> None:
        if not self._log_path:
            return
        with open(self._log_path, "a") as f:
            f.write(
                f"threshold={self._threshold} cycle_ms={self._cycle_ms} "
                f"score={'' if score is None else f'{score:.3e}'} {note}\n"
            )


class _GoodputBandit:
    """Shared explore-then-exploit core of the discrete tuners: per
    (key, candidate) goodput accounting (useful bytes per second),
    ``trials`` exploration visits round-robin, then argmax. A bandit,
    not a GP: these decisions are small discrete menus, where the GP's
    machinery buys nothing (it remains the right tool for the
    continuous (threshold, cycle) box above).

    Observations are durable: :meth:`state_dict` /
    :meth:`load_state_dict` serialize them, and the module-level
    :func:`warm_start` / :func:`persist` pair keys the file by
    (tuner name, topology fingerprint) under ``HOROVOD_TUNER_CACHE``
    so a fleet explores once instead of per-process per-run (the
    per-hop keyspaces, (bucket-tier, hop) and (alltoall, hop), make a
    cold start the more expensive)."""

    def __init__(self, trials: int = 3):
        self.trials = max(int(trials), 1)
        # (key, candidate) -> [useful_bytes_total, seconds_total, n]
        self._obs = {}

    # -- persistence --------------------------------------------------

    def state_dict(self) -> dict:
        """JSON-serializable snapshot of every observation. Keys are
        tuples of str/int/float (the tuners' contract) — encoded as
        lists and rebuilt as tuples on load."""
        return {
            "trials": self.trials,
            "obs": [
                [list(key) if isinstance(key, tuple) else [key],
                 cand, s[0], s[1], s[2]]
                for (key, cand), s in self._obs.items()
            ],
        }

    def load_state_dict(self, state: dict) -> int:
        """Merge a snapshot back in (existing observations win — live
        measurements beat stale disk state). Returns the number of
        (key, candidate) entries adopted; malformed entries are
        skipped — a corrupt cache must never break the tuner."""
        adopted = 0
        for row in state.get("obs", ()):
            try:
                key_list, cand, by, secs, n = row
                key = tuple(key_list)
                if isinstance(cand, list):
                    cand = tuple(cand)
                entry = (key, cand)
                if entry in self._obs:
                    continue
                self._obs[entry] = [float(by), float(secs), int(n)]
                adopted += 1
            except (TypeError, ValueError):
                continue
        return adopted

    def _stats(self, key, cand):
        return self._obs.setdefault((key, cand), [0.0, 0.0, 0])

    def needs_trial(self, key, cand) -> bool:
        """True while this (key, candidate) is still under-explored."""
        return self._obs.get((key, cand), (0, 0, 0))[2] < self.trials

    def record(self, key, cand, useful_bytes: int, seconds: float) -> None:
        s = self._stats(key, cand)
        s[0] += float(useful_bytes)
        s[1] += float(seconds)
        s[2] += 1

    def goodput(self, key, cand) -> float:
        s = self._obs.get((key, cand))
        if not s or s[2] == 0:
            return 0.0
        return s[0] / max(s[1], 1e-9)

    def _choose_among(self, key, cands):
        """Single-candidate shortcut (marked fully trialed so callers
        never pay trial synchronization for a decision with one
        possible answer), else explore round-robin, else exploit the
        goodput argmax."""
        if len(cands) == 1:
            s = self._stats(key, cands[0])
            s[2] = max(s[2], self.trials)
            return cands[0]
        for c in cands:
            if self.needs_trial(key, c):
                return c
        return max(cands, key=lambda c: self.goodput(key, c))


class WireTuner(_GoodputBandit):
    """Per-bucket-tier online choice of the fused wire format
    (``HOROVOD_FUSION_WIRE=auto``) by goodput — useful bytes per second
    of dispatch wall time, so the measurement charges each format its
    own quantization tax and credits it for the wire bytes it removes.
    The fusion manager synchronizes the device around exactly the
    ``needs_trial`` dispatches (an asynchronous launch's host time is
    format-independent and would teach the tuner nothing), takes the
    slowest rank's seconds, and stops recording once the trials are in
    (explore-then-freeze).

    Two-level wires key the bandit PER HOP — callers append the hop to
    the bucket key (``(bucket-tier..., 'intra'|'inter')``), so goodput
    can converge on bf16-intra / int8-inter independently: the intra
    menu never includes int8 (the intra link is fast; the quant tax
    cannot pay for itself inside a node) while the inter key is sized
    by the 1/L shard the inter hop actually carries. Flat wires keep the plain
    bucket key — the keyspaces never mix.

    Two static priors bound the exploration:

    * buckets under ``min_int8_bytes`` never try int8 — the per-dispatch
      quantize tax is O(payload)+fixed while the wire saving is
      O(payload), so below a payload floor the tax always wins
      (``HOROVOD_FUSION_WIRE_MIN_BYTES``);
    * ``candidates`` restricts the menu (int8 only where the op/dtype
      qualify — the fusion manager filters before asking).
    """

    CANDIDATES = ("fp32", "bf16", "int8")

    def __init__(self, min_int8_bytes: int = 64 * 1024, trials: int = 3):
        super().__init__(trials=trials)
        self.min_int8_bytes = int(min_int8_bytes)

    def choose(
        self, bucket_key, payload_bytes: int, candidates=None,
        itemsize: int = 4,
    ) -> str:
        """Pick the wire format for one fused dispatch of this bucket
        tier. Tiny buckets short-circuit to fp32/bf16 (never int8);
        candidates that cannot shrink the payload are dropped (bf16
        saves nothing on an already-2-byte fp16/bf16 payload, and the
        cast would silently truncate mantissa for free); otherwise
        under-explored candidates are tried round-robin and the steady
        state is the goodput argmax."""
        cands = list(candidates if candidates is not None else self.CANDIDATES)
        if payload_bytes < self.min_int8_bytes:
            cands = [c for c in cands if c != "int8"]
        if itemsize <= 2:
            cands = [c for c in cands if c != "bf16"]
        if not cands:
            return "fp32"
        return self._choose_among(bucket_key, cands)


class OverlapTuner(_GoodputBandit):
    """Choice of the backward-interleaved exchange's bucket count
    (``ops/overlap.py``) by WHOLE-STEP goodput — useful gradient bytes
    per second of step wall time. The bucket schedule trades two
    opposing costs the byte model cannot rank a priori: more buckets
    expose more backward compute to hide wire time behind (win), but
    each bucket pays a collective launch + a smaller message's worse
    bandwidth utilization (loss). Scoring the STEP, not the collective,
    lets the measurement settle it — the same reasoning that moved the
    ParameterManager's score to goodput.

    Driven by the step harness: a bucket-count change changes the
    schedule, so the harness (``DistributedOptimizer(overlap_buckets=
    "auto")`` in the port) times a few device-synchronized steps per
    candidate, feeds ``record``, and rebuilds its schedule with
    ``choose``'s answer; the timing must include the device's work or
    the tuner learns launch overhead, not overlap.

    ``min_bucket_bytes`` is the static prior bounding the explore set:
    a candidate whose per-bucket size would fall under the floor can
    only lose (launch overhead is O(1) per bucket while the hidden
    wire time is O(bucket bytes)), so it is never tried — the
    ``HOROVOD_OVERLAP_MIN_BYTES`` knob, autotuned-path edition.
    """

    CANDIDATES = (1, 2, 4, 8, 16)

    def __init__(
        self,
        min_bucket_bytes: int = 1 << 20,
        trials: int = 3,
        candidates=None,
    ):
        super().__init__(trials=trials)
        self.min_bucket_bytes = int(min_bucket_bytes)
        self.candidates = tuple(
            candidates if candidates is not None else self.CANDIDATES
        )

    def viable(self, total_bytes: int):
        """Candidates whose balanced bucket size clears the byte floor
        (1 always qualifies — the monolithic schedule is the control)."""
        return tuple(
            c
            for c in self.candidates
            if c == 1 or total_bytes // c >= self.min_bucket_bytes
        )

    def choose(self, step_key, total_bytes: int) -> int:
        return self._choose_among(step_key, self.viable(total_bytes))


class CapacityTuner(_GoodputBandit):
    """The MoE dispatch's ``capacity_factor`` (``parallel/moe.py``) by
    kept-token goodput, fed by the load counters the dispatch already
    makes (``MoEStats``). A larger factor drops fewer tokens and pays a
    larger dispatch buffer (wire bytes, the experts' padding); a smaller
    one is cheap until hot experts overflow, and hot experts are
    stragglers. Kept tokens a second of step time settle it. Capacity is
    a shape, so the step harness (:func:`~..parallel.moe.tune_capacity`)
    times whole steps a candidate, never a piece of one.

    :meth:`observe_load` also folds each step's histogram into a drop
    rate and an imbalance a candidate. :meth:`choose` takes the drop rate
    as a hard prior: a candidate whose measured drop rate exceeds
    ``max_drop_rate`` after its trials is never exploited (dropped tokens
    are lost model quality, not only lost goodput)."""

    CANDIDATES = (1.0, 1.25, 1.5, 2.0)

    def __init__(self, trials: int = 3, candidates=None,
                 max_drop_rate: float = 0.2):
        super().__init__(trials=trials)
        self.candidates = tuple(
            candidates if candidates is not None else self.CANDIDATES
        )
        self.max_drop_rate = float(max_drop_rate)
        # (key, cand) -> [dropped, routed, hottest expert, steps, experts]
        self._loads = {}

    def observe_load(self, key, cand, expert_tokens, dropped: float,
                     total: float, seconds: Optional[float] = None) -> None:
        """One step's load counters for (key, candidate):
        ``expert_tokens`` the kept-token histogram (``[E_total]``),
        ``dropped``/``total`` the overflow and routed counts (host
        floats). With ``seconds`` the step also feeds the goodput ledger,
        kept tokens being the useful quantity."""
        tokens = [float(t) for t in expert_tokens]
        s = self._loads.setdefault(
            (key, cand), [0.0, 0.0, 0.0, 0, max(len(tokens), 1)])
        s[0] += float(dropped)
        s[1] += float(total)
        s[2] = max(s[2], max(tokens, default=0.0))
        s[3] += 1
        s[4] = max(s[4], len(tokens))
        if seconds is not None:
            self.record(key, cand, float(total) - float(dropped), seconds)

    def drop_rate(self, key, cand) -> float:
        s = self._loads.get((key, cand))
        if not s or s[1] <= 0:
            return 0.0
        return s[0] / s[1]

    def imbalance(self, key, cand) -> float:
        """The hottest expert's load over the mean kept tokens an expert
        a step (1.0: balanced)."""
        s = self._loads.get((key, cand))
        if not s or s[3] == 0 or s[1] <= s[0]:
            return 1.0
        mean_kept = (s[1] - s[0]) / s[3] / max(s[4], 1)
        if mean_kept <= 0:
            return 1.0
        return s[2] / mean_kept

    def choose(self, key) -> float:
        cands = [c for c in self.candidates
                 if self.needs_trial(key, c)
                 or self.drop_rate(key, c) <= self.max_drop_rate]
        if not cands:
            # every candidate overflows past the bound: the largest
            # buffer drops least
            return max(self.candidates)
        return self._choose_among(key, tuple(cands))

    def state_dict(self) -> dict:
        d = super().state_dict()
        d["loads"] = [
            [list(key) if isinstance(key, tuple) else [key],
             cand, s[0], s[1], s[2], s[3], s[4]]
            for (key, cand), s in self._loads.items()
        ]
        return d

    def load_state_dict(self, state: dict) -> int:
        adopted = super().load_state_dict(state)
        for row in state.get("loads", ()):
            try:
                key_list, cand, dropped, total, hot, n, ne = row
                entry = (tuple(key_list), cand)
                if entry in self._loads:
                    continue
                self._loads[entry] = [float(dropped), float(total),
                                      float(hot), int(n), int(ne)]
            except (TypeError, ValueError):
                continue
        return adopted


# ---------------------------------------------------------------------------
# Persistent tuner state (HOROVOD_TUNER_CACHE).
#
# Exploration is the expensive half of a bandit whose keyspace is
# per-hop and per-collective-family: every process of every run would
# pay `trials` deliberately synchronized dispatches per (key,
# candidate). Persisting the observations keyed by
# (tuner name, topology fingerprint) lets a restarted — or freshly
# scheduled — job start from the fleet's measurements and skip straight
# to exploitation. The fingerprint pins everything that changes what a
# measurement MEANS: world size, the two-level split, and the backend.
# ---------------------------------------------------------------------------


def topology_fingerprint(topology=None, device=None) -> str:
    """``w<world>-l<intra>-<platform>`` of the current process (or of
    ``topology`` on ``device``), the cache key namespace for persisted
    tuner state (platform ``cuda`` or ``cpu``, the device the world
    computes on). Falls back to the environment's contract before
    ``hvd.init``."""
    import torch

    from . import basics as _basics
    from .config import TrainConfig

    if topology is not None:
        world, intra = topology.size, topology.local_size
        platform = torch.device(device).type
    elif _basics.is_initialized():
        st = _basics.state()
        world = st.topology.size
        intra = st.topology.local_size
        platform = st.device.type
    else:
        cfg = TrainConfig.from_env()
        world = cfg.size or 1
        intra = cfg.intra_size or cfg.local_size or 1
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    return f"w{world}-l{intra}-{platform}"


def tuner_cache_path(
    name: str, fingerprint: Optional[str] = None,
    base: Optional[str] = None,
) -> Optional[str]:
    """The persisted-state file for one tuner, or None when no cache
    directory is configured (HOROVOD_TUNER_CACHE / explicit base)."""
    import os

    if base is None:
        base = os.environ.get("HOROVOD_TUNER_CACHE") or None
    if not base:
        return None
    if fingerprint is None:
        fingerprint = topology_fingerprint()
    return os.path.join(base, f"{name}-{fingerprint}.json")


def _read_state(name: str, fingerprint: Optional[str] = None,
                base: Optional[str] = None) -> Optional[dict]:
    """The cached state of one tuner, or None (no cache, no file, or a
    corrupt one)."""
    import json
    import os

    path = tuner_cache_path(name, fingerprint, base)
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            state = json.load(f)
    except (OSError, ValueError):
        return None
    return state if isinstance(state, dict) else None


def _load(tuner: _GoodputBandit, state: dict) -> int:
    n = tuner.load_state_dict(state)
    if n:
        from .metrics import registry as _metrics

        _metrics.counter("autotune.warm_started", n)
    return n


def warm_start(
    tuner: _GoodputBandit, name: str,
    fingerprint: Optional[str] = None, base: Optional[str] = None,
) -> int:
    """Load persisted observations into ``tuner`` (existing live
    entries win). Returns the number of entries adopted; 0 when no
    cache is configured, the file is absent, or it is corrupt — warm
    start is best-effort by design, cold start is always correct."""
    state = _read_state(name, fingerprint, base)
    return 0 if state is None else _load(tuner, state)


def _merge_rows(own, disk):
    """Union of state rows keyed by (key, candidate) — the tuner's own
    rows win. Rows are ``[key_list, cand, ...]``."""
    def _k(row):
        cand = row[1]
        return (tuple(row[0]), tuple(cand) if isinstance(cand, list) else cand)

    seen = {_k(r) for r in own}
    return list(own) + [r for r in disk if _k(r) not in seen]


def persist(
    tuner: _GoodputBandit, name: str,
    fingerprint: Optional[str] = None, base: Optional[str] = None,
) -> Optional[str]:
    """Write ``tuner``'s observations to the cache (tmp+rename — a
    killed process can never leave a torn file), MERGED with whatever
    is already on disk (rows this tuner never saw are kept; its own
    rows win): several tuners legitimately share one file — the fused
    dispatcher's WireTuner (allreduce keys) and the build-time shared
    tuner (alltoall and bucket keys) both persist under ``wire`` — and a plain
    overwrite would have the last atexit writer discard the other's
    run. Returns the path, or None when no cache is configured / the
    write failed (best-effort: persistence must never take a training
    loop down)."""
    import json
    import os
    import tempfile

    path = tuner_cache_path(name, fingerprint, base)
    if not path:
        return None
    state = tuner.state_dict()
    try:
        with open(path) as f:
            disk = json.load(f)
    except (OSError, ValueError):
        disk = None
    if isinstance(disk, dict):
        for field in ("obs", "loads"):
            if field in state or field in disk:
                state[field] = _merge_rows(
                    state.get(field, []), disk.get(field, [])
                )
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(path), suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(state, f)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except OSError:
        return None
    return path


_shared_wire_tuner: Optional[WireTuner] = None


def shared_wire_tuner() -> WireTuner:
    """The process-wide WireTuner for build-time wire decisions (the
    MoE alltoall's ``(alltoall, payload-bucket, dtype, hop)`` keys and
    the bucketed legs', unlike the fusion manager's per-dispatch
    instance), started from the world's agreed state (:func:`adopt`)
    and persisted alongside it (same ``wire`` namespace: the keyspaces
    are disjoint by construction — (alltoall, ...) vs (allreduce, ...)
    — so one file serves both). Nothing in the port records into it
    yet: without cached observations the legs' and the expert wire's
    ``auto`` is the fixed prior their resolvers state."""
    global _shared_wire_tuner
    if _shared_wire_tuner is None:
        from .config import TrainConfig

        cfg = TrainConfig.from_env()
        _shared_wire_tuner = WireTuner(
            min_int8_bytes=cfg.fusion_wire_min_bytes
        )
        adopt(_shared_wire_tuner, "wire")
    return _shared_wire_tuner


_shared_overlap_tuner: Optional[OverlapTuner] = None


def shared_overlap_tuner(**kwargs) -> OverlapTuner:
    """The process-wide OverlapTuner with durable state: started from
    the world's agreed state (:func:`adopt`, ``HOROVOD_TUNER_CACHE``'s
    ``overlap`` file) on first use and persisted, so a restarted
    step harness skips straight to exploitation instead of re-timing
    every bucket-count candidate. First call's ``kwargs`` win
    (min_bucket_bytes / trials / candidates); observations merge with
    disk on persist like every tuner (autotune.persist)."""
    global _shared_overlap_tuner
    if _shared_overlap_tuner is None:
        _shared_overlap_tuner = OverlapTuner(**kwargs)
        adopt(_shared_overlap_tuner, "overlap")
    return _shared_overlap_tuner


_shared_capacity_tuner: Optional[CapacityTuner] = None


def shared_capacity_tuner(**kwargs) -> CapacityTuner:
    """The process-wide CapacityTuner with durable state, started from
    the world's agreed ``capacity`` state (:func:`adopt`) on first use
    and persisted with it. The load ledger rides the snapshot
    (:meth:`CapacityTuner.state_dict`), so the ``max_drop_rate`` prior
    survives a restart with the goodput observations. First call's
    ``kwargs`` win (trials / candidates / max_drop_rate)."""
    global _shared_capacity_tuner
    if _shared_capacity_tuner is None:
        _shared_capacity_tuner = CapacityTuner(**kwargs)
        adopt(_shared_capacity_tuner, "capacity")
    return _shared_capacity_tuner


def reset_shared_tuners() -> None:
    """Drop the shared wire, overlap and capacity tuners (tests, and
    :func:`end_world`)."""
    global _shared_overlap_tuner, _shared_wire_tuner, _shared_capacity_tuner
    _shared_overlap_tuner = None
    _shared_wire_tuner = None
    _shared_capacity_tuner = None


_persist_registry = []
_persist_hook_installed = [False]


def register_persist_at_exit(tuner: _GoodputBandit, name: str,
                             fingerprint: Optional[str] = None) -> None:
    """Arrange for ``tuner`` to be persisted at interpreter exit (one
    atexit hook for every registered tuner; no-ops without a cache
    dir), under ``fingerprint`` when given (a world's tuner keeps its
    world's file after ``hvd.shutdown()``). Registration is idempotent
    per (id(tuner), name)."""
    import atexit

    entry = (id(tuner), name)
    if any(e == entry for e, _ in _persist_registry):
        return
    _persist_registry.append((entry, (tuner, name, fingerprint)))
    if not _persist_hook_installed[0]:
        _persist_hook_installed[0] = True

        def _flush():
            for _, (t, n, fp) in list(_persist_registry):
                try:
                    persist(t, n, fp)
                except Exception:
                    pass

        atexit.register(_flush)


# ---------------------------------------------------------------------------
# Agreement across ranks.
#
# The port runs one process a rank, so every choice a tuner makes must
# come out the same on every rank of the collective it shapes; otherwise
# the ranks' collectives stop matching (a size error, a hang, or wrong
# sums). Both rules that make it so live here:
#
# - one starting state: at ``hvd.init()`` world rank 0 alone reads the
#   cache and one broadcast hands its states to every rank
#   (:func:`start_world`); every tuner of the world starts from them
#   (:func:`adopt`), and ``hvd.shutdown()`` persists and drops the
#   world's tuners (:func:`end_world`), so the next world's ranks, old
#   and new, start alike;
# - agreed readings: a tuner records a reading only as the group that
#   took it agreed it (:func:`agree_max` after :func:`device_sync`, or
#   :func:`agree_sample`), at a point every member reaches alike, under
#   a key that names the group when it is not the world
#   (:func:`group_key`). The ranks outside a process set never see its
#   readings, and so keep the same state for every key they do see.
#
# The ParameterManager's samples close at the steps of a world
# DistributedOptimizer and at ``hvd.step_end()`` (``FusionManager.
# end_step``), which every rank takes as often, never by counting fusion
# cycles, which a process set's batches add on its members only. The
# capacity harness agrees each step's seconds and load counters over its
# group (``parallel/moe.py``'s ``tune_capacity``).
# ---------------------------------------------------------------------------

_world: dict = {"fingerprint": None, "states": {}, "tuners": []}


def device_sync(device) -> None:
    """Wait for the card's queued work (nothing on the CPU), so a host
    clock read next covers it."""
    import torch

    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def agree_max(values, group=None) -> List[float]:
    """Each of ``values``' maximum over ``group`` (the world when None):
    one float64 all-reduce on the group's CPU backend, or on the card
    where it has none. Every member calls it at the same point."""
    return _agree(values, group, "max")


def agree_sum(values, group=None) -> List[float]:
    """Each of ``values``' sum over ``group``, as :func:`agree_max`
    takes the maximum."""
    return _agree(values, group, "sum")


def _agree(values, group, how: str) -> List[float]:
    import torch
    import torch.distributed as dist

    values = [float(v) for v in values]
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return values
    from torch.distributed.distributed_c10d import _get_object_coll_device

    from . import basics as _basics

    dev = _get_object_coll_device(group)
    t = torch.tensor(values, dtype=torch.float64,
                     device="cpu" if dev == "cpu" else _basics.state().device)
    dist.all_reduce(t, op=(dist.ReduceOp.MAX if how == "max"
                           else dist.ReduceOp.SUM), group=group)
    return t.tolist()


def agree_sample(bytes_: float, seconds: float,
                 device=None) -> Tuple[int, float]:
    """The ParameterManager's ``agree`` hook: the card synchronized (its
    backlog joins the sample's seconds), then the world's maximum of the
    sample's useful bytes and of its seconds."""
    import time

    t0 = time.monotonic()
    device_sync(device)
    b, s = agree_max([bytes_, seconds + time.monotonic() - t0])
    return int(b), s


def group_key(key, group=None) -> tuple:
    """``key`` for a reading taken over ``group``: as it is for the
    world, else with ``"ranks"`` and the group's world ranks appended."""
    import torch.distributed as dist

    key = tuple(key)
    if group is None or not dist.is_initialized():
        return key
    ranks = dist.get_process_group_ranks(group)
    if len(ranks) == dist.get_world_size():
        return key
    return key + ("ranks",) + tuple(ranks)


def start_world(fingerprint: str) -> None:
    """``hvd.init()``'s half, on every rank once the world exists: with
    ``HOROVOD_TUNER_CACHE`` set, world rank 0 reads each tuner's file and
    one object broadcast hands its states to every rank; with none, no
    file and no collective."""
    import torch.distributed as dist

    _world.update(fingerprint=fingerprint, states={}, tuners=[])
    if not tuner_cache_path("wire", fingerprint):
        return
    states = {}
    if dist.get_rank() == 0:
        for name in ("wire", "overlap", "capacity"):
            state = _read_state(name, fingerprint)
            if state is not None:
                states[name] = state
    if dist.get_world_size() > 1:
        box = [states]
        dist.broadcast_object_list(box, src=0)
        states = box[0]
    _world["states"] = states


def adopt(tuner: _GoodputBandit, name: str) -> None:
    """Start ``tuner`` from the world's agreed ``name`` state and have it
    persisted under the world's fingerprint; a process with no world
    reads the cache itself."""
    fingerprint = _world["fingerprint"]
    if fingerprint is None:
        warm_start(tuner, name)
        register_persist_at_exit(tuner, name)
        return
    state = _world["states"].get(name)
    if state is not None:
        _load(tuner, state)
    _world["tuners"].append((tuner, name))
    register_persist_at_exit(tuner, name, fingerprint)


def end_world() -> None:
    """``hvd.shutdown()``'s half: persist the world's tuners (nothing
    without a cache), take them off the exit hook and drop the shared
    ones, so the next world starts from the cache alone."""
    for tuner, name in _world["tuners"]:
        persist(tuner, name, _world["fingerprint"])
    gone = {(id(t), n) for t, n in _world["tuners"]}
    _persist_registry[:] = [r for r in _persist_registry if r[0] not in gone]
    _world.update(fingerprint=None, states={}, tuners=[])
    reset_shared_tuners()
