"""Stall detection: the cycle-latency watchdog, heartbeat staleness and
stragglers.

The counterpart of ``horovod_tpu/common/stall_inspector.py`` (the
reference's ``stall_inspector.cc``). It watches three signals:

1. **Cycle-latency watchdog** (in the process): an entry enqueued and
   not waited on past the warning age, a leaked handle or a stalled
   consumer. The fusion manager feeds it (``record_enqueue`` at
   enqueue, ``record_complete`` when the handle's output is made, one
   dict operation each, no device read) and calls :meth:`check` once a
   fusion cycle; the telemetry hub calls it at every step boundary.
2. **Heartbeat staleness** (across processes): the elastic workers
   stamp ``heartbeat/<rank>`` in the rendezvous KV; the driver feeds the
   stamps in through :meth:`record_heartbeat` and ``check()`` warns when
   a rank goes silent past the warning age.
3. **Stragglers** (across ranks): the heartbeats carry ``{step,
   step_ms_p50, last_step_ts}`` from each worker's flight recorder
   (``common/telemetry.py``), so :meth:`straggler_ranks` tells a SLOW
   rank (a step-time p50 past ``HOROVOD_STRAGGLER_FACTOR`` times the
   gang's median, or a step counter lagging the median by more than
   ``DEFAULT_STRAGGLER_LAG_STEPS``) from a SILENT one, and
   :meth:`quarantine_candidates` applies the driver's hysteresis.

Past ``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS`` (0: never) a pending entry
or a silent rank raises ``HorovodInternalError`` from ``check()``, the
exception the elastic contract restores from. ``check()`` also
publishes the ``stall.*`` gauges (``stall.pending``,
``stall.stale_ranks``, ``stall.straggler.*``) through the metrics
registry.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List, Optional

from .exceptions import HorovodInternalError
from .logging import get_logger

logger = get_logger("stall")

DEFAULT_STRAGGLER_FACTOR = 3.0
# step-counter lag (vs the gang median) that flags a straggler even
# when its per-step time looks healthy — catches a rank that is
# silently re-doing work (e.g. recompiling every step)
DEFAULT_STRAGGLER_LAG_STEPS = 25


class StallInspector:
    def __init__(
        self,
        warning_seconds: float = 60.0,
        shutdown_seconds: float = 0.0,
        straggler_factor: float = DEFAULT_STRAGGLER_FACTOR,
    ):
        self.warning_seconds = warning_seconds
        self.shutdown_seconds = shutdown_seconds
        self.straggler_factor = float(straggler_factor)
        self._pending: Dict[str, float] = {}
        self._warned: set = set()
        self._heartbeats: Dict[int, float] = {}
        self._hb_stats: Dict[int, dict] = {}
        self._hb_warned: set = set()
        self._straggler_warned: set = set()
        # hysteresis for the self-healing driver: rank -> number of
        # consecutive FRESH heartbeat observations it has been flagged
        # a straggler (one blip must not quarantine a host; K-in-a-row
        # does). Streaks advance at most once per new heartbeat stamp —
        # the driver polls far more often than workers beat (1s vs
        # 10s), and re-judging the same stale payload K times would
        # turn one noisy sample into a quarantine.
        self._straggler_streaks: Dict[int, int] = {}
        self._streak_stamp: Dict[int, Optional[float]] = {}

    def record_enqueue(self, name: str) -> None:
        self._pending.setdefault(name, time.monotonic())

    def record_complete(self, name: str) -> None:
        self._pending.pop(name, None)
        self._warned.discard(name)

    def reset_heartbeats(self) -> None:
        """Forget all liveness state — call when the worker set
        changes (gang restart): departed ranks must not read as
        stalled."""
        self._heartbeats.clear()
        self._hb_stats.clear()
        self._hb_warned.clear()
        self._straggler_warned.clear()
        self._straggler_streaks.clear()
        self._streak_stamp.clear()

    def record_heartbeat(
        self,
        rank: int,
        ts: float = None,
        step: Optional[int] = None,
        step_ms_p50: Optional[float] = None,
        last_step_ts: Optional[float] = None,
    ) -> None:
        """Feed a worker heartbeat (driver side of signal #2). ``ts`` is
        a unix epoch stamp (``time.time()`` — the domain
        ``runner.rendezvous.put_heartbeat`` writes, chosen because the
        stamps cross machines); defaults to now. The optional telemetry
        fields are the straggler-ledger payload the worker piggybacks
        from its flight recorder (signal #3); absent fields keep the
        rank's previous values."""
        rank = int(rank)
        self._heartbeats[rank] = time.time() if ts is None else float(ts)
        self._hb_warned.discard(rank)
        stats = self._hb_stats.setdefault(rank, {})
        if step is not None:
            stats["step"] = int(step)
        if step_ms_p50 is not None:
            stats["step_ms_p50"] = float(step_ms_p50)
        if last_step_ts is not None:
            stats["last_step_ts"] = float(last_step_ts)

    def stale_ranks(self, now: float = None):
        """Ranks whose last heartbeat is older than warning_seconds.
        ``now`` is unix epoch (heartbeats cross machines; monotonic
        clocks don't)."""
        if not self._heartbeats:
            return []
        now = time.time() if now is None else now
        return sorted(
            r
            for r, t in self._heartbeats.items()
            if now - t > self.warning_seconds
        )

    def straggler_ranks(
        self,
        factor: Optional[float] = None,
        lag_steps: int = DEFAULT_STRAGGLER_LAG_STEPS,
    ) -> List[int]:
        """Ranks that are SLOW rather than silent — the upgrade over
        :meth:`stale_ranks`, possible because heartbeats now carry each
        worker's step telemetry. A rank is a straggler when:

        * its ``step_ms_p50`` exceeds ``factor`` × the gang median
          (``factor`` defaults to ``HOROVOD_STRAGGLER_FACTOR``), or
        * its step counter trails the gang's median step by more than
          ``lag_steps`` — it heartbeats fine but isn't making progress.

        Needs at least two reporting ranks (a median of one is the rank
        itself); returns a sorted rank list."""
        factor = self.straggler_factor if factor is None else float(factor)
        out = set()
        p50s = {
            r: s["step_ms_p50"]
            for r, s in self._hb_stats.items()
            if s.get("step_ms_p50", 0) > 0
        }
        if len(p50s) >= 2:
            median = statistics.median(p50s.values())
            if median > 0:
                out.update(
                    r for r, v in p50s.items() if v > factor * median
                )
        steps = {
            r: s["step"]
            for r, s in self._hb_stats.items()
            if s.get("step") is not None
        }
        if len(steps) >= 2 and lag_steps > 0:
            median_step = statistics.median(steps.values())
            out.update(
                r for r, v in steps.items() if median_step - v > lag_steps
            )
        return sorted(out)

    def heartbeat_stats(self) -> Dict[int, dict]:
        """Driver-side view of the per-rank straggler ledger."""
        return {r: dict(s) for r, s in self._hb_stats.items()}

    def straggler_streaks(self) -> Dict[int, int]:
        """rank -> consecutive fresh-heartbeat observations flagged."""
        return dict(self._straggler_streaks)

    def quarantine_candidates(self, polls: int) -> List[int]:
        """Ranks a straggler for at least ``polls`` CONSECUTIVE fresh
        heartbeat observations — the hysteresis gate the self-healing
        elastic driver uses before quarantining a host (one noisy
        sample must not cost a gang restart, however often the driver
        re-reads it). Empty when ``polls`` <= 0."""
        if polls <= 0:
            return []
        return sorted(
            r for r, n in self._straggler_streaks.items() if n >= polls
        )

    def _publish(self, stale, stragglers) -> None:
        """Registry gauges so stalls show up in metrics dumps and on
        the /metrics scrape, not only in logs. p50s are re-read so the
        worst-ratio gauge tracks the same data straggler_ranks used."""
        from .metrics import registry as _metrics

        p50s = [
            s["step_ms_p50"]
            for s in self._hb_stats.values()
            if s.get("step_ms_p50", 0) > 0
        ]
        worst_ratio = 0.0
        if len(p50s) >= 2:
            median = statistics.median(p50s)
            if median > 0:
                worst_ratio = max(p50s) / median
        _metrics.update(
            "stall",
            {
                "pending": len(self._pending),
                "stale_ranks": len(stale),
                "straggler.count": len(stragglers),
                "straggler.factor": self.straggler_factor,
                "straggler.worst_ratio": worst_ratio,
                "straggler.max_streak": max(
                    self._straggler_streaks.values(), default=0
                ),
            },
        )

    def check(self) -> None:
        """Called once a fusion cycle and at every telemetry step close
        (the reference checks once a background-loop cycle,
        ``stall_inspector.cc::CheckForStalledTensors``)."""
        now = time.monotonic()
        for name, t in list(self._pending.items()):
            age = now - t
            if (
                self.shutdown_seconds > 0
                and age > self.shutdown_seconds
            ):
                raise HorovodInternalError(
                    f"collective '{name}' stalled for {age:.0f}s "
                    f"(> HOROVOD_STALL_SHUTDOWN_TIME_SECONDS)"
                )
            if age > self.warning_seconds and name not in self._warned:
                self._warned.add(name)
                logger.warning(
                    "One or more collectives submitted but not completed "
                    "for %.0fs: %s. A consumer may be stalled.",
                    age,
                    name,
                )
        wall = time.time()  # heartbeats live in the epoch domain
        stale = self.stale_ranks(wall)
        stragglers = self.straggler_ranks()
        # hysteresis ledger: streaks grow while a rank STAYS flagged
        # across fresh heartbeat stamps and reset the moment it
        # recovers; an unchanged stamp (driver polls outpace worker
        # beats) neither grows nor resets the streak
        streaks: Dict[int, int] = {}
        stamps: Dict[int, Optional[float]] = {}
        for r in stragglers:
            stamp = self._heartbeats.get(r)
            prev = self._straggler_streaks.get(r, 0)
            if prev == 0 or stamp is None or stamp != self._streak_stamp.get(r):
                streaks[r] = prev + 1
                stamps[r] = stamp
            else:
                streaks[r] = prev
                stamps[r] = self._streak_stamp.get(r)
        self._straggler_streaks = streaks
        self._streak_stamp = stamps
        self._publish(stale, stragglers)
        for rank in stragglers:
            if rank not in self._straggler_warned:
                self._straggler_warned.add(rank)
                stats = self._hb_stats.get(rank, {})
                logger.warning(
                    "Rank %d is straggling: step_ms_p50=%.1f step=%s "
                    "(gang flags ranks past %.1fx the median). The "
                    "worker is alive but slow.",
                    rank,
                    stats.get("step_ms_p50", 0.0),
                    stats.get("step", "?"),
                    self.straggler_factor,
                )
        # a rank that left the straggler set may warn again on relapse
        self._straggler_warned.intersection_update(stragglers)
        for rank in stale:
            age = wall - self._heartbeats[rank]
            # Shutdown escalation re-checks EVERY cycle (like the
            # pending-entry path) — it must fire even after the
            # one-time warning already did.
            if (
                self.shutdown_seconds > 0
                and age > self.shutdown_seconds
            ):
                raise HorovodInternalError(
                    f"rank {rank} heartbeat silent for {age:.0f}s "
                    f"(> HOROVOD_STALL_SHUTDOWN_TIME_SECONDS)"
                )
            if rank not in self._hb_warned:
                self._hb_warned.add(rank)
                logger.warning(
                    "Rank %d has not heartbeat for %.0fs; the worker "
                    "may be stalled or partitioned.",
                    rank,
                    age,
                )
