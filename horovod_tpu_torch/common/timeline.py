"""Chrome-trace timeline of the eager collectives' lifecycles.

The counterpart of ``horovod_tpu/common/timeline.py`` (the reference's
``timeline.cc``): ``chrome://tracing`` JSON where each tensor is a
"process" row and its lifecycle phases are duration events, with the
same phase names: ``QUEUE`` from enqueue to dispatch, the op
(``ALLREDUCE``, ``ALLGATHER``, ...) around the dispatch, and, for a
batch of more than one tensor, ``MEMCPY_IN_FUSION_BUFFER`` around the
pack and ``MEMCPY_OUT_FUSION_BUFFER`` around the unpack; ``<OP>_DEVICE``
complete events carry the dispatch-to-completion time; ``CYCLE``
instants mark the fusion cycles (``HOROVOD_TIMELINE_MARK_CYCLES``), and
counter tracks the fusion manager's per-cycle gauges and the telemetry
hub's ``telemetry.step``. ``NEGOTIATE_*`` is named for the reference's
phase; the port runs no negotiation round (ROADMAP A3).

Activated by ``HOROVOD_TIMELINE=/path.json`` at ``hvd.init()``, or at
run time by ``hvd.start_timeline()`` / ``hvd.stop_timeline()``. The
writer is pure Python: events gather in memory and ``stop()`` writes the
file (tmp + rename).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List

# Lifecycle phase names, those of the reference's timeline.cc.
NEGOTIATE = "NEGOTIATE_{}"
QUEUE = "QUEUE"
MEMCPY_IN_FUSION_BUFFER = "MEMCPY_IN_FUSION_BUFFER"
COMM = "{}"  # e.g. ALLREDUCE, ALLGATHER: the collective itself
MEMCPY_OUT_FUSION_BUFFER = "MEMCPY_OUT_FUSION_BUFFER"
CYCLE_MARKER = "CYCLE"


class Timeline:
    """Thread-safe Chrome-trace event writer."""

    def __init__(self, path: str, mark_cycles: bool = False):
        self._path = path
        self._mark_cycles = mark_cycles
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._tensor_pids: Dict[str, int] = {}
        self._next_pid = 1
        self._t0 = time.perf_counter()
        self._active = True

    # -- runtime start/stop API (the reference's horovod_start_timeline) --

    def start(self) -> None:
        self._active = True

    def stop(self) -> None:
        """Deactivate AND flush the file: the reference writes the
        timeline incrementally, so after hvd.stop_timeline() the user
        can open the trace immediately — waiting for shutdown() to
        materialize it would silently diverge (timeline.cc).
        start() may still resume recording; close() re-writes with any
        further events.

        The deactivation happens UNDER the emit lock: every emit path
        re-checks ``_active`` after acquiring the lock, so an emitter
        that raced past the cheap pre-check either lands its event
        before the flip (and the final ``_write`` below includes it) or
        observes the flip and drops the event entirely. Without this, a
        counter()/span() blocked on the lock could append its event
        AFTER stop()'s write — present in memory, silently missing from
        the file the user just opened."""
        with self._lock:
            self._active = False
        self._write()

    @property
    def active(self) -> bool:
        return self._active

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _pid(self, tensor_name: str) -> int:
        pid = self._tensor_pids.get(tensor_name)
        if pid is None:
            pid = self._next_pid
            self._next_pid += 1
            self._tensor_pids[tensor_name] = pid
            self._emit(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pid,
                    "args": {"name": tensor_name},
                }
            )
        return pid

    def _emit(self, event: dict) -> None:
        self._events.append(event)

    def begin(self, tensor_name: str, phase: str) -> None:
        if not self._active:
            return
        with self._lock:
            if not self._active:  # lost the race with stop()'s flush
                return
            self._emit(
                {
                    "name": phase,
                    "ph": "B",
                    "pid": self._pid(tensor_name),
                    "ts": self._now_us(),
                }
            )

    def now_us(self) -> float:
        """Current trace-relative timestamp — for callers that measure
        a span themselves and stamp it via :meth:`span`."""
        return self._now_us()

    def span(
        self, tensor_name: str, phase: str, start_us: float, dur_us: float
    ) -> None:
        """Complete ('X') event with EXPLICIT timestamps: the fusion
        manager's device-completion stamp (``ops/fusion.py``). The
        begin/end pairs record when a collective was queued and
        launched; this span carries the launch-to-completion time (the
        work waited on, then the card synchronized), which the manager
        pays only while a timeline is active."""
        if not self._active:
            return
        with self._lock:
            if not self._active:
                return
            self._emit(
                {
                    "name": phase,
                    "ph": "X",
                    "pid": self._pid(tensor_name),
                    "ts": float(start_us),
                    "dur": float(dur_us),
                }
            )

    def end(self, tensor_name: str, phase: str) -> None:
        if not self._active:
            return
        with self._lock:
            if not self._active:
                return
            self._emit(
                {
                    "name": phase,
                    "ph": "E",
                    "pid": self._pid(tensor_name),
                    "ts": self._now_us(),
                }
            )

    def instant(self, tensor_name: str, phase: str) -> None:
        if not self._active:
            return
        with self._lock:
            if not self._active:
                return
            self._emit(
                {
                    "name": phase,
                    "ph": "i",
                    "pid": self._pid(tensor_name),
                    "ts": self._now_us(),
                    "s": "p",
                }
            )

    def counter(self, name: str, value: float) -> None:
        """Chrome-trace counter track (ph "C") — the fusion manager
        feeds per-cycle gauges (bucket pad bytes, fused dispatches)
        here so padding/dispatch cost lines up with the per-tensor
        lifecycle rows in the same trace. The telemetry hub feeds its
        ``telemetry.step`` track through here at every step boundary so
        traces align with StepStats records (common/telemetry.py)."""
        if not self._active:
            return
        with self._lock:
            if not self._active:
                return
            self._emit(
                {
                    "name": name,
                    "ph": "C",
                    "pid": 0,
                    "ts": self._now_us(),
                    "args": {name: value},
                }
            )

    def mark_cycle(self) -> None:
        """One eager fusion-cycle boundary (HOROVOD_TIMELINE_MARK_CYCLES)."""
        if self._mark_cycles and self._active:
            with self._lock:
                if not self._active:
                    return
                self._emit(
                    {
                        "name": CYCLE_MARKER,
                        "ph": "i",
                        "pid": 0,
                        "ts": self._now_us(),
                        "s": "g",
                    }
                )

    def _write(self) -> None:
        with self._lock:
            events = self._events
            tmp = f"{self._path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"traceEvents": events}, f)
            os.replace(tmp, self._path)

    def close(self) -> None:
        self._write()
