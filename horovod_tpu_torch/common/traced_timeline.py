"""The timeline of a whole training step, on ``torch.profiler``.

The counterpart of ``horovod_tpu/common/traced_timeline.py``, which
wraps ``jax.profiler``: here a ``torch.profiler`` session with CPU and,
on a machine with a card, CUDA activity records every operator, every
kernel with its device timestamps, and every collective:

    hvd.start_timeline("/tmp/tl.json", traced=True)
    for i in range(steps):
        with hvd.timeline_step("train", i):   # a record_function range
            loss = step()
    hvd.stop_timeline()                        # writes chrome-trace JSON

``step()`` marks a step with a ``record_function`` range named
``<name>#<step>`` (the reference's NVTX range); ``stop()`` exports the
session and writes one plain ``chrome://tracing`` JSON at the requested
path, with the collectives' spans twinned on a ``horovod collectives``
track and the exposed and hidden collective time as counters.

:func:`collective_overlap_stats` classifies events by name
(:func:`_classify_collective`): the JAX package's names (``all-reduce``,
``psum``, ...), NCCL's device kernels (``ncclDevKernel_AllReduce_*``,
``ncclKernel_*``: by op; ``SendRecv`` is the all-to-all's), and gloo's
exchanges. Gloo runs a collective on the CPU and launches no kernel, so
its exchanges are classified by their host ranges (``gloo:all_reduce``
and the like) and measured against the host's operators on the same
process row. The host ranges that only launch a device collective
(``nccl:*``, ``c10d::*``, ``record_param_comms``) are skipped: the
kernel stands for them. The port's bucket ranges (``hvd.overlap.bucket<b>``,
``optimizer.py``) are counted (``buckets``: the distinct buckets seen)
and the int8 wire's ranges (``WIRE_RANGES``, ``ops/int8_wire.py``:
``hvd.int8_wire.*``) are containers of their kernels and collectives;
neither counts as compute, and neither do the device-side twins of host
ranges (category ``gpu_user_annotation``).
"""

from __future__ import annotations

import json
import os
import re
from contextlib import contextmanager
from typing import Optional

BUCKET_PREFIX = "hvd.overlap.bucket"
WIRE_PREFIX = "hvd.int8_wire."
# events that wrap other work and never count as compute
_CONTAINER_CATS = ("gpu_user_annotation", "user_annotation",
                   "python_function", "cuda_runtime", "cuda_driver",
                   "ac2g", "overhead", "trace")


class TracedTimeline:
    """A ``torch.profiler`` session shaped like the eager Timeline."""

    def __init__(self, path: str):
        self._path = os.path.abspath(path)
        self._prof = None
        # the last session's exposed/hidden collective ledger (set by
        # stop()); the telemetry records read it through overlap.*
        self.last_overlap_stats = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        if self._prof is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        self._prof = prof

    @contextmanager
    def step(self, name: str = "step", step_num: Optional[int] = None):
        """One training step as a ``record_function`` range (the NVTX
        range's stand-in); no cost when the timeline is off."""
        if self._prof is None:
            yield
            return
        from torch.profiler import record_function

        label = name if step_num is None else f"{name}#{step_num}"
        with record_function(label):
            yield

    @contextmanager
    def annotate(self, name: str):
        """A free-form range inside a step."""
        if self._prof is None:
            yield
            return
        from torch.profiler import record_function

        with record_function(name):
            yield

    def stop(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        raw = f"{self._path}.raw.{os.getpid()}.json"
        prof.export_chrome_trace(raw)
        try:
            with open(raw) as f:
                data = json.load(f)
        finally:
            os.unlink(raw)
        self._export(data)

    # close() aliases stop() so teardown treats both timelines alike
    def close(self) -> None:
        self.stop()

    def _export(self, data: dict) -> None:
        """The profiler's trace plus the collectives' twin track and the
        exposed/hidden counters, written at the requested path (tmp +
        rename)."""
        events = list(data.get("traceEvents", []))
        pids = [ev["pid"] for ev in events
                if isinstance(ev.get("pid"), int)]
        synth_pid = max(pids, default=0) + 1
        stats = collective_overlap_stats(events)
        self.last_overlap_stats = stats
        events.extend(_collective_spans(events, synth_pid))
        from . import metrics as _metrics

        if stats["spans"]:
            _metrics.registry.update("overlap", {
                "collective_ms": stats["collective_us"] / 1e3,
                "exposed_collective_ms": stats["exposed_us"] / 1e3,
                "hidden_collective_ms": stats["hidden_us"] / 1e3,
                "collective_spans": stats["spans"],
            })
            last_ts = max((float(ev.get("ts", 0)) + float(ev.get("dur", 0))
                           for ev in events if ev.get("ph") == "X"),
                          default=0)
            for name, val in (
                ("hvd.exposed_collective_ms", stats["exposed_us"] / 1e3),
                ("hvd.hidden_collective_ms", stats["hidden_us"] / 1e3),
            ):
                events.append({"ph": "C", "pid": synth_pid, "name": name,
                               "ts": last_ts,
                               "args": {"ms": round(val, 3)}})
        out = dict(data)
        out["traceEvents"] = events
        tmp = f"{self._path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(out, f)
        os.replace(tmp, self._path)


# Event name -> horovod phase: the JAX package's names (the TPU
# profiler's HLO names and the CPU thunks'), then NCCL's kernels.
_COLLECTIVE_PHASES = (
    ("all-reduce", "ALLREDUCE"),
    ("all_reduce", "ALLREDUCE"),
    ("psum_scatter", "REDUCESCATTER"),  # before psum: longest match
    ("reduce-scatter", "REDUCESCATTER"),
    ("reduce_scatter", "REDUCESCATTER"),
    ("psum", "ALLREDUCE"),
    ("all-gather", "ALLGATHER"),
    ("all_gather", "ALLGATHER"),
    ("all-to-all", "ALLTOALL"),
    ("all_to_all", "ALLTOALL"),
    ("collective-broadcast", "BROADCAST"),
    ("collective-permute", "PPERMUTE"),
    ("ppermute", "PPERMUTE"),
    # NCCL device kernels and gloo's host ranges, by op
    ("allreduce", "ALLREDUCE"),
    ("reducescatter", "REDUCESCATTER"),
    ("allgather", "ALLGATHER"),
    ("alltoall", "ALLTOALL"),
    ("sendrecv", "ALLTOALL"),
    ("broadcast", "BROADCAST"),
)
# needles an operator's name may hold too (aten::broadcast_tensors):
# matched in NCCL's kernels and gloo's ranges only
_LIBRARY_ONLY = ("sendrecv", "broadcast")
# host ranges that launch a device collective: its kernel stands for it
_LAUNCH_PREFIXES = ("nccl:", "c10d::", "record_param_comms")
_BUCKET_RE = re.compile(re.escape(BUCKET_PREFIX) + r"(\d+)")


def _classify_collective(name: str):
    """The shared event classifier: the phase of a collective event;
    ``"skip"`` for async start halves and host launch ranges;
    ``"bucket"`` for the overlap's bucket ranges and ``"wire"`` for the
    int8 wire's (containers); None for compute."""
    low = name.lower()
    if low.startswith("end:") or "-start" in low:
        return "skip"
    if low.startswith(_LAUNCH_PREFIXES):
        return "skip"
    if low.startswith(BUCKET_PREFIX):
        return "bucket"
    if low.startswith(WIRE_PREFIX):
        return "wire"
    library = low.startswith(("nccldevkernel", "ncclkernel", "gloo:"))
    for needle, ph in _COLLECTIVE_PHASES:
        if needle in low and (library or needle not in _LIBRARY_ONLY):
            return ph
    return None


def _interval_overlap(span, intervals):
    """Microseconds of ``span=(t0, t1)`` covered by the UNION of the
    sorted, merged ``intervals``."""
    t0, t1 = span
    covered = 0.0
    for a, b in intervals:
        if b <= t0:
            continue
        if a >= t1:
            break
        covered += min(b, t1) - max(a, t0)
    return covered


def _merge_intervals(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def collective_overlap_stats(events):
    """Exposed-vs-hidden collective time from a trace's spans
    (``traced_timeline.py:249``): per process row (pid), a collective
    span's HIDDEN time is the part of its duration during which some
    compute event on the same pid also runs; the rest is EXPOSED.
    Returns microsecond totals, the span count, and ``buckets``: the
    distinct ``hvd.overlap.bucket<b>`` ranges seen. The bias of the
    estimate (a compute op that waits on the collective cannot overlap
    it) is the same for a monolithic and a bucketed exchange, so their
    difference is honest.

    Containers never count as compute: rows named as step, module or
    scope rows by their ``thread_name`` metadata (the JAX profiler's),
    and events of the annotation and runtime categories (the profiler's
    ``gpu_user_annotation`` twins of host ranges, which span whole
    steps on the device rows)."""
    _container = ("step", "module", "scope", "framework", "source")
    skip_rows = set()
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            tname = str(ev.get("args", {}).get("name", "")).lower()
            if any(n in tname for n in _container):
                skip_rows.add((ev.get("pid", 0), ev.get("tid", 0)))
    per_pid: dict = {}
    buckets = set()
    for ev in events:
        if ev.get("ph") != "X" or not ev.get("dur"):
            continue
        name = str(ev.get("name", ""))
        phase = _classify_collective(name)
        if phase == "bucket":
            m = _BUCKET_RE.match(name.lower())
            if m:
                buckets.add(int(m.group(1)))
            continue
        if phase in ("skip", "wire"):
            continue
        pid = ev.get("pid", 0)
        if phase is None and ((pid, ev.get("tid", 0)) in skip_rows
                              or ev.get("cat") in _CONTAINER_CATS):
            continue
        coll, comp = per_pid.setdefault(pid, ([], []))
        t0 = float(ev.get("ts", 0))
        span = (t0, t0 + float(ev["dur"]))
        (coll if phase is not None else comp).append(span)
    total = hidden = 0.0
    spans = 0
    for coll, comp in per_pid.values():
        if not coll:
            continue
        merged = _merge_intervals(comp)
        for span in coll:
            total += span[1] - span[0]
            hidden += _interval_overlap(span, merged)
            spans += 1
    return {
        "collective_us": total,
        "hidden_us": hidden,
        "exposed_us": total - hidden,
        "spans": spans,
        "buckets": len(buckets),
    }


def _collective_spans(events, pid):
    """Each collective span twinned on the ``horovod collectives`` track
    (``pid``), named ``<PHASE> <event name>``, its row the source pid,
    the source event in ``args``; async start halves contribute none."""
    out = []
    rows = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name = str(ev.get("name", ""))
        phase = _classify_collective(name)
        if phase in (None, "skip", "bucket", "wire"):
            continue
        row = ev.get("pid", 0)
        rows.setdefault(row, 0)
        out.append({
            "ph": "X", "pid": pid, "tid": row, "ts": ev.get("ts", 0),
            "dur": ev.get("dur", 0), "name": f"{phase} {name}",
            "args": {"hlo_op": name, "phase": phase,
                     "src_tid": ev.get("tid", 0)},
        })
    if out:
        out.append({"ph": "M", "pid": pid, "name": "process_name",
                    "args": {"name": "horovod collectives"}})
        for row in rows:
            out.append({"ph": "M", "pid": pid, "tid": row,
                        "name": "thread_name",
                        "args": {"name": f"src pid {row}"}})
    return out
