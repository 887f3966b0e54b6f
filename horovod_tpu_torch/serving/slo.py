"""SLO instrumentation: TTFT / TPOT summaries for the serving plane.

* **TTFT** (time to first token): submission → the first generated
  token leaving prefill, queue wait included.
* **TPOT** (time per output token): the decode-step wall time each
  later token rode.

Samples land in bounded rings (newest ``capacity``); ``publish()``
pushes p50/p95/count gauges into the registry under ``serve.``, and
``render_prometheus_summaries()`` renders both families as Prometheus
``summary`` types for the frontend's ``/metrics`` route.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List

from ..common.metrics import registry as _metrics
from ..common.telemetry import _percentile

DEFAULT_CAPACITY = 1024


class LatencyRecorder:
    """Bounded-ring p50/p95 for the two serving latency families."""

    FAMILIES = ("ttft_ms", "tpot_ms")

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self._lock = threading.Lock()
        self._rings = {
            fam: collections.deque(maxlen=max(int(capacity), 1))
            for fam in self.FAMILIES
        }
        self._counts = {fam: 0 for fam in self.FAMILIES}
        self._sums = {fam: 0.0 for fam in self.FAMILIES}

    def record_ttft(self, ms: float) -> None:
        self._record("ttft_ms", ms)

    def record_tpot(self, ms: float) -> None:
        self._record("tpot_ms", ms)

    def _record(self, fam: str, ms: float) -> None:
        with self._lock:
            self._rings[fam].append(float(ms))
            self._counts[fam] += 1
            self._sums[fam] += float(ms)

    def summaries(self) -> Dict[str, Dict[str, float]]:
        """``{family: {p50, p95, count, sum}}``: quantiles over the ring,
        count and sum over the recorder's lifetime."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            snap = {
                fam: (sorted(ring), self._counts[fam], self._sums[fam])
                for fam, ring in self._rings.items()
            }
        for fam, (vals, count, total) in snap.items():
            out[fam] = {
                "p50": _percentile(vals, 0.50),
                "p95": _percentile(vals, 0.95),
                "count": count,
                "sum": total,
            }
        return out

    def publish(self) -> None:
        """``serve.ttft_ms_p50`` / ``_p95`` / ``_count`` (and tpot)."""
        stats = {}
        for fam, s in self.summaries().items():
            stats[f"{fam}_p50"] = s["p50"]
            stats[f"{fam}_p95"] = s["p95"]
            stats[f"{fam}_count"] = s["count"]
        _metrics.update("serve", stats)

    def render_prometheus_summaries(self) -> List[str]:
        """Both families as Prometheus ``summary`` text lines."""
        lines: List[str] = []
        helps = {
            "ttft_ms": "Time to first token (submission -> first "
            "generated token, queue wait included), ms.",
            "tpot_ms": "Per-output-token latency (decode-step wall "
            "time per generated token), ms.",
        }
        for fam, s in self.summaries().items():
            name = f"serve_{fam}"
            lines.append(f"# HELP {name} {helps[fam]}")
            lines.append(f"# TYPE {name} summary")
            lines.append(f'{name}{{quantile="0.5"}} {s["p50"]:.10g}')
            lines.append(f'{name}{{quantile="0.95"}} {s["p95"]:.10g}')
            lines.append(f"{name}_sum {s['sum']:.10g}")
            lines.append(f"{name}_count {s['count']:.10g}")
        return lines
