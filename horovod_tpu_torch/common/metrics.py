"""Process-wide metrics registry: named counters and gauges.

The serving plane publishes into it (``serve.*``), the bucketed
overlap its schedule (``overlap.*``, :func:`publish_overlap`), and the
frontend's ``/metrics`` route renders a snapshot as Prometheus text
(``common/telemetry.py``). Thread-safe; values are floats.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._values: Dict[str, float] = {}

    def counter(self, name: str, inc: float = 1.0) -> None:
        with self._lock:
            self._values[name] = self._values.get(name, 0.0) + inc

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._values[name] = float(value)

    def update(self, prefix: str, stats: Dict[str, float]) -> None:
        """Publish a dict of gauges under a common prefix."""
        with self._lock:
            for k, v in stats.items():
                self._values[f"{prefix}.{k}"] = float(v)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._values)


registry = MetricsRegistry()


def publish_overlap(n_buckets: int, bucket_bytes: Iterable[int],
                    total_bytes: Optional[int] = None) -> None:
    """Publish the bucketed gradient exchange's schedule
    (``ops/overlap.py``) as the ``overlap.*`` gauges: ``buckets`` and
    ``bucket_bytes_{total,max,min}``. Host integers only, no device
    read."""
    bucket_bytes = list(bucket_bytes)
    registry.update("overlap", {
        "buckets": n_buckets,
        "bucket_bytes_total": (sum(bucket_bytes) if total_bytes is None
                               else total_bytes),
        "bucket_bytes_max": max(bucket_bytes, default=0),
        "bucket_bytes_min": min(bucket_bytes, default=0),
    })
