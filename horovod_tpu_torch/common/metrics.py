"""Process-wide metrics registry: named counters and gauges.

The serving plane publishes into it (``serve.*``) and the frontend's
``/metrics`` route renders a snapshot as Prometheus text
(``common/telemetry.py``). Thread-safe; values are floats.
"""

from __future__ import annotations

import threading
from typing import Dict


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
