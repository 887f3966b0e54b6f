"""Percentiles and the Prometheus text rendering of the registry.

The parts of the JAX package's telemetry module the serving plane uses:
the nearest-rank percentile behind the TTFT/TPOT summaries and the
``/metrics`` exposition of the registry. The training step-time flight
recorder (and its ``telemetry_step_ms`` summary) is not ported yet.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
    return sorted_vals[idx]


def _prom_name(name: str) -> str:
    out = _PROM_BAD.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return "hvd_" + out


def _prom_value(v: float) -> Optional[str]:
    v = float(v)
    if v != v or v in (float("inf"), float("-inf")):
        return None  # exposition must not carry NaN/Inf from gauges
    return f"{v:.10g}"


def render_prometheus(snapshot: Dict[str, float]) -> str:
    """Prometheus text exposition v0.0.4: every registry metric as a
    ``hvd_``-prefixed gauge with HELP/TYPE lines."""
    lines = []
    seen = set()
    for name in sorted(snapshot):
        prom = _prom_name(name)
        if prom in seen:  # two dotted names collapsing onto one
            continue
        val = _prom_value(snapshot[name])
        if val is None:
            continue
        seen.add(prom)
        lines.append(f"# HELP {prom} horovod_tpu_torch metric {name!r}")
        lines.append(f"# TYPE {prom} gauge")
        lines.append(f"{prom} {val}")
    return "\n".join(lines) + "\n"
