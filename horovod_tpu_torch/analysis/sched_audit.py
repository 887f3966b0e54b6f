"""Runtime collective-schedule audit: divergence found before a hang.

A copy of ``horovod_tpu/analysis/sched_audit.py``. A rank whose
collective schedule diverges from the gang's (a tuner that picked
another wire, a skewed fusion composition, a code path taken on one
host only) blocks in a collective the others never enter, and nothing
says so until a heartbeat stall minutes later. This module turns that
into a diagnosed quarantine:

* every fused eager dispatch folds ``(op kind, fused-entry composition,
  wire, pset id)`` into a per-rank ROLLING fingerprint, one SHA-256
  update a dispatch (:class:`~..ops.fusion.FusionManager` calls
  :func:`record` where it launches a batch). The folded key is built as
  the JAX package builds it, so the same dispatches give the same
  fingerprint in both packages;
* on the ``HOROVOD_AUDIT_STEPS`` cadence (:func:`~..audit.audit`
  publishes both), ranks publish ``(step, fingerprint,
  dispatch_count)`` and a bounded ring of the newest per-dispatch
  digests through the rendezvous KV (``runner/rendezvous.py``
  ``put_sched``);
* the elastic driver's ``_poll_audit`` compares the gang's
  fingerprints at the newest quorum step (majority wins, as for the
  parameter digests) and quarantines divergent ranks with reason
  ``sched_divergence``, logging the FIRST divergent dispatch index
  recovered from the rings.

``HOROVOD_SCHED_AUDIT=0`` disables recording and publication. The
folded key holds rank-invariant facts only (shapes, dtypes, wire, pset
id), never rank ids or payload values. The module imports the standard
library only; the driver reads it without torch.
"""

from __future__ import annotations

import hashlib
import threading
from collections import deque
from typing import Dict, Optional, Tuple

from ..common.logging import get_logger

_log = get_logger("sched_audit")

# per-dispatch digests kept for first-divergent-index recovery; the KV
# payload carries the newest _RING entries (bounded: the ring exists to
# LOCATE a divergence, the fingerprint to DETECT it)
_RING = 128
_DIGEST_CHARS = 16  # 64 bits of each per-dispatch digest ride the KV


class ScheduleRecorder:
    """Per-process rolling schedule fingerprint."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hash = hashlib.sha256()
        self._count = 0
        self._ring: "deque[Tuple[int, str]]" = deque(maxlen=_RING)

    def record(
        self,
        kind: str,
        composition,
        wire: Optional[str] = None,
        pset: int = 0,
    ) -> None:
        """Fold one dispatch. ``composition`` is any stable,
        rank-invariant description of the fused batch (entry names +
        shapes + dtypes); it is hashed, never stored."""
        key = repr((str(kind), repr(composition), wire or "fp32", int(pset)))
        entry = hashlib.sha256(key.encode()).hexdigest()[:_DIGEST_CHARS]
        with self._lock:
            self._hash.update(entry.encode())
            self._ring.append((self._count, entry))
            self._count += 1

    @property
    def dispatch_count(self) -> int:
        with self._lock:
            return self._count

    def fingerprint(self) -> str:
        with self._lock:
            return self._hash.copy().hexdigest()

    def snapshot(self) -> dict:
        """The publishable view: rolling fingerprint, total dispatch
        count, and the recent-dispatch ring as ``[[index, digest],...]``."""
        with self._lock:
            return {
                "fingerprint": self._hash.copy().hexdigest(),
                "dispatches": self._count,
                "ring": [[i, d] for i, d in self._ring],
            }

    def reset(self) -> None:
        with self._lock:
            self._hash = hashlib.sha256()
            self._count = 0
            self._ring.clear()


_recorder = ScheduleRecorder()


def recorder() -> ScheduleRecorder:
    return _recorder


def enabled() -> bool:
    """``HOROVOD_SCHED_AUDIT``: the initialized world's snapshot, else
    the environment now (torch is not imported for it)."""
    import sys

    basics = sys.modules.get(__name__.rsplit(".", 2)[0] + ".common.basics")
    if basics is not None and basics.is_initialized():
        return bool(basics.state().config.sched_audit)
    from ..common.config import _env_bool

    return _env_bool("HOROVOD_SCHED_AUDIT", True)


def record(
    kind: str, composition, wire: Optional[str] = None, pset: int = 0
) -> None:
    """Dispatch-path hook (FusionManager): fold one dispatch into the
    process fingerprint. No-op when HOROVOD_SCHED_AUDIT=0."""
    if not enabled():
        return
    _recorder.record(kind, composition, wire=wire, pset=pset)


def reset() -> None:
    """Elastic restart / test hook: a new gang starts a new schedule."""
    _recorder.reset()


def publish(step: int, rank: Optional[int] = None) -> bool:
    """Publish ``(step, fingerprint, dispatch_count, ring)`` to the
    rendezvous KV beside the parameter digests. Called by
    ``hvd.audit`` on the shared cadence; callable directly by loops
    that audit schedules without digesting parameters. Returns False
    when disabled or no rendezvous is configured."""
    if not enabled():
        return False
    from ..common.metrics import registry as _metrics

    if rank is None:
        from ..common import basics

        rank = basics.rank() if basics.is_initialized() else 0
    snap = _recorder.snapshot()
    _metrics.gauge("audit.sched_dispatches", snap["dispatches"])
    _metrics.gauge("audit.sched_last_step", int(step))
    ok = _publish_kv(int(rank), int(step), snap)
    if ok:
        _metrics.counter("audit.sched_published")
    return ok


def _publish_kv(rank: int, step: int, snap: dict) -> bool:
    """Best-effort KV publication through ``audit.py``'s cached client
    (same rendezvous, same failure posture: silence). ``from .. import
    audit`` would give the ``hvd.audit`` function, which the package
    binds over the module's name: import from the module directly."""
    from ..audit import _cached_kv_client
    from ..runner.rendezvous import put_sched

    client = _cached_kv_client()
    if client is None:
        return False
    try:
        put_sched(
            client, rank, step, snap["fingerprint"], snap["dispatches"],
            snap["ring"],
        )
        return True
    except Exception:
        _log.debug("sched publish failed", exc_info=True)
        return False


def find_divergent(
    entries: Dict[int, dict],
) -> Optional[Tuple[int, Tuple[int, ...]]]:
    """Driver-side comparison over ``{rank: {"step", "fingerprint",
    ...}}`` (the shape ``read_sched_fingerprints`` returns): newest
    step reported by >= 2 ranks, majority fingerprint wins, ties break
    toward the lowest rank — the exact arbitration of the parameter
    audit, reused from ``audit.find_divergent``."""
    from ..audit import find_divergent as _fd

    shaped = {}
    for rank, payload in entries.items():
        if isinstance(payload, dict) and "fingerprint" in payload:
            shaped[rank] = {
                "step": payload.get("step"),
                "digest": payload.get("fingerprint"),
            }
    return _fd(shaped)


def first_divergent_index(
    bad: dict, good: dict
) -> Optional[int]:
    """Locate the first dispatch where a divergent rank's ring
    disagrees with a majority rank's: the driver logs this index so a
    postmortem starts at the exact dispatch, not at 'the fingerprints
    differ'. None when the rings no longer overlap (divergence is
    older than the ring) — the dispatch-count delta is the fallback
    breadcrumb."""
    ring_a = {int(i): d for i, d in (bad.get("ring") or [])}
    ring_b = {int(i): d for i, d in (good.get("ring") or [])}
    shared = sorted(set(ring_a) & set(ring_b))
    for idx in shared:
        if ring_a[idx] != ring_b[idx]:
            return idx
    if shared:
        # shared prefix agrees: the divergence is the first dispatch
        # past the common range — one rank ran further than the other
        # (both rings may be full, so compare frontiers, not lengths)
        hi_a, hi_b = max(ring_a), max(ring_b)
        if hi_a != hi_b:
            return min(hi_a, hi_b) + 1
    return None
