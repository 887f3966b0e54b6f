"""Non-finite sentinel: the host half of the grad guard's skip step.

The counterpart of ``horovod_tpu/common/guard.py``. One NaN or Inf in a
fused gradient batch poisons every tensor of the batch at the next
update, and since every replica holds the same reduced values, nothing
disagrees loudly. ``DistributedOptimizer(grad_guard=True)`` closes the
hole in two halves:

* the device half (``ops/fusion.py``): one ``all(isfinite)`` over the
  reduced flat buffer of each floating fused batch. The values are
  already reduced, so the flag agrees across ranks with no extra
  collective;
* the host half (this module): the optimizer reads the flags once a
  step, after the reduction it waits on anyway, and on a tripped flag
  skips the inner ``step()`` and calls :meth:`GradGuard.record_skip`,
  which counts ``guard.nonfinite_steps``, logs and, after
  ``HOROVOD_GUARD_MAX_SKIPS`` consecutive skips, latches an escalation.
  :func:`check` raises the latch as
  :class:`~horovod_tpu_torch.common.basics.HorovodInternalError`, the
  exception an elastic loop restores from.

Enable it with ``HOROVOD_GUARD=1`` for every optimizer or
``grad_guard=True`` for one. A skipped step leaves the parameters, the
optimizer state and the error-feedback residuals of the last applied
step as they were.
"""

from __future__ import annotations

import threading
from typing import Optional

from .config import DEFAULT_GUARD_MAX_SKIPS, _env_bool, _env_int
from .logging import get_logger
from .metrics import registry as _metrics

_log = get_logger("guard")


def default_enabled() -> bool:
    """``grad_guard=None``'s value: ``HOROVOD_GUARD``."""
    return _env_bool("HOROVOD_GUARD")


def default_max_skips() -> int:
    """``guard_max_skips=None``'s value: ``HOROVOD_GUARD_MAX_SKIPS``."""
    return _env_int("HOROVOD_GUARD_MAX_SKIPS", DEFAULT_GUARD_MAX_SKIPS)


class GradGuard:
    """The process's skip ledger (one a process, so that its counters
    outlive a shutdown and re-init)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.nonfinite_steps = 0  # skipped updates in all
        self.max_streak = 0  # the longest run of consecutive skips
        self._escalated: Optional[str] = None  # pending escalation

    def record_skip(self, streak: int, step: int, max_skips: int) -> None:
        """Count one skipped update: ``streak`` is the optimizer's count
        of consecutive skips including this one, ``step`` its update
        count. At ``max_skips`` consecutive skips the escalation is
        latched for :func:`check`, not raised here. (The JAX package
        dedupes one callback a shard; the port's optimizer calls this
        once a skip.)"""
        with self._lock:
            self.nonfinite_steps += 1
            self.max_streak = max(self.max_streak, streak)
        _metrics.counter("guard.nonfinite_steps")
        _metrics.gauge("guard.skip_streak", streak)
        _log.warning("non-finite gradients at step %d: update skipped "
                     "(consecutive skips: %d)", step, streak)
        if max_skips > 0 and streak >= max_skips:
            _log.error("guard escalation: %d consecutive non-finite steps "
                       "(HOROVOD_GUARD_MAX_SKIPS=%d)", streak, max_skips)
            with self._lock:
                self._escalated = (
                    f"{streak} consecutive non-finite gradient steps "
                    f"(threshold {max_skips}); training state is suspect "
                    "— restore from the last commit"
                )

    def raise_if_escalated(self) -> None:
        """Raise the latched escalation as ``HorovodInternalError`` and
        clear it, so that the run after a restore starts clean."""
        with self._lock:
            msg, self._escalated = self._escalated, None
        if msg is not None:
            from .basics import HorovodInternalError

            raise HorovodInternalError(f"grad guard: {msg}")

    def status(self) -> dict:
        with self._lock:
            return {
                "nonfinite_steps": self.nonfinite_steps,
                "max_streak": self.max_streak,
                "escalated": self._escalated is not None,
            }


_guard: Optional[GradGuard] = None
_guard_lock = threading.Lock()


def guard() -> GradGuard:
    global _guard
    with _guard_lock:
        if _guard is None:
            _guard = GradGuard()
        return _guard


def _reset_guard() -> None:
    """Test hook: drop the ledger."""
    global _guard
    with _guard_lock:
        _guard = None


def record_skip(streak: int, step: int, max_skips: int) -> None:
    """Count one skipped update on the process's ledger."""
    guard().record_skip(streak, step, max_skips)


def check() -> None:
    """``hvd.guard_check()``: raise the latched escalation, if any, as
    ``HorovodInternalError``. Call it once a step, or at each commit."""
    guard().raise_if_escalated()


def status() -> dict:
    """``hvd.guard_status()``: the skip ledger as a dict."""
    return guard().status()
