"""SIGTERM drain for a serving worker.

``serve(handle_sigterm=True)`` installs :class:`GracefulShutdown`: on
SIGTERM it runs every registered drain hook (the serving frontend
registers one that finishes every accepted request), then exits with
143 (128 + SIGTERM), which launchers read as "stopped by the
infrastructure". Hooks run in registration order, and a failing hook
never blocks the next. The JAX package's checkpoint-on-preemption
state and flight-recorder dump belong to the training path and are not
ported yet.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Callable, List

from .common.logging import get_logger

_log = get_logger("preemption")

_EXIT_CODE = 143  # 128 + SIGTERM

_drain_hooks: List[Callable[[], None]] = []
_drain_lock = threading.Lock()


def register_drain(fn: Callable[[], None]) -> Callable[[], None]:
    """Register a shutdown drain hook (returns ``fn``)."""
    with _drain_lock:
        if fn not in _drain_hooks:
            _drain_hooks.append(fn)
    return fn


def unregister_drain(fn: Callable[[], None]) -> None:
    with _drain_lock:
        try:
            _drain_hooks.remove(fn)
        except ValueError:
            pass


def drain_hooks() -> List[Callable[[], None]]:
    with _drain_lock:
        return list(_drain_hooks)


class GracefulShutdown:
    """Context manager: on SIGTERM, run the drain hooks and exit with
    143. Chains the handler installed before it."""

    def __init__(self) -> None:
        self._previous = None

    def __enter__(self) -> "GracefulShutdown":
        self._previous = signal.signal(signal.SIGTERM, self._handle)
        return self

    def _handle(self, signum, frame) -> None:
        try:
            self.drain()
        finally:
            if callable(self._previous):
                self._previous(signum, frame)
            # os._exit: interpreter teardown over a busy device can
            # outlast the grace window; the accepted work is done
            os._exit(_EXIT_CODE)

    def drain(self) -> None:
        """Run every drain hook, one failure never blocking the next."""
        for fn in drain_hooks():
            try:
                fn()
            except Exception:
                _log.exception("drain hook %r failed", fn)

    def __exit__(self, *exc) -> None:
        prev = self._previous
        signal.signal(signal.SIGTERM,
                      prev if prev is not None else signal.SIG_DFL)
        self._previous = None
