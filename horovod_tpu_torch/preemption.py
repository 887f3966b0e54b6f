"""Preemption: turn the grace window of a SIGTERM into a durable
checkpoint, and drain a serving worker.

The counterpart of ``horovod_tpu/preemption.py``. A preempted machine
gets an advance signal (SIGTERM, then some seconds of grace):

    state = DurableTorchState(checkpoint_dir=..., model=..., optimizer=...)
    with hvd.preemption.GracefulShutdown(state):
        train(state)   # on SIGTERM: drain, persist, exit(143)

or cooperatively:

    handler = hvd.preemption.PreemptionHandler()
    for step in range(...):
        ...
        if handler.should_stop():   # the signal came: wind down here
            state.commit(); state.wait_until_finished(); break

After the restart, ``resume_latest()`` on a fresh ``DurableTorchState``
continues from the persisted step.

SIGTERM's order (held by ``tests/test_torch_preemption.py``): the
registered drains (the instance's, then the module's, each in
registration order; the serving frontend registers one that finishes
every accepted request; a failing hook never blocks the next), the
chaos site ``preemption.drain``, then the state's ``persist()`` and
``wait_until_finished()``, then ``os._exit(143)`` (128 + SIGTERM, which
launchers read as stopped by the infrastructure). Between the drains and
the chaos site the flight recorder's ring is dumped
(``telemetry.hub().dump()``: a bounded tmp + rename write, to
``HOROVOD_FLIGHT_RECORDER``, nothing without it), so a failed checkpoint
still leaves the last steps on disk. The persist is per rank: rank 0's
commit waits for the other ranks' files at most ``persist_timeout``
seconds and starts no collective, so a gang with a dead member keeps
its grace window (the step then stays uncommitted).

``state`` is passed explicitly: ``GracefulShutdown(None)`` is a
stateless shutdown (a serving worker: the drains are its work), and
``GracefulShutdown()`` raises.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Callable, Iterable, List, Optional

from .common.logging import get_logger

_log = get_logger("preemption")

_EXIT_CODE = 143  # 128 + SIGTERM
_DEFAULT_SIGNALS = (signal.SIGTERM,)

_drain_hooks: List[Callable[[], None]] = []
_drain_lock = threading.Lock()


def register_drain(fn: Callable[[], None]) -> Callable[[], None]:
    """Register a shutdown drain hook (returns ``fn``). Hooks run first
    on SIGTERM: drains, then the checkpoint."""
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


class PreemptionHandler:
    """Latches preemption signals; query with :meth:`should_stop`.

    Chains any previously-installed handler, so stacking on top of a
    launcher's own SIGTERM handling keeps both behaviors.
    """

    def __init__(
        self,
        signals: Iterable[int] = _DEFAULT_SIGNALS,
        on_preempt: Optional[Callable[[], None]] = None,
    ) -> None:
        self._event = threading.Event()
        self._on_preempt = on_preempt
        self._previous = {}
        for sig in signals:
            self._previous[sig] = signal.signal(sig, self._handle)

    def _handle(self, signum, frame) -> None:
        self._event.set()
        # unstick any KV poll first: a preempted worker waiting on the
        # rendezvous notices the shutdown at its next poll
        try:
            from .runner import rendezvous as _rdv

            _rdv.request_poll_shutdown()
        except Exception:
            pass
        if self._on_preempt is not None:
            self._on_preempt()
        prev = self._previous.get(signum)
        if callable(prev):
            prev(signum, frame)

    def should_stop(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def uninstall(self) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
        self._previous.clear()


class GracefulShutdown:
    """Context manager: on preemption, drain, persist the state, exit
    with ``exit_code`` (143). ``state`` needs ``persist()`` (or
    ``commit()``) and optionally ``wait_until_finished()``; ``None``
    skips the durable step."""

    _STATE_REQUIRED = object()

    def __init__(self, state=_STATE_REQUIRED,
                 signals: Iterable[int] = _DEFAULT_SIGNALS,
                 exit_code: int = _EXIT_CODE) -> None:
        if state is self._STATE_REQUIRED:
            raise TypeError(
                "GracefulShutdown requires a state argument: pass the "
                "DurableTorchState to persist on SIGTERM, or an explicit "
                "None for a stateless (drain-hooks-only) shutdown"
            )
        self._state = state
        self._signals = tuple(signals)
        self._exit_code = exit_code
        self._handler: Optional[PreemptionHandler] = None
        self._drains: List[Callable[[], None]] = []

    def register_drain(self, fn: Callable[[], None]) -> Callable[[], None]:
        """An instance's drain hook: runs before the module's hooks and
        before the checkpoint."""
        if fn not in self._drains:
            self._drains.append(fn)
        return fn

    def __enter__(self) -> "GracefulShutdown":
        self._handler = PreemptionHandler(
            signals=self._signals, on_preempt=self._drain_and_exit)
        return self

    def _drain_and_exit(self) -> None:
        try:
            self.drain()
        finally:
            # os._exit: a signal may land in a collective, and teardown
            # over a wedged device can outlast the grace window
            os._exit(self._exit_code)

    def drain(self) -> None:
        """The shutdown sequence without the exit: every drain hook (one
        failure never blocking the next), the flight recorder's dump, the
        ``preemption.drain`` chaos site, then the state's persist."""
        for fn in list(self._drains) + drain_hooks():
            try:
                fn()
            except Exception:  # noqa: BLE001
                _log.exception("drain hook %r failed", fn)
        try:
            from .common import telemetry as _telemetry

            _telemetry.hub().dump()  # the flight recorder, before the save
        except Exception:  # noqa: BLE001 - the checkpoint comes first
            pass
        try:
            from .testing import chaos as _chaos

            # the kill window between the drains and the persist: a
            # SIGKILL here must never leave a step a restore trusts
            _chaos.inject("preemption.drain")
        except Exception:  # noqa: BLE001 - transport faults do not fit
            pass
        if self._state is None:
            return
        persist = getattr(self._state, "persist", None)
        if persist is not None:
            persist()
        else:
            self._state.commit()
        wait = getattr(self._state, "wait_until_finished", None)
        if wait is not None:
            wait()

    def __exit__(self, *exc) -> None:
        if self._handler is not None:
            self._handler.uninstall()
            self._handler = None
