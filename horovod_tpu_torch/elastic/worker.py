"""Worker-side elastic machinery: notifications, the heartbeat and the
``run`` wrapper.

The counterpart of ``horovod_tpu/elastic/worker.py`` (the reference's
``horovod/common/elastic.py`` ``run`` and its
``WorkerNotificationService``/``Manager``). The wrapped function loops:
``state.sync()``, then the body; on ``HorovodInternalError`` (a failed
collective, or the grad guard's escalation) the guard's latch is
dropped and the state restored to its last commit; on
``HostsUpdatedInterrupt`` the state is kept. Either way the runtime is
shut down and initialized again in place (``basics`` keeps the TCP
store, so no port is bound twice) and ``state.on_reset()`` runs before
the retry.

``notification_manager.init()`` (``run`` calls it) re-arms what a gang
of the port holds per process: the KV poll latch, the audit's KV
client, the schedule audit's fingerprint and local SGD's per-gang
state, then, under the elastic driver, starts the notification
endpoint, registers it under ``workers.<epoch>/<process id>``,
publishes the restart time (``elastic.restart_ms``, with
``elastic.restart_warm`` and a scale-up's ``serve.scaleup_ms``) and
stamps ``heartbeat/<rank>`` every 10 s
(chaos site ``heartbeat``), the flight recorder's ``{step, step_ms_p50,
last_step_ts}`` beside the stamp (``telemetry.heartbeat_stats()``, empty
before the first recorded step), which the driver's stall inspector
judges stragglers by.

The soft remedies' worker side (``horovod_tpu/elastic/worker.py:
206-340``): :func:`rebalance_weights`/:func:`rebalance_weight` read the
driver's newest micro-batch weights (``HOROVOD_REBALANCE``), cached for
5 s so that a loop may poll them each micro-batch;
:func:`publish_expert_load` puts this rank's expert-load summary (a
``MoEStats``, host floats) in the KV for the driver's ledger, and
:func:`expert_loads` reads every rank's. Outside an elastic job they
degrade to ``{}``, 1.0, ``False`` and ``{}``: a scheduling hint never
takes training down.
"""

from __future__ import annotations

import functools
import os
import socket
import threading
from typing import Optional

from ..common.basics import HorovodInternalError, HostsUpdatedInterrupt
from ..runner.service import BasicService

HEARTBEAT_INTERVAL_S = 10.0


class WorkerNotificationService(BasicService):
    """The RPC endpoint in each worker that the driver pings on a change
    of the hosts."""

    def __init__(self, secret_key: bytes,
                 manager: "WorkerNotificationManager"):
        super().__init__("worker-notification", secret_key)
        self.register("hosts_updated", manager._on_hosts_updated)


class WorkerNotificationManager:
    """Registers with the driver's rendezvous, listens for updates and
    raises them as ``HostsUpdatedInterrupt`` at commit boundaries."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._service: Optional[WorkerNotificationService] = None
        self._updated = threading.Event()
        self._hb_stop: Optional[threading.Event] = None

    def init(self) -> None:
        """Re-arm the per-gang state, then, under the elastic driver
        (its variables set), start the endpoint, register it and start
        the heartbeat. A no-op when the endpoint is up."""
        with self._lock:
            if self._service is not None:
                return
            from .. import local_sgd as _local_sgd
            from ..analysis import sched_audit
            from ..audit import _reset_client as _audit_reset
            from ..common.config import TrainConfig
            from ..runner import rendezvous as _rdv

            _rdv.reset_poll_shutdown()
            _reset_rebalance_cache()
            _audit_reset()
            # a (re)joining gang starts a fresh collective schedule: the
            # old epoch's fingerprint would flag the new gang against
            # itself
            sched_audit.reset()
            _local_sgd.reset()
            cfg = TrainConfig.from_env()
            if not (cfg.rendezvous_addr and cfg.rendezvous_port
                    and cfg.secret_key_hex):
                return
            secret = bytes.fromhex(cfg.secret_key_hex)
            self._service = WorkerNotificationService(secret, self)
            port = self._service.start()
            epoch = str(cfg.elastic_epoch)
            process_id = os.environ.get("HOROVOD_PROCESS_ID", "0")
            hostname = os.environ.get("HOROVOD_HOSTNAME", "")
            if hostname in ("localhost", "127.0.0.1", "",
                            socket.gethostname()):
                hostname = "127.0.0.1"
            client = _rdv.RendezvousClient(
                cfg.rendezvous_addr, cfg.rendezvous_port, secret_key=secret)
            client.put(f"workers.{epoch}", process_id,
                       f"{hostname}:{port}".encode())
            self._publish_restart_ms(client, epoch)
            rank = cfg.rank if cfg.rank is not None else int(process_id)
            stop = threading.Event()
            self._hb_stop = stop

            def _beat():
                from ..common import telemetry as _telemetry
                from ..testing import chaos as _chaos

                while not stop.is_set():
                    try:
                        # ``heartbeat`` site: a late or lost stamp reads
                        # as one late beat, never a dead thread
                        _chaos.inject("heartbeat")
                        _rdv.put_heartbeat(
                            client, rank,
                            stats=_telemetry.heartbeat_stats())
                    except Exception:  # noqa: BLE001 - the job is ending
                        pass
                    stop.wait(HEARTBEAT_INTERVAL_S)

            threading.Thread(target=_beat, name="hvd-heartbeat",
                             daemon=True).start()

    def _publish_restart_ms(self, client, epoch: str) -> None:
        """Close the restart clock the driver stamped at the gang's
        teardown: ``elastic.restart_ms`` is now minus the stamp, for a
        worker of the stamped epoch (a missing or older stamp is a first
        launch); ``elastic.restart_warm`` is 1.0 when a warm standby
        absorbed the restart, and a serve scale-up's restart is also
        ``serve.scaleup_ms``."""
        import time

        from ..common.metrics import registry as _metrics
        from ..runner.rendezvous import read_restart_stamp

        try:
            stamp = read_restart_stamp(client)
        except Exception:  # noqa: BLE001 - best effort
            return
        if stamp is None or str(stamp.get("epoch")) != str(epoch):
            return
        ms = max((time.time() - float(stamp["ts"])) * 1e3, 0.0)
        _metrics.gauge("elastic.restart_ms", ms)
        _metrics.gauge("elastic.restart_warm",
                       1.0 if stamp.get("warm") else 0.0)
        if stamp.get("kind") == "scaleup":
            _metrics.gauge("serve.scaleup_ms", ms)

    def _on_hosts_updated(self, request: dict) -> dict:
        self._updated.set()
        return {}

    def raise_if_updated(self) -> None:
        if self._updated.is_set():
            self._updated.clear()
            raise HostsUpdatedInterrupt()

    def reset(self) -> None:
        self._updated.clear()

    def shutdown(self) -> None:
        with self._lock:
            if self._hb_stop is not None:
                self._hb_stop.set()
                self._hb_stop = None
            if self._service is not None:
                self._service.stop()
                self._service = None
        # a worker tearing down must not poll the driver's KV on
        from ..runner import rendezvous as _rdv

        _rdv.request_poll_shutdown()


notification_manager = WorkerNotificationManager()


# the driver publishes on change only, so a map a few seconds old is
# still good: one KV client an endpoint, and a read at most every 5 s
_REBALANCE_POLL_S = 5.0
_rebalance_cache = {"endpoint": None, "client": None, "ts": 0.0, "map": {}}


def _reset_rebalance_cache() -> None:
    """Drop the cached client and map (a gang restart dials anew)."""
    _rebalance_cache.update(endpoint=None, client=None, ts=0.0, map={})


def _kv_client():
    """This worker's cached KV client, or None outside an elastic or
    launched job."""
    from ..common.config import TrainConfig
    from ..runner.rendezvous import _client_from_cfg

    cfg = TrainConfig.from_env()
    if not (cfg.rendezvous_addr and cfg.rendezvous_port):
        return None
    endpoint = (cfg.rendezvous_addr, cfg.rendezvous_port)
    if (_rebalance_cache["client"] is None
            or _rebalance_cache["endpoint"] != endpoint):
        _rebalance_cache["client"] = _client_from_cfg(cfg)
        _rebalance_cache["endpoint"] = endpoint
    return _rebalance_cache["client"]


def _rank(rank: Optional[int]) -> int:
    return int(os.environ.get("HOROVOD_RANK", "0") or 0) if rank is None \
        else int(rank)


def rebalance_weights(max_age_s: float = _REBALANCE_POLL_S) -> dict:
    """The driver's newest micro-batch weights, ``{rank: weight in (0,
    1]}``, or ``{}`` when none was published (rebalance off, no elastic
    driver, or no straggler stayed flagged). A read is reused for
    ``max_age_s`` (0 reads the KV now)."""
    import time

    now = time.monotonic()
    if (_rebalance_cache["client"] is not None
            and now - _rebalance_cache["ts"] < max_age_s):
        return dict(_rebalance_cache["map"])
    from ..runner.rendezvous import read_rebalance_weights

    client = _kv_client()
    if client is None:
        return {}
    try:
        weights = read_rebalance_weights(client)
    except OSError:
        return dict(_rebalance_cache["map"])  # the KV is going away
    _rebalance_cache.update(ts=now, map=weights)
    return dict(weights)


def rebalance_weight(rank: Optional[int] = None,
                     default: float = 1.0) -> float:
    """This rank's micro-batch weight (1.0 when none is published).
    Scale the local batch by it at a micro-batch boundary::

        w = hvd.elastic.rebalance_weight()
        local_batch = max(1, int(round(base_batch * w)))

    A hint, not a collective contract: the rank still joins every
    collective (a join mask or loss weights keep the gradient
    unbiased when shares differ)."""
    return float(rebalance_weights().get(_rank(rank), default))


def publish_expert_load(expert_tokens, dropped: float, total: float,
                        capacity_factor: Optional[float] = None,
                        rank: Optional[int] = None) -> bool:
    """Put this rank's expert-load summary (a ``MoEStats`` as host
    floats) in the KV for the driver's ``driver.expert_load.*`` gauges.
    Call it at the MoE step harness's cadence. Returns False, silently,
    outside an elastic job or when the KV is going away."""
    from ..runner.rendezvous import put_expert_load

    client = _kv_client()
    if client is None:
        return False
    try:
        put_expert_load(client, _rank(rank), expert_tokens, dropped, total,
                        capacity_factor)
    except OSError:
        return False
    return True


def expert_loads() -> dict:
    """Every rank's newest published expert-load summary, ``{rank:
    payload}``, or ``{}`` outside an elastic job."""
    from ..runner.rendezvous import read_expert_loads

    client = _kv_client()
    if client is None:
        return {}
    try:
        return read_expert_loads(client)
    except OSError:
        return {}


def _reset_runtime() -> None:
    """Leave the world and join it again: the reference's
    ``shutdown(); init()`` boundary, on the device and store of the
    first initialization."""
    from ..common import basics

    dev = basics.state().device
    basics.shutdown()
    basics.init(device=dev)


def run(func):
    """``@hvd.elastic.run``: the retry loop with commit/restore
    semantics. The wrapped function's first argument is a ``State``."""

    @functools.wraps(func)
    def wrapper(state, *args, **kwargs):
        notification_manager.init()
        skip_sync = False
        while True:
            if not skip_sync:
                state.sync()
            try:
                return func(state, *args, **kwargs)
            except HorovodInternalError:
                # a failed collective or the guard's escalation: roll
                # back; the restored state predates the skips, so the
                # retry must not escalate on them again
                from ..common import guard as _guard

                _guard.guard().reset()
                state.restore()
                skip_sync = False
            except HostsUpdatedInterrupt:
                skip_sync = True  # the state is good: keep it
            _reset_runtime()
            notification_manager.reset()
            state.on_reset()

    return wrapper
