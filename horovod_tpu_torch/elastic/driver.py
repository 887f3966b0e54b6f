"""The elastic driver: membership, gang (re)launch, notification.

The core of ``horovod_tpu/elastic/driver.py`` (the reference's
``horovod/runner/elastic/driver.py``): poll discovery every interval,
compute the slot assignment within ``[min_np, max_np]``, launch the gang
with ``runner.launch.worker_envs`` (one process a slot, the epoch in
``HOROVOD_ELASTIC_EPOCH``, a fresh coordinator port an epoch on the one
HTTP KV server that lives as long as the job), collect exit codes,
blacklist the host of a failed worker and publish the dead set, notify
the live workers of a change of hosts, and restart the gang (``_reset``,
bounded by ``reset_limit``; ``_wait_for_capacity`` below ``min_np``).
Every change of the world is a gang restart, as in the JAX package:
the workers resume from their last durable commit. ``_poll_audit``
compares the gang's published parameter digests (``audit.py``) and
restarts the gang on a divergence, quarantining the divergent hosts
when the capacity allows.

``_poll_heartbeats`` relays the gang's heartbeats, with the flight
recorder's ``{step, step_ms_p50, last_step_ts}`` beside them, into the
driver's :class:`~..common.stall_inspector.StallInspector` once an
interval: silence past ``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS`` escalates
to a gang restart, and ``_maybe_quarantine`` blacklists the host of a
rank flagged a straggler for ``HOROVOD_STRAGGLER_QUARANTINE_POLLS``
consecutive fresh heartbeats (default 3, as in the JAX driver; 0
observes only) and restarts the gang without it, unless that leaves
less than ``min_np``. ``driver.quarantined_hosts`` counts them.

Below the quarantine, the same poll runs the soft remedies
(``driver.py:857-916``, ``734-797``): with ``HOROVOD_REBALANCE=1``,
``_maybe_rebalance`` gives a rank flagged for 2 consecutive fresh
heartbeats a micro-batch weight of the gang's median p50 over its p50,
clamped to [0.25, 1.0], publishes the map in the KV on a change
(``hvd.elastic.rebalance_weight()`` reads it) and resets it on
recovery (``driver.rebalance.active``/``.updates``);
``_poll_expert_loads`` sums the gang's published expert loads into
``driver.expert_load.{ranks,imbalance,drop_rate}``, a rank's entry
counting while its stamp advances, judged on the driver's monotonic
clock; ``_poll_serve_capacity`` sums a serving fleet's announcements by
role into ``driver.serve.{role}.{workers,free_slots,free_pages}``,
guarded the same way (a blob with no ``role`` counts as unified).

**Warm standby** (``HOROVOD_WARM_STANDBY`` = N > 0, ``driver.py:208-545``):
``compute_assignment`` holds up to N hosts out of the gang while the rest
still clears ``min_np`` (``_reserve_standbys``: existing reservations
first, then from the tail of the sorted host list; a released host is
never reserved again), and ``_sync_standby_warmers`` launches a warmer
(``python -m horovod_tpu_torch.elastic.standby``) on each newly reserved
local host, which stages the torch process's cold-start costs ahead of
time and announces itself in the KV's ``standby`` scope. A failed or
quarantined host releases one standby (``_release_standby``, an armed
one first) into the pool, so that the restart that follows swaps it in
instead of shrinking the world; a serve role whose live workers have no
free slot and no free page left (``_maybe_scale_up``, fed by
``_poll_serve_capacity``) releases one and restarts the gang grown
(reason ``serve scaleup``), at most once a staleness window. The restart
stamp records whether a standby absorbed the restart (``warm``) and its
kind, which the next epoch's workers publish as
``elastic.restart_warm`` and ``serve.scaleup_ms``. The launcher imports
no torch: the warmer imports it, in its own process.

**The schedule audit** (``HOROVOD_SCHED_AUDIT``, ``driver.py:1060-1100``):
``_poll_audit`` first compares the gang's published collective-schedule
fingerprints (``analysis/sched_audit.py``) at the newest quorum step; a
divergent rank's host is quarantined and the gang restarts with reason
``sched_divergence``, the log naming the first divergent dispatch index
recovered from the published rings.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

from ..common.logging import get_logger
from ..runner.hosts import HostInfo, SlotInfo, assign_slots
from ..runner.launch import _free_port, _is_local, worker_envs
from ..runner.rendezvous import RendezvousServer
from ..runner.secret import make_secret_key
from ..runner.service import BasicClient
from .discovery import HostDiscovery, HostManager

_log = get_logger("elastic")

# consecutive fresh-heartbeat flags before a rank's slice is down-weighted
# (HOROVOD_REBALANCE), below the quarantine's: shed work first, restart
# the gang only if the rank stays flagged
_REBALANCE_STREAK = 2

# an expert-load entry (or a serve announcement) whose stamp stops
# advancing leaves the driver's gauges after this many seconds of the
# driver's monotonic clock
_EXPERT_LOAD_STALE_S = 60.0


class SlotAssignment:
    """One epoch's placement: which ranks on which hosts."""

    def __init__(self, epoch: int, slots: Sequence[SlotInfo]) -> None:
        self.epoch = epoch
        self.slots = list(slots)

    @property
    def world_size(self) -> int:
        return len(self.slots)

    @property
    def hostnames(self) -> List[str]:
        return sorted({s.hostname for s in self.slots})


class ElasticDriver:
    """Supervises an elastic job: a synchronous core (every transition
    callable from a test with a fake discovery, the reference's own test
    strategy) driven by :meth:`run`."""

    def __init__(
        self,
        discovery: HostDiscovery,
        command: Sequence[str],
        min_np: int,
        max_np: Optional[int] = None,
        slots_per_host: Optional[int] = None,
        discovery_interval: Optional[float] = None,
        placement: str = "auto",
        start_timeout: float = 600.0,
        output_filename: Optional[str] = None,
        reset_limit: Optional[int] = None,
        extra_env: Optional[Dict[str, str]] = None,
        ssh_port: Optional[int] = None,
        verbose: bool = False,
    ) -> None:
        from ..common.config import (
            DEFAULT_ELASTIC_DISCOVERY_INTERVAL,
            TrainConfig,
            _env_float,
        )
        from ..common.stall_inspector import StallInspector

        cfg = TrainConfig.from_env()
        # the gang's heartbeats and straggler ledger (the reference's
        # "ranks absent" report, rebuilt on the rendezvous KV)
        self.stall_inspector = StallInspector(
            warning_seconds=cfg.stall_warning_seconds,
            shutdown_seconds=cfg.stall_shutdown_seconds,
            straggler_factor=cfg.straggler_factor,
        )
        self._quarantine_polls = cfg.straggler_quarantine_polls
        self._last_stragglers: tuple = ()
        self._rebalance = cfg.rebalance
        self._rebalance_weights: Dict[int, float] = {}
        from ..common.metrics import registry as _metrics

        _metrics.configure_export()  # HOROVOD_METRICS_FILE, if set
        if self._rebalance:
            _metrics.gauge("driver.rebalance.active", 0)
        # rank -> (its last published stamp, the driver's clock when the
        # stamp last advanced)
        self._expert_load_seen: Dict[int, tuple] = {}
        # the same for the serving fleet's capacity announcements
        self._serve_cap_seen: Dict[int, tuple] = {}
        self._clock = time.monotonic
        if placement == "per-host":
            raise ValueError(
                "--placement per-host: torch has no process that drives "
                "several cards; the port launches one process a slot")
        self.host_manager = HostManager(discovery)
        self._command = list(command)
        self._min_np = min_np
        self._max_np = max_np or 2**31
        self._slots_per_host = slots_per_host
        self._interval = (
            _env_float("HOROVOD_ELASTIC_DISCOVERY_INTERVAL",
                       DEFAULT_ELASTIC_DISCOVERY_INTERVAL)
            if discovery_interval is None else float(discovery_interval))
        self._start_timeout = start_timeout
        self._output_filename = output_filename
        self._reset_limit = reset_limit
        self._extra_env = dict(extra_env or {})
        self._ssh_port = ssh_port
        self._verbose = verbose
        self._epoch = 0
        self._resets = 0
        self._secret = make_secret_key()
        self._server: Optional[RendezvousServer] = None
        self._procs: List[subprocess.Popen] = []
        self._blocks: List[Dict[str, str]] = []
        self._files: list = []
        self._assignment: Optional[SlotAssignment] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._last_hb_poll = 0.0
        self._last_audit_poll = 0.0
        self._last_audit_step: Optional[int] = None
        self._last_sched_step: Optional[int] = None
        self._quarantine_capacity_warned = False
        # warm standby (module docstring): hosts held out of the gang,
        # their warmers, and the ones released into the pool
        self._warm_standby = cfg.warm_standby
        self._standby_current: set = set()
        self._standby_released: set = set()
        self._standby_warmers: Dict[str, Optional[subprocess.Popen]] = {}
        self._standby_swapins = 0
        self._scaleup_reason: Optional[str] = None
        self._last_scaleup = -float("inf")

    # ---------------------------------------------------------- planning

    def compute_assignment(
            self, epoch: Optional[int] = None) -> Optional[SlotAssignment]:
        """The slot assignment for the current hosts, or None below
        min_np."""
        hosts = self.host_manager.current_hosts()
        if self._slots_per_host is not None:
            hosts = [HostInfo(h.hostname, self._slots_per_host)
                     for h in hosts]
        reserved = self._reserve_standbys(hosts)
        active = [h for h in hosts if h.hostname not in reserved]
        capacity = sum(h.slots for h in active)
        if capacity < self._min_np:
            return None
        self._standby_current = reserved
        return SlotAssignment(
            self._epoch if epoch is None else epoch,
            assign_slots(active, min(capacity, self._max_np)),
        )

    def _reserve_standbys(self, hosts) -> set:
        """Up to ``HOROVOD_WARM_STANDBY`` hosts held out of the
        assignment, only while the rest still clears min_np. Existing
        reservations come first (a warmer mid-staging is not churned
        away), then new ones from the tail of the sorted host list (rank
        0's host stays put); a released host is never reserved again."""
        if self._warm_standby <= 0:
            return set()
        by_name = {h.hostname: h for h in hosts}
        candidates = [hn for hn in self._standby_warmers
                      if hn in by_name and hn not in self._standby_released]
        candidates += [hn for hn in sorted(by_name, reverse=True)
                       if hn not in candidates
                       and hn not in self._standby_released]
        capacity = sum(h.slots for h in hosts)
        reserved: set = set()
        for hn in candidates:
            if len(reserved) >= self._warm_standby:
                break
            if capacity - by_name[hn].slots >= self._min_np:
                reserved.add(hn)
                capacity -= by_name[hn].slots
        return reserved

    def handle_host_failure(self, hostname: str) -> None:
        """Blacklist the host of a failed worker, publish the dead set,
        and release a standby to take its place in the next gang."""
        self.host_manager.blacklist(hostname)
        self._publish_dead_hosts()
        self._release_standby(f"host {hostname} failed")

    def _publish_dead_hosts(self) -> None:
        """The blacklist into the KV's ``serve`` scope (the serving
        router's dead-set channel); best effort."""
        if self._server is None:
            return
        try:
            from ..runner.rendezvous import put_dead_hosts

            dead = self.host_manager.blacklisted
            with self._lock:
                ranks = sorted(int(b["HOROVOD_RANK"]) for b in self._blocks
                               if b.get("HOROVOD_HOSTNAME") in dead)
            put_dead_hosts(self._server.store, dead, ranks=ranks)
        except Exception as e:  # noqa: BLE001 - observability only
            _log.debug("dead-host publication failed: %s", e)

    # ---------------------------------------------------------- gang ops

    def _rendezvous(self) -> RendezvousServer:
        if self._server is None:
            self._server = RendezvousServer(secret_key=self._secret)
            self._server.start()
        return self._server

    def _launch_gang(self, assignment: SlotAssignment) -> None:
        _log.info("launching gang epoch=%d world=%d hosts=%s",
                  assignment.epoch, assignment.world_size,
                  ",".join(assignment.hostnames))
        server = self._rendezvous()
        from ..runner.rendezvous import (AUDIT_SCOPE, HEARTBEAT_SCOPE,
                                         SCHED_SCOPE)

        self.stall_inspector.reset_heartbeats()
        for scope in (HEARTBEAT_SCOPE, AUDIT_SCOPE, SCHED_SCOPE):
            server.store.drop_scope(scope)
        self._last_audit_step = None
        self._last_sched_step = None
        local = all(_is_local(h) for h in assignment.hostnames)
        addr = "127.0.0.1" if local else os.uname().nodename
        blocks = worker_envs(
            assignment.slots, "per-slot", addr, server.port,
            _free_port(),  # a fresh store an epoch
            self._secret.hex(),
            extra={**self._extra_env,
                   "HOROVOD_ELASTIC_EPOCH": str(assignment.epoch),
                   "HOROVOD_ELASTIC": "1"},
        )
        procs: List[subprocess.Popen] = []
        for block in blocks:
            hostname = block["HOROVOD_HOSTNAME"]
            stdout = stderr = None
            if self._output_filename:
                os.makedirs(self._output_filename, exist_ok=True)
                tag = f"epoch.{assignment.epoch}.rank.{block['HOROVOD_RANK']}"
                stdout = open(os.path.join(self._output_filename,
                                           tag + ".out"), "wb")
                stderr = open(os.path.join(self._output_filename,
                                           tag + ".err"), "wb")
                self._files += [stdout, stderr]
            if self._verbose:
                print(f"[hvdrun-elastic] epoch {assignment.epoch} rank "
                      f"{block['HOROVOD_RANK']} on {hostname}: "
                      + " ".join(self._command), file=sys.stderr)
            if _is_local(hostname):
                env = dict(os.environ)
                env.update(block)
                cwd = os.getcwd()
                prior = env.get("PYTHONPATH")
                env["PYTHONPATH"] = cwd if not prior else cwd + os.pathsep + prior
                procs.append(subprocess.Popen(self._command, env=env,
                                              stdout=stdout, stderr=stderr))
            else:
                # the launcher's ssh shape; the secret rides stdin
                from ..runner.launch import _ssh_wrap

                cmd = _ssh_wrap(hostname, self._ssh_port, block,
                                self._command)
                proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                        stdout=stdout, stderr=stderr)
                proc.stdin.write(
                    (block.get("HOROVOD_SECRET_KEY", "") + "\n").encode())
                proc.stdin.close()
                procs.append(proc)
        with self._lock:
            self._procs = procs
            self._blocks = blocks
            self._assignment = assignment
        self._sync_standby_warmers(assignment, addr, server.port)

    # ------------------------------------------------------- warm standby

    def _sync_standby_warmers(self, assignment: SlotAssignment, addr: str,
                              kv_port: int) -> None:
        """Launch a warmer on each newly reserved local host and stop
        those whose host left the reservation. A remote reserved host is
        held out of the gang but runs no warmer of this driver's (its
        operator runs one there)."""
        from ..common.metrics import registry as _metrics

        reserved = set(self._standby_current)
        for hn in list(self._standby_warmers):
            if hn not in reserved:
                proc = self._standby_warmers.pop(hn)
                if proc is not None and proc.poll() is None:
                    proc.terminate()
        for hn in sorted(reserved):
            proc = self._standby_warmers.get(hn)
            if proc is not None and proc.poll() is None:
                continue
            launched = None
            if _is_local(hn):
                env = dict(os.environ)
                env.update(self._extra_env)
                env.update(
                    HOROVOD_GLOO_RENDEZVOUS_ADDR=addr,
                    HOROVOD_GLOO_RENDEZVOUS_PORT=str(kv_port),
                    HOROVOD_SECRET_KEY=self._secret.hex(),
                    HOROVOD_STANDBY_HOSTNAME=hn,
                    # the preload targets the fingerprint of the world
                    # the standby would join
                    HOROVOD_SIZE=str(assignment.world_size),
                    HOROVOD_LOCAL_SIZE=str(max(
                        (s.local_size for s in assignment.slots), default=1)),
                )
                cwd = os.getcwd()
                prior = env.get("PYTHONPATH")
                env["PYTHONPATH"] = cwd if not prior else cwd + os.pathsep + prior
                try:
                    launched = subprocess.Popen(
                        [sys.executable, "-m",
                         "horovod_tpu_torch.elastic.standby"], env=env)
                except OSError:
                    _log.warning("standby warmer launch failed on %s", hn,
                                 exc_info=True)
            else:
                _log.info("host %s reserved as warm standby (remote: no "
                          "warmer launched)", hn)
            self._standby_warmers[hn] = launched
            _log.info("warm standby reserved on %s", hn)
        _metrics.gauge("driver.standby.reserved", len(reserved))

    def standby_status(self) -> Dict[str, dict]:
        """``{hostname: announcement}`` of every warmer (the KV's
        ``standby`` scope): the announce, staging, armed, released
        lifecycle."""
        if self._server is None:
            return {}
        from ..runner.rendezvous import read_standbys

        try:
            return read_standbys(self._server.store)
        except Exception:  # noqa: BLE001 - observability only
            return {}

    def _release_standby(self, reason: str) -> Optional[str]:
        """Swap-in: fold one reserved standby back into the pool, so the
        next assignment includes it, an armed one before one still
        staging, and tell its warmer to stand down. Returns the host, or
        None when no standby is held."""
        candidates = [hn for hn in sorted(self._standby_warmers)
                      if hn not in self._standby_released]
        if not candidates:
            return None
        status = self.standby_status()
        armed = [hn for hn in candidates
                 if status.get(hn, {}).get("state") == "armed"]
        hostname = (armed or candidates)[0]
        self._standby_released.add(hostname)
        self._standby_swapins += 1
        if self._server is not None:
            from ..runner.rendezvous import STANDBY_SCOPE

            try:
                self._server.store.put(STANDBY_SCOPE, f"release.{hostname}",
                                       b"1")
            except Exception:  # noqa: BLE001 - SIGTERM at shutdown
                pass
        from ..common.metrics import registry as _metrics

        _metrics.counter("driver.standby.swapins")
        _metrics.gauge("driver.standby.reserved", len(candidates) - 1)
        _log.info("releasing warm standby %s into the gang (%s); swap-in "
                  "#%d", hostname, reason, self._standby_swapins)
        return hostname

    def _maybe_scale_up(self, per_role: Dict[str, dict]) -> None:
        """A serve role with live workers and no admission headroom (no
        free slot and no free page) while a standby is held releases the
        standby and queues a grow restart (reason ``serve scaleup``), at
        most once a staleness window."""
        if self._scaleup_reason is not None or not self._standby_warmers:
            return
        if self._clock() - self._last_scaleup < _EXPERT_LOAD_STALE_S:
            return
        saturated = sorted(role for role, agg in per_role.items()
                           if agg["workers"] > 0 and agg["free_slots"] <= 0
                           and agg["free_pages"] <= 0)
        if not saturated:
            return
        released = self._release_standby(
            f"serve saturation: role(s) {','.join(saturated)}")
        if released is None:
            return
        self._last_scaleup = self._clock()
        self._scaleup_reason = (f"serve scaleup: standby {released} absorbs "
                                f"saturated role(s) {','.join(saturated)}")

    def _terminate_gang(self, grace: float = 10.0) -> None:
        with self._lock:
            procs = list(self._procs)
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + grace
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=5)

    def _notify_workers(self, message_type: str) -> None:
        """Tell every live worker that the hosts changed, at the address
        each registered in the KV."""
        from ..common.retry import RetryPolicy

        server = self._rendezvous()
        scope = f"workers.{self._epoch}"
        # best effort: a dead worker must not stall the sweep
        retry = RetryPolicy.from_env("driver.notify", attempts=2,
                                     deadline_s=10.0)
        for key in server.store.keys(scope):
            value = server.store.get(scope, key)
            if value is None:
                continue
            host, _, port = value.decode().partition(":")
            try:
                BasicClient(host, int(port), self._secret, timeout=5,
                            retry=retry).request(
                    {"type": message_type, "epoch": self._epoch})
            except OSError:
                pass  # already gone; its exit is collected

    # ---------------------------------------------------------- main loop

    def _poll_gang(self) -> Optional[int]:
        """Collect exits: the job's code when the gang is done (0 only
        if every worker exited 0), None while it runs. A failed worker's
        host is blacklisted."""
        with self._lock:
            procs = list(self._procs)
            blocks = list(self._blocks)
        if not procs:
            return None
        codes = [p.poll() for p in procs]
        # a worker that a signal ended, or a remote one whose ssh session
        # was lost (255), sorts first: it is the likelier cause
        failed = sorted(
            (not (rc < 0 or (rc == 255 and not _is_local(host))), i, host, rc)
            for i, (rc, host) in enumerate(
                zip(codes, (b["HOROVOD_HOSTNAME"] for b in blocks)))
            if rc not in (None, 0))
        if failed:
            # every failed remote worker's host goes, as in the JAX
            # package. The names of this machine are one machine, where a
            # survivor's collective fails when its peer's socket closes:
            # of those only the cause's name goes (a signalled worker's,
            # else the lowest rank's), never the whole machine
            for _, _, hostname, _ in failed:
                if not _is_local(hostname):
                    self.handle_host_failure(hostname)
            local = [f for f in failed if _is_local(f[2])]
            if local:
                self.handle_host_failure(local[0][2])
            return failed[0][3]
        if all(rc == 0 for rc in codes):
            return 0
        return None

    def run(self) -> int:
        """Supervise until success, ``stop()`` or too little capacity;
        returns the job's exit code."""
        last_refresh = 0.0
        while not self._stop.is_set():
            now = time.monotonic()
            restart_reason = (self._poll_heartbeats(now)
                              or self._poll_audit(now))
            if restart_reason:
                self._terminate_gang()
                if not self._reset(reason=restart_reason):
                    return 1
                continue
            if now - last_refresh >= self._interval:
                changed = self.host_manager.refresh()
                last_refresh = now
                if changed and self._assignment is not None:
                    _log.info("host membership changed; restarting gang")
                    self._notify_workers("hosts_updated")
                    self._terminate_gang()
                    if not self._reset(reason="membership change"):
                        return 1
                    continue
            if self._assignment is None:
                new = self.compute_assignment()
                if new is not None:
                    self._launch_gang(new)
                elif not self._wait_for_capacity(last_refresh):
                    return 1
                continue
            rc = self._poll_gang()
            if rc == 0:
                return 0
            if rc is not None:
                self._terminate_gang()
                if not self._reset(reason=f"worker failed rc={rc}"):
                    return rc
            time.sleep(0.05)
        self._terminate_gang()
        return 0

    def _poll_heartbeats(self, now: float) -> Optional[str]:
        """Relay the gang's heartbeats into the stall inspector, once
        an interval (``driver.py:657``), and publish
        ``driver.heartbeat_ranks``/``_age_max_s``. Returns a restart
        reason when the gang should be torn down: the inspector
        escalated past ``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS``, or a
        straggler's host was quarantined; None while the gang looks
        healthy."""
        if self._server is None or now - self._last_hb_poll < self._interval:
            return None
        self._last_hb_poll = now
        from ..common.exceptions import HorovodInternalError
        from ..common.metrics import registry as _metrics
        from ..runner.rendezvous import read_heartbeat_stats

        try:
            beats = read_heartbeat_stats(self._server.store)
        except Exception:  # noqa: BLE001 - the next poll retries
            _log.debug("heartbeat poll failed", exc_info=True)
            return None
        _metrics.gauge("driver.heartbeat_ranks", len(beats))
        if beats:
            _metrics.gauge("driver.heartbeat_age_max_s",
                           max(time.time() - b["ts"] for b in beats.values()))
        deferred_max = 0.0
        for rank, payload in beats.items():
            self.stall_inspector.record_heartbeat(
                rank, payload["ts"], step=payload.get("step"),
                step_ms_p50=payload.get("step_ms_p50"),
                last_step_ts=payload.get("last_step_ts"))
            deferred_max = max(deferred_max, float(
                payload.get("local_sgd_rounds_deferred", 0.0)))
        if deferred_max > 0.0:
            _metrics.gauge("driver.local_sgd.rounds_deferred", deferred_max)
        try:
            self.stall_inspector.check()  # publishes stall.*
        except HorovodInternalError as e:
            # silence past the shutdown age is a worker failure
            _log.error("stall escalation: %s", e)
            return "worker heartbeat silence"
        stragglers = tuple(self.stall_inspector.straggler_ranks())
        if stragglers != self._last_stragglers:
            if stragglers:
                _log.warning("straggler ranks (slow, not silent): %s",
                             ",".join(map(str, stragglers)))
            elif self._last_stragglers:
                _log.info("straggler ranks recovered")
            self._last_stragglers = stragglers
        self._maybe_rebalance()
        self._poll_expert_loads()
        self._poll_serve_capacity()
        reason = self._maybe_quarantine()
        _metrics.maybe_dump()
        if reason is not None:
            return reason
        # a serve scale-up queued by _maybe_scale_up: restart the gang
        # with the released standby in it
        reason, self._scaleup_reason = self._scaleup_reason, None
        return reason

    def _maybe_rebalance(self) -> None:
        """Publish the gang's micro-batch weights (module docstring): a
        rank flagged for ``_REBALANCE_STREAK`` fresh heartbeats gets the
        gang's median p50 over its own, clamped to [0.25, 1.0], rounded
        to 2 places; every other rank 1.0. Nothing is published while
        the gang never left parity, nor when the map has not changed."""
        if not self._rebalance or self._server is None:
            return
        import statistics

        from ..common.metrics import registry as _metrics
        from ..runner.rendezvous import put_rebalance_weights

        streaks = self.stall_inspector.straggler_streaks()
        hb = self.stall_inspector.heartbeat_stats()
        p50s = {r: s["step_ms_p50"] for r, s in hb.items()
                if s.get("step_ms_p50", 0) > 0}
        weights = {r: 1.0 for r in hb}
        if len(p50s) >= 2:
            median = statistics.median(p50s.values())
            for r, n in streaks.items():
                if n >= _REBALANCE_STREAK and p50s.get(r, 0) > 0 \
                        and median > 0:
                    weights[r] = round(max(0.25, min(1.0,
                                                     median / p50s[r])), 2)
        down_now = any(w < 1.0 for w in weights.values())
        down_before = any(w < 1.0 for w in self._rebalance_weights.values())
        if (not down_now and not down_before) \
                or weights == self._rebalance_weights:
            return
        try:
            put_rebalance_weights(self._server.store, weights,
                                  epoch=self._epoch)
        except Exception:  # noqa: BLE001 - the next poll retries
            _log.debug("rebalance publish failed", exc_info=True)
            return
        self._rebalance_weights = dict(weights)
        slowed = sorted(r for r, w in weights.items() if w < 1.0)
        _metrics.gauge("driver.rebalance.active", len(slowed))
        _metrics.counter("driver.rebalance.updates")
        if slowed:
            _log.warning("rebalancing micro-batch weights away from "
                         "straggling rank(s) %s: %s",
                         ",".join(map(str, slowed)),
                         ",".join(f"{r}={weights[r]}" for r in slowed))
        else:
            _log.info("straggler rebalance cleared: all weights 1.0")

    def _poll_expert_loads(self) -> None:
        """Sum the gang's published expert loads into the
        ``driver.expert_load.*`` gauges: the fleet histogram's hottest
        over mean kept tokens, and dropped over routed. A rank counts
        while its stamp advances, or for ``_EXPERT_LOAD_STALE_S`` of the
        driver's clock after it last did. Observability only; a
        malformed or absent ledger is silence."""
        if self._server is None:
            return
        from ..runner.rendezvous import read_expert_loads

        try:
            loads = read_expert_loads(self._server.store)
        except Exception:  # noqa: BLE001 - the next poll retries
            return
        if not loads:
            return
        now = self._clock()
        fresh = {}
        for rank, payload in loads.items():
            ts = float(payload.get("ts", 0.0))
            prev = self._expert_load_seen.get(rank)
            if prev is None or ts > prev[0]:
                self._expert_load_seen[rank] = (ts, now)
                fresh[rank] = payload
            elif now - prev[1] <= _EXPERT_LOAD_STALE_S:
                fresh[rank] = payload
        for rank in list(self._expert_load_seen):
            if rank not in loads:
                del self._expert_load_seen[rank]
        hist: Dict[int, float] = {}
        dropped = total = 0.0
        for payload in fresh.values():
            for i, t in enumerate(payload.get("expert_tokens", ())):
                hist[i] = hist.get(i, 0.0) + float(t)
            dropped += float(payload.get("dropped", 0.0))
            total += float(payload.get("total", 0.0))
        if not hist or total <= 0:
            return
        from ..common.metrics import registry as _metrics

        kept = sum(hist.values())
        mean = kept / len(hist) if kept > 0 else 0.0
        _metrics.gauge("driver.expert_load.ranks", len(fresh))
        _metrics.gauge("driver.expert_load.imbalance",
                       max(hist.values()) / mean if mean > 0 else 1.0)
        _metrics.gauge("driver.expert_load.drop_rate", dropped / total)

    def _poll_serve_capacity(self) -> None:
        """Sum the serving fleet's capacity announcements (scope
        ``serve``) by role into ``driver.serve.{role}.workers``,
        ``.free_slots`` and ``.free_pages``: how many prefill and decode
        workers are live and the admission headroom each side of the
        wire has left (a draining worker counts as a worker with none).
        A rank counts while its ``ts`` advances, or for
        ``_EXPERT_LOAD_STALE_S`` of the driver's clock after, as in
        :meth:`_poll_expert_loads`. Observability only."""
        if self._server is None:
            return
        from ..runner.rendezvous import read_announcements, worker_role

        try:
            anns = read_announcements(self._server.store)
        except Exception:  # noqa: BLE001 - the next poll retries
            return
        if not anns:
            return
        now = self._clock()
        fresh = {}
        for rank, ann in anns.items():
            ts = float(ann.get("ts", 0.0))
            prev = self._serve_cap_seen.get(rank)
            if prev is None or ts > prev[0]:
                self._serve_cap_seen[rank] = (ts, now)
                fresh[rank] = ann
            elif now - prev[1] <= _EXPERT_LOAD_STALE_S:
                fresh[rank] = ann
        for rank in list(self._serve_cap_seen):
            if rank not in anns:
                del self._serve_cap_seen[rank]
        per_role: Dict[str, Dict[str, float]] = {}
        for ann in fresh.values():
            agg = per_role.setdefault(
                worker_role(ann),
                {"workers": 0.0, "free_slots": 0.0, "free_pages": 0.0})
            agg["workers"] += 1.0
            if not ann.get("draining"):
                agg["free_slots"] += float(ann.get("free_slots", 0))
                agg["free_pages"] += float(ann.get("free_pages", 0))
        from ..common.metrics import registry as _metrics

        for role, agg in per_role.items():
            for key, val in agg.items():
                _metrics.gauge(f"driver.serve.{role}.{key}", val)
        self._maybe_scale_up(per_role)

    def _maybe_quarantine(self) -> Optional[str]:
        """Blacklist the hosts of ranks flagged a straggler for
        ``HOROVOD_STRAGGLER_QUARANTINE_POLLS`` consecutive fresh
        heartbeats and return a restart reason (``driver.py:918``);
        None when nothing qualifies or the capacity guard keeps them."""
        if self._quarantine_polls <= 0:
            return None
        ranks = self.stall_inspector.quarantine_candidates(
            self._quarantine_polls)
        if not ranks:
            return None
        hosts = self._hosts_of_ranks(ranks)
        if not hosts or not self._try_blacklist(hosts,
                                                "straggler quarantine"):
            return None
        _log.warning("quarantining straggler host(s) %s (ranks %s flagged "
                     "for %d consecutive polls); restarting gang without "
                     "them", ",".join(hosts), ",".join(map(str, ranks)),
                     self._quarantine_polls)
        return (f"straggler quarantine: hosts {','.join(hosts)} "
                f"(ranks {','.join(map(str, ranks))})")

    def _hosts_of_ranks(self, ranks) -> List[str]:
        with self._lock:
            rank_to_host = {int(b["HOROVOD_RANK"]): b["HOROVOD_HOSTNAME"]
                            for b in self._blocks}
        return sorted({rank_to_host[r] for r in ranks if r in rank_to_host})

    def _try_blacklist(self, hosts, why: str) -> bool:
        """Blacklist ``hosts`` unless that leaves less than min_np (then
        warn once and keep them: a smaller gang beats none)."""
        slots = {h.hostname: (self._slots_per_host
                              if self._slots_per_host is not None
                              else h.slots)
                 for h in self.host_manager.current_hosts()}
        remaining = sum(s for hn, s in slots.items() if hn not in hosts)
        if remaining < self._min_np:
            if not self._quarantine_capacity_warned:
                self._quarantine_capacity_warned = True
                _log.warning("%s of %s would leave %d slots (< min_np=%d); "
                             "keeping the host(s)", why, ",".join(hosts),
                             remaining, self._min_np)
            return False
        from ..common.metrics import registry as _metrics

        for hostname in hosts:
            self.host_manager.blacklist(hostname)
            _metrics.counter("driver.quarantined_hosts")
            self._release_standby(f"{why}: {hostname}")
        self._publish_dead_hosts()
        return True

    def _poll_audit(self, now: float) -> Optional[str]:
        """Compare the gang's published collective-schedule fingerprints
        (:meth:`_check_sched_divergence`), then its parameter digests,
        once an interval; a divergent replica's host is quarantined
        (capacity allowing) and a restart reason returned: the restart's
        sync re-replicates rank 0's state, which is the repair."""
        if self._server is None or now - self._last_audit_poll < self._interval:
            return None
        self._last_audit_poll = now
        sched_reason = self._check_sched_divergence()
        if sched_reason:
            return sched_reason
        from ..audit import find_divergent
        from ..runner.rendezvous import read_audit_digests

        try:
            digests = read_audit_digests(self._server.store)
        except Exception:  # noqa: BLE001
            _log.debug("audit poll failed", exc_info=True)
            return None
        found = find_divergent(digests)
        if found is None:
            return None
        step, bad_ranks = found
        if step == self._last_audit_step:
            return None  # this round was judged already
        self._last_audit_step = step
        from ..common.metrics import registry as _metrics

        _metrics.counter("driver.divergence_restarts")
        hosts = self._hosts_of_ranks(bad_ranks)
        quarantined = hosts and self._try_blacklist(hosts,
                                                    "divergence quarantine")
        _log.error("replica divergence at audit step %d: ranks %s disagree "
                   "with the gang's majority%s; restarting gang", step,
                   ",".join(map(str, bad_ranks)),
                   f" (hosts {','.join(hosts)} quarantined)" if quarantined
                   else " (hosts kept: capacity guard)")
        return (f"divergence: ranks {','.join(map(str, bad_ranks))} at "
                f"audit step {step}")

    def _check_sched_divergence(self) -> Optional[str]:
        """The schedule half of :meth:`_poll_audit`: at the newest quorum
        step the majority fingerprint wins; a divergent rank's host is
        quarantined through the shared gate and the gang restarts with
        reason ``sched_divergence``, the log naming the first divergent
        dispatch recovered from the rings."""
        from ..analysis import sched_audit
        from ..runner.rendezvous import read_sched_fingerprints

        try:
            entries = read_sched_fingerprints(self._server.store)
        except Exception:  # noqa: BLE001 - the next poll retries
            _log.debug("sched audit poll failed", exc_info=True)
            return None
        found = sched_audit.find_divergent(entries)
        if found is None:
            return None
        step, bad_ranks = found
        if step == self._last_sched_step:
            return None  # this round was judged already
        self._last_sched_step = step
        from ..common.metrics import registry as _metrics

        _metrics.counter("driver.sched_divergence_restarts")
        good = sorted(r for r in entries if r not in bad_ranks
                      and entries[r].get("step") == step)
        first = (sched_audit.first_divergent_index(entries[bad_ranks[0]],
                                                    entries[good[0]])
                 if good else None)
        counts = {r: entries[r].get("dispatches") for r in sorted(entries)}
        hosts = self._hosts_of_ranks(bad_ranks)
        quarantined = hosts and self._try_blacklist(
            hosts, "sched divergence quarantine")
        _log.error("collective-schedule divergence at audit step %d: ranks "
                   "%s disagree with the gang's majority fingerprint (first "
                   "divergent dispatch %s; dispatch counts %s)%s; restarting "
                   "gang", step, ",".join(map(str, bad_ranks)),
                   "outside ring" if first is None else f"#{first}", counts,
                   f" (hosts {','.join(hosts)} quarantined)" if quarantined
                   else " (hosts kept: capacity guard)")
        return (f"sched_divergence: ranks {','.join(map(str, bad_ranks))} at "
                f"audit step {step}"
                + ("" if first is None
                   else f" (first divergent dispatch #{first})"))

    def _reset(self, reason: str) -> bool:
        """Bump the epoch and clear the assignment so that the loop
        relaunches; False when ``reset_limit`` is spent."""
        self._resets += 1
        if self._reset_limit is not None and self._resets > self._reset_limit:
            _log.error("reset limit %s exhausted (%s)", self._reset_limit,
                       reason)
            return False
        _log.info("gang reset #%d: %s", self._resets, reason)
        from ..common.metrics import registry as _metrics

        _metrics.counter("driver.gang_restarts")
        self._epoch += 1
        _metrics.gauge("driver.epoch", self._epoch)
        if self._server is not None:
            from ..runner.rendezvous import put_restart_stamp

            try:  # the next epoch's workers read it: elastic.restart_ms
                put_restart_stamp(
                    self._server.store, epoch=self._epoch, reason=reason,
                    warm=bool(self._standby_released),
                    kind="scaleup" if "scaleup" in reason else "restart")
            except Exception:  # noqa: BLE001
                pass
        with self._lock:
            self._assignment = None
            self._procs = []
            self._blocks = []
        return True

    def _wait_for_capacity(self, last_refresh: float) -> bool:
        """Below min_np: poll discovery up to ``start_timeout``."""
        deadline = time.monotonic() + self._start_timeout
        while not self._stop.is_set() and time.monotonic() < deadline:
            time.sleep(self._interval)
            self.host_manager.refresh()
            if self.compute_assignment() is not None:
                return True
        return self.compute_assignment() is not None

    @property
    def epoch(self) -> int:
        return self._epoch

    def stop(self) -> None:
        self._stop.set()

    def shutdown(self) -> None:
        from ..common.metrics import registry as _metrics

        self.stop()
        self._terminate_gang()
        for proc in self._standby_warmers.values():
            if proc is not None and proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=5)
        self._standby_warmers.clear()
        _metrics.dump()  # the driver's gauges, where a sink is set
        for f in self._files:
            f.close()
        self._files = []
        if self._server is not None:
            self._server.stop()
            self._server = None
