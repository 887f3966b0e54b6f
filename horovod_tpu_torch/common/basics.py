"""Global runtime state and the init/shutdown lifecycle, on
``torch.distributed``.

The counterpart of ``horovod_tpu/common/basics.py``. ``init()`` joins
(or makes) the process group, reads the topology, registers the process
sets and builds the fusion manager that batches the eager collectives:

- With the launcher's variables (``HOROVOD_SIZE`` > 1, ``HOROVOD_RANK``)
  the world meets at a TCP store hosted by rank 0 on
  ``HOROVOD_COORDINATOR_ADDR``/``_PORT`` (what ``python -m
  horovod_tpu_torch.runner`` sets; ``HOROVOD_GLOO_RENDEZVOUS_*`` is then
  the launcher's HTTP KV), or on ``HOROVOD_GLOO_RENDEZVOUS_ADDR``/
  ``_PORT`` when no coordinator is named; a test passes its own
  ``store=`` (a ``FileStore``) instead.
- Without them ``init()`` makes a world of one process from an
  in-process ``HashStore``: no TCP port is opened.
- A process group the caller made before ``init()`` is adopted as it is
  and left to the caller at ``shutdown()``.

The backend follows the device: ``init(device="cpu")`` makes a gloo
group; the default device is the CUDA card (``resolve_device``: the
local rank's under a launcher), and the group then runs NCCL for CUDA
tensors and gloo for CPU tensors (``"cpu:gloo,cuda:nccl"``), with
``torch.cuda.set_device`` called first. ``HOROVOD_CONTROLLER=gloo``
(``hvdrun --gloo``) makes a gloo group for CUDA tensors too, which is
how several ranks share one card; under NCCL a launcher's
``HOROVOD_LOCAL_SIZE`` above the visible cards raises, naming
``--gloo``. Launched, ``init()`` also checks that every rank runs the
versions rank 0 runs (``runner.rendezvous.check_version_consistency``).
``init(); shutdown(); init()`` works and binds no port
again: the TCP store lives as long as the process, and each
initialization meets under a ``PrefixStore`` of its own generation.

``init()`` also attaches what the snapshot asks for, as the JAX
package's does: the logger's level (``configure_from_init``), the
metrics' JSON-lines sink (``HOROVOD_METRICS_FILE``), the eager timeline
(``HOROVOD_TIMELINE``), the stall inspector (on unless
``HOROVOD_STALL_CHECK_DISABLE``), the telemetry hub's knobs with the
timeline and the inspector, the ``/metrics`` server
(``HOROVOD_METRICS_PORT``) and the parameter manager
(``HOROVOD_AUTOTUNE``); ``shutdown()`` detaches them, closes the
timeline and dumps the flight recorder. With none of these variables
set, ``init()`` starts no thread, opens no socket and writes no file.
"""

from __future__ import annotations

import datetime
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from . import topology as topo_mod
from .config import TrainConfig, resolve_device
from .exceptions import (  # noqa: F401
    HorovodInternalError,
    HostsUpdatedInterrupt,
    NotInitializedError,
)
from .process_sets import ProcessSet, ProcessSetTable

_TIMEOUT = datetime.timedelta(seconds=300)




class _GlobalState:
    def __init__(self):
        self.lock = threading.Lock()
        self.initialized = False
        self.config: Optional[TrainConfig] = None
        self.topology: Optional[topo_mod.Topology] = None
        self.process_set_table: Optional[ProcessSetTable] = None
        self.intra_group = None
        self.inter_group = None
        self.fusion = None  # ops.fusion.FusionManager
        self.owns_group = False  # init() made the process group
        self.device: Optional[torch.device] = None  # where this rank computes
        # ops/traced.py's process groups by rank lists: (group, position,
        # size), made eagerly on first use, in the same order on every rank
        self.traced_groups: dict = {}
        # observability (common/timeline.py, traced_timeline.py,
        # stall_inspector.py, telemetry.py, autotune.py)
        self.timeline = None
        self.traced_timeline = None
        self.stall_inspector = None
        self.telemetry_server = None
        self.parameter_manager = None


_state = _GlobalState()


def state() -> _GlobalState:
    return _state


def _require_init() -> _GlobalState:
    if not _state.initialized:
        raise NotInitializedError()
    return _state


# the TCP store of this process's world, kept across re-inits: a
# ``shutdown(); init()`` in place (the elastic wrapper's) must not bind
# rank 0's port again; {"key": (addr, port, size), "store", "gen"}
_tcp = {"key": None, "store": None, "gen": 0}


def _store(cfg: TrainConfig, rank: int, size: int):
    if size == 1:
        return dist.HashStore()
    if cfg.coordinator_addr and cfg.coordinator_port is not None:
        addr, port = cfg.coordinator_addr, cfg.coordinator_port
    elif cfg.rendezvous_addr and cfg.rendezvous_port is not None:
        addr, port = cfg.rendezvous_addr, cfg.rendezvous_port
    else:
        raise RuntimeError(
            f"a world of {size} ranks needs HOROVOD_COORDINATOR_ADDR and "
            "HOROVOD_COORDINATOR_PORT (or HOROVOD_GLOO_RENDEZVOUS_ADDR/"
            "_PORT, or init(store=...))"
        )
    key = (addr, int(port), size)
    if _tcp["key"] != key:
        _tcp["store"] = dist.TCPStore(addr, int(port), size,
                                      is_master=rank == 0, timeout=_TIMEOUT)
        _tcp["key"], _tcp["gen"] = key, 0
    _tcp["gen"] += 1  # every rank re-inits as often: the names agree
    return dist.PrefixStore(f"hvd.gen{_tcp['gen']}", _tcp["store"])


def _backend(cfg: TrainConfig, dev: torch.device) -> str:
    """gloo on the CPU or under ``HOROVOD_CONTROLLER=gloo``; else NCCL
    for CUDA tensors, which needs a card a rank on the host."""
    if dev.type != "cuda" or cfg.controller == "gloo":
        return "gloo"
    if cfg.local_size is not None and (
            cfg.local_size > torch.cuda.device_count()):
        raise RuntimeError(
            f"{cfg.local_size} ranks on this host and "
            f"{torch.cuda.device_count()} CUDA device(s): NCCL needs a "
            "card a rank; launch with --gloo (HOROVOD_CONTROLLER=gloo) "
            "to share the cards"
        )
    return "cpu:gloo,cuda:nccl"


def init(process_sets: Optional[Sequence[ProcessSet]] = None, *,
         device=None, store=None) -> None:
    """Join the world; idempotent, like the reference's
    ``InitializeHorovodOnce``. ``device`` is where this rank computes
    (default: the CUDA card; ``"cpu"`` for a gloo world). ``store`` is a
    ``torch.distributed`` store to meet at instead of the one the
    variables name."""
    with _state.lock:
        if _state.initialized:
            return
        cfg = TrainConfig.from_env()
        dev = resolve_device(device)
        owns = not dist.is_initialized()
        if owns:
            size = cfg.size if cfg.size is not None else 1
            rank = cfg.rank if cfg.rank is not None else 0
            backend = _backend(cfg, dev)
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            if store is None:
                store = _store(cfg, rank, size)
            dist.init_process_group(backend, store=store, rank=rank,
                                    world_size=size, timeout=_TIMEOUT)
        try:
            topology = topo_mod.discover(dist.get_rank(),
                                         dist.get_world_size(), cfg)
            if owns and cfg.coordinator_addr and cfg.rendezvous_addr:
                # launched by the port's runner: the KV beside the store
                # holds each rank's versions, compared with rank 0's
                from ..runner.rendezvous import check_version_consistency
                from .logging import get_logger

                check_version_consistency(cfg, topology, get_logger("init"))
            table = ProcessSetTable(topology.size, new_group=dist.new_group)
            intra, inter = topo_mod.stage_groups(topology, dist.new_group)
            for ps in process_sets or ():
                table.register(ps)
        except BaseException:
            if owns:
                dist.destroy_process_group()
            raise
        from ..ops.fusion import FusionManager
        from . import autotune

        autotune.start_world(autotune.topology_fingerprint(topology, dev))
        _state.config = cfg
        _state.topology = topology
        _state.process_set_table = table
        _state.intra_group, _state.inter_group = intra, inter
        _state.fusion = FusionManager(cfg.fusion_threshold_bytes,
                                      wire=cfg.fusion_wire,
                                      wire_block=cfg.fusion_wire_block,
                                      wire_hier=cfg.fusion_wire_hier,
                                      wire_min_bytes=cfg.fusion_wire_min_bytes,
                                      guard=cfg.guard)
        _state.owns_group = owns
        _state.device = dev
        _state.traced_groups = {}
        try:
            _attach_observability(cfg)
        except BaseException:
            _detach_observability()
            if owns:
                dist.destroy_process_group()
            raise
        _state.initialized = True


def shutdown() -> None:
    """Flush what is pending and leave the world; a later ``init()``
    starts afresh."""
    with _state.lock:
        if not _state.initialized:
            return
        try:
            _state.fusion.flush()
            _state.fusion.wait_all()
        finally:
            _detach_observability()
            if _state.owns_group and dist.is_initialized():
                dist.destroy_process_group()
            _state.initialized = False
            _state.config = None
            _state.topology = None
            _state.process_set_table = None
            _state.intra_group = _state.inter_group = None
            _state.fusion = None
            _state.owns_group = False
            _state.device = None
            _state.traced_groups = {}


def _attach_observability(cfg: TrainConfig) -> None:
    """What ``horovod_tpu/common/basics.py:159-207`` attaches at init,
    each only when its variable asks for it (the stall inspector unless
    disabled). The telemetry hub is process-wide and outlives
    init/shutdown cycles: init refreshes its knobs and hands it the
    current timeline and inspector."""
    from . import telemetry as telemetry_mod
    from .logging import configure_from_init
    from .metrics import registry as _metrics

    configure_from_init(cfg.log_level, cfg.log_timestamp)
    _metrics.configure_export()  # HOROVOD_METRICS_FILE, if set
    fusion = _state.fusion
    # the registry outlives the world, the fusion counters do not: start
    # the fusion.* gauges from this world's zeros, so the first step
    # record's deltas are this world's
    _metrics.update("fusion", fusion.stats())
    if cfg.timeline:
        from .timeline import Timeline

        _state.timeline = Timeline(cfg.timeline,
                                   mark_cycles=cfg.timeline_mark_cycles)
        fusion.timeline = _state.timeline
    if not cfg.stall_check_disable:
        from .stall_inspector import StallInspector

        _state.stall_inspector = StallInspector(
            warning_seconds=cfg.stall_warning_seconds,
            shutdown_seconds=cfg.stall_shutdown_seconds,
            straggler_factor=cfg.straggler_factor,
        )
        fusion.stall_inspector = _state.stall_inspector
    hub = telemetry_mod.hub()
    hub.configure(capacity=cfg.telemetry_steps,
                  flight_path=cfg.flight_recorder)
    hub.timeline = _state.timeline
    hub.stall_inspector = _state.stall_inspector
    if cfg.metrics_port:
        _state.telemetry_server = telemetry_mod.MetricsServer(
            port=cfg.metrics_port)
        _state.telemetry_server.start()
    if cfg.autotune:
        from .autotune import ParameterManager, agree_sample

        dev = _state.device
        _state.parameter_manager = ParameterManager.from_config(
            cfg, agree=lambda b, s: agree_sample(b, s, dev))
        fusion.parameter_manager = _state.parameter_manager


def _detach_observability() -> None:
    """``shutdown()``'s half (``basics.py:210-243``): close the
    timelines, stop the server, detach the hub and dump its ring (a
    clean teardown is a natural dump point; the ring survives)."""
    from . import telemetry as telemetry_mod

    if _state.timeline is not None:
        _state.timeline.close()
    if _state.traced_timeline is not None:
        _state.traced_timeline.close()
    if _state.telemetry_server is not None:
        _state.telemetry_server.stop()
    hub = telemetry_mod.hub()
    hub.timeline = None
    hub.stall_inspector = None
    try:
        hub.dump()
    except OSError:
        pass
    _state.timeline = _state.traced_timeline = None
    _state.stall_inspector = _state.telemetry_server = None
    _state.parameter_manager = None
    from .autotune import end_world

    end_world()  # the next world's tuners start from the cache alone


def is_initialized() -> bool:
    return _state.initialized


def size() -> int:
    return _require_init().topology.size


def rank() -> int:
    return _require_init().topology.rank


def local_size() -> int:
    return _require_init().topology.local_size


def local_rank() -> int:
    return _require_init().topology.local_rank


def cross_size() -> int:
    return _require_init().topology.cross_size


def cross_rank() -> int:
    return _require_init().topology.cross_rank


def topology() -> topo_mod.Topology:
    return _require_init().topology


def live_config() -> TrainConfig:
    """The initialized world's snapshot when there is one, else a fresh
    read of the environment: what a default that defers to the config
    resolves against (the expert wire's)."""
    if _state.initialized and _state.config is not None:
        return _state.config
    return TrainConfig.from_env()


def get_config() -> TrainConfig:
    """The ``HOROVOD_*`` snapshot taken at ``init()``."""
    return _require_init().config


def is_homogeneous() -> bool:
    """True when every node holds the same number of ranks (the port
    lays ranks out node by node, ``local_size`` a node)."""
    topo = _require_init().topology
    return topo.size == topo.cross_size * topo.local_size


# What this build runs on: NCCL on the card and gloo on the CPU, both
# from ``torch.distributed``; no MPI, DDL, oneCCL, ROCm or XLA.


def mpi_threads_supported() -> bool:
    """The port runs no MPI."""
    return False


def mpi_built() -> bool:
    return False


def mpi_enabled() -> bool:
    return False


def gloo_built() -> bool:
    return True


def gloo_enabled() -> bool:
    return True


def nccl_built() -> bool:
    return True


def cuda_built() -> bool:
    return True


def ddl_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


def rocm_built() -> bool:
    return False


def xla_built() -> bool:
    return False


def add_process_set(ranks: Sequence[int]) -> ProcessSet:
    """Register a set on every rank (collective, as in the reference)."""
    ps = ranks if isinstance(ranks, ProcessSet) else ProcessSet(ranks)
    return _require_init().process_set_table.register(ps)


def remove_process_set(ps: ProcessSet) -> None:
    _require_init().process_set_table.remove(ps)


def global_process_set() -> ProcessSet:
    return _require_init().process_set_table.global_set


def get_process_set_ids() -> Sequence[int]:
    return _require_init().process_set_table.ids()


def get_process_set(process_set_id: int) -> ProcessSet:
    return _require_init().process_set_table.get(process_set_id)
