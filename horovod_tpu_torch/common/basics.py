"""Global runtime state and the init/shutdown lifecycle, on
``torch.distributed``.

The counterpart of ``horovod_tpu/common/basics.py``. ``init()`` joins
(or makes) the process group, reads the topology, registers the process
sets and builds the fusion manager that batches the eager collectives:

- With the launcher's variables (``HOROVOD_SIZE`` > 1, ``HOROVOD_RANK``)
  the world meets at a TCP store on ``HOROVOD_GLOO_RENDEZVOUS_ADDR``/
  ``_PORT``, hosted by rank 0; a test passes its own ``store=`` (a
  ``FileStore``) instead.
- Without them ``init()`` makes a world of one process from an
  in-process ``HashStore``: no TCP port is opened.
- A process group the caller made before ``init()`` is adopted as it is
  and left to the caller at ``shutdown()``.

The backend follows the device: ``init(device="cpu")`` makes a gloo
group; the default device is the CUDA card (``resolve_device``), and the
group then runs NCCL for CUDA tensors and gloo for CPU tensors
(``"cpu:gloo,cuda:nccl"``), with ``torch.cuda.set_device`` called first.
``init(); shutdown(); init()`` works: each init makes a fresh store and
group.
"""

from __future__ import annotations

import datetime
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from . import topology as topo_mod
from .config import TrainConfig, resolve_device
from .process_sets import ProcessSet, ProcessSetTable

_TIMEOUT = datetime.timedelta(seconds=300)


class NotInitializedError(RuntimeError):
    def __init__(self):
        super().__init__(
            "horovod_tpu_torch has not been initialized; call hvd.init() "
            "first."
        )


class HorovodInternalError(RuntimeError):
    """A collective or the training state failed in a way the elastic
    contract restores from (the grad guard's escalation raises it)."""


class HostsUpdatedInterrupt(Exception):
    """The world's membership changed and the current state is still
    good (the elastic contract, ``horovod/common/elastic.py``)."""


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


_state = _GlobalState()


def state() -> _GlobalState:
    return _state


def _require_init() -> _GlobalState:
    if not _state.initialized:
        raise NotInitializedError()
    return _state


def _store(cfg: TrainConfig, rank: int, size: int):
    if size == 1:
        return dist.HashStore()
    if not cfg.rendezvous_addr or cfg.rendezvous_port is None:
        raise RuntimeError(
            f"a world of {size} ranks needs HOROVOD_GLOO_RENDEZVOUS_ADDR "
            "and HOROVOD_GLOO_RENDEZVOUS_PORT (or init(store=...))"
        )
    return dist.TCPStore(cfg.rendezvous_addr, cfg.rendezvous_port, size,
                         is_master=rank == 0, timeout=_TIMEOUT)


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
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
                backend = "cpu:gloo,cuda:nccl"
            else:
                backend = "gloo"
            if store is None:
                store = _store(cfg, rank, size)
            dist.init_process_group(backend, store=store, rank=rank,
                                    world_size=size, timeout=_TIMEOUT)
        try:
            topology = topo_mod.discover(dist.get_rank(),
                                         dist.get_world_size(), cfg)
            table = ProcessSetTable(topology.size, new_group=dist.new_group)
            intra, inter = topo_mod.stage_groups(topology, dist.new_group)
            for ps in process_sets or ():
                table.register(ps)
        except BaseException:
            if owns:
                dist.destroy_process_group()
            raise
        from ..ops.fusion import FusionManager

        _state.config = cfg
        _state.topology = topology
        _state.process_set_table = table
        _state.intra_group, _state.inter_group = intra, inter
        _state.fusion = FusionManager(cfg.fusion_threshold_bytes,
                                      wire=cfg.fusion_wire,
                                      wire_block=cfg.fusion_wire_block,
                                      wire_hier=cfg.fusion_wire_hier)
        _state.owns_group = owns
        _state.device = dev
        _state.traced_groups = {}
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
