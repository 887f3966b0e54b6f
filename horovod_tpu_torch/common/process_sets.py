"""Process sets: named subsets of ranks with their own collective scope.

The counterpart of ``horovod_tpu/common/process_sets.py``. Where the JAX
package gives a set a sub-mesh, the port gives it a ``torch.distributed``
group over the set's ranks (the reference's per-set communicator,
``horovod/common/process_set.cc``). ``dist.new_group`` is collective:
every rank registers every set, in the same order, as with the
reference's ``hvd.add_process_set``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence


class ProcessSet:
    """A named subset of ranks. ``process_set_id`` 0 is the global set."""

    def __init__(self, ranks: Sequence[int]):
        self.ranks: List[int] = sorted(int(r) for r in ranks)
        if len(set(self.ranks)) != len(self.ranks):
            raise ValueError(f"duplicate ranks in process set: {ranks}")
        self.process_set_id: Optional[int] = None  # assigned at registration
        # the torch.distributed group of the set, bound at registration
        # (None for the global set: the default group)
        self.group = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    def included(self, rank: int) -> bool:
        return rank in self.ranks

    def rank_in_set(self, rank: int) -> int:
        """Position of a global rank within this set."""
        try:
            return self.ranks.index(rank)
        except ValueError:
            raise ValueError(f"rank {rank} not in process set {self.ranks}")

    def __repr__(self) -> str:
        return f"ProcessSet(id={self.process_set_id}, ranks={self.ranks})"


class ProcessSetTable:
    """Registry mapping ids to ProcessSets, id 0 = global. ``new_group``
    makes the ``torch.distributed`` group of each set registered after
    the global one (a callable of the ranks, so the table itself stays
    free of process-group state and testable alone)."""

    def __init__(self, world_size: int, new_group=None):
        self._lock = threading.Lock()
        self._world_size = world_size
        self._new_group = new_group
        self._by_id: Dict[int, ProcessSet] = {}
        self._next_id = 0
        self.register(ProcessSet(range(world_size)))  # gets id 0

    @property
    def global_set(self) -> ProcessSet:
        return self._by_id[0]

    def register(self, ps: ProcessSet) -> ProcessSet:
        with self._lock:
            for existing in self._by_id.values():
                if existing.ranks == ps.ranks:
                    return existing
            bad = [r for r in ps.ranks if not 0 <= r < self._world_size]
            if bad:
                raise ValueError(
                    f"ranks {bad} out of range for world size "
                    f"{self._world_size}"
                )
            if not ps.ranks:
                raise ValueError("a process set needs at least one rank")
            if self._next_id and self._new_group is not None:
                ps.group = self._new_group(ps.ranks)
            ps.process_set_id = self._next_id
            self._next_id += 1
            self._by_id[ps.process_set_id] = ps
            return ps

    def remove(self, ps: ProcessSet) -> None:
        with self._lock:
            if ps.process_set_id == 0:
                raise ValueError("cannot remove the global process set")
            self._by_id.pop(ps.process_set_id, None)
            ps.process_set_id = None

    def get(self, process_set_id: int) -> ProcessSet:
        with self._lock:
            return self._by_id[process_set_id]

    def ids(self) -> List[int]:
        with self._lock:
            return sorted(self._by_id)
