"""Rank layout of the world: rank, size, the node-local and cross groups.

The counterpart of ``horovod_tpu/common/topology.py``. The JAX package
reads the world from the JAX runtime (one process per host driving its
chips); the port runs one process per card, as the reference does, and
reads the world from ``torch.distributed`` and the launcher's
``HOROVOD_*`` variables:

- ``size``/``rank``: the process group's world size and this rank;
- ``local_size``: ranks per node (the intra, NVLink-connected unit):
  ``HOROVOD_INTRA_SIZE`` when set, else the launcher's
  ``HOROVOD_LOCAL_SIZE``, else the whole world is one node. A value
  that does not divide the world degrades to ``gcd(value, world)``, as
  the JAX package's ``_gcd_degrade`` does, so an elastic resize keeps a
  valid two-level split;
- ``local_rank = rank % local_size``, ``cross_rank = rank //
  local_size``, ``cross_size = size // local_size``: ranks are laid out
  node by node.

:func:`stage_groups` builds the two-level groups, once, at
``hvd.init()``: one intra group per node, one inter group per
node-local slot. :func:`hierarchy_stages` is the one routing decision
(``HOROVOD_HIERARCHICAL``) every two-level wire consults;
:func:`hierarchical_stage_groups` and :func:`stage_positions` are the
JAX package's helpers of the same names (local SGD's split and each
rank's place in its group).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import numpy as np

from .config import TrainConfig


@dataclasses.dataclass(frozen=True)
class Topology:
    rank: int
    size: int
    local_size: int

    @property
    def local_rank(self) -> int:
        return self.rank % self.local_size

    @property
    def cross_rank(self) -> int:
        return self.rank // self.local_size

    @property
    def cross_size(self) -> int:
        return self.size // self.local_size


def gcd_degrade(intra: int, world: int) -> int:
    """Largest split compatible with ``world``: a non-dividing intra
    size degrades to ``gcd(intra, world)``; a gcd of 1 is the flat
    world."""
    if intra < 1:
        return 1
    if world % intra == 0:
        return intra
    return math.gcd(intra, world)


def discover(rank: int, size: int,
             config: Optional[TrainConfig] = None) -> Topology:
    """The topology of a world of ``size`` ranks seen from ``rank``,
    checked against the launcher's variables: a launcher that placed
    this process elsewhere than the process group says is an error."""
    cfg = config or TrainConfig.from_env()
    checks = [("HOROVOD_SIZE", cfg.size, size),
              ("HOROVOD_RANK", cfg.rank, rank)]
    if cfg.intra_size is not None:
        local = gcd_degrade(int(cfg.intra_size), size)
    elif cfg.local_size is not None:
        local = gcd_degrade(int(cfg.local_size), size)
    else:
        local = size
    topo = Topology(rank=rank, size=size, local_size=local)
    if cfg.intra_size is None:
        checks += [
            ("HOROVOD_LOCAL_SIZE", cfg.local_size, topo.local_size),
            ("HOROVOD_LOCAL_RANK", cfg.local_rank, topo.local_rank),
            ("HOROVOD_CROSS_SIZE", cfg.cross_size, topo.cross_size),
            ("HOROVOD_CROSS_RANK", cfg.cross_rank, topo.cross_rank),
        ]
    mismatches = [
        f"{name}={want} but the process group gives {got}"
        for name, want, got in checks
        if want is not None and want != got
    ]
    if mismatches:
        raise ValueError(
            "HOROVOD_* env contract does not match the process group: "
            + "; ".join(mismatches)
        )
    return topo


def hierarchy_stages(world: Optional[int] = None,
                     mode: Optional[str] = None,
                     intra: Optional[int] = None):
    """The two-level split's rank lists ``(intra, inter)``
    (:func:`stage_ranks`), or None when the wire stays flat; the JAX
    package's ``hierarchy_stages``. ``mode`` defaults to
    ``HOROVOD_HIERARCHICAL``, and the legacy
    ``HOROVOD_HIERARCHICAL_ALLREDUCE``/``_ALLGATHER`` read as ``on``:

    * ``off``: always None;
    * ``on``: the split whenever one resolves (an explicit
      ``HOROVOD_INTRA_SIZE`` works on one host);
    * ``auto``: the split only on positive evidence of a second level:
      an explicit intra size, or a launcher whose ``HOROVOD_LOCAL_SIZE``
      and ``HOROVOD_CROSS_SIZE`` are both above 1.

    ``world`` defaults to the initialized world's size (1 before
    ``init``); ``intra`` to the intra size, the launcher's local size,
    or the initialized topology's. An intra size that does not divide
    the world degrades to the gcd; a split of one node or of one rank
    a node is no split."""
    from . import basics

    st = basics.state()
    cfg = st.config if st.initialized else TrainConfig.from_env()
    topo = st.topology if st.initialized else None
    if mode is None:
        mode = cfg.hierarchical
        if (cfg.hierarchical_allreduce or cfg.hierarchical_allgather) \
                and mode != "off":
            mode = "on"
    if mode == "off":
        return None
    if world is None:
        world = topo.size if topo is not None else 1
    if intra is None:
        launcher = (cfg.local_size or 0) > 1 and (cfg.cross_size or 0) > 1
        if mode == "auto" and cfg.intra_size is None and not launcher:
            return None
        if cfg.intra_size is not None:
            intra = cfg.intra_size
        elif cfg.local_size is not None:
            intra = cfg.local_size
        else:
            intra = topo.local_size if topo is not None else world
    local = gcd_degrade(int(intra), int(world))
    if local <= 1 or local >= world:
        return None
    return stage_ranks(int(world), local)


def stage_ranks(size: int, local: int) -> Tuple[List[List[int]],
                                                List[List[int]]]:
    """Rank lists of the two-level split: one intra list per node, one
    inter list per node-local slot. Summing over the intra lists, then
    over the inter lists, is the flat world sum."""
    nodes = size // local
    intra = [list(range(n * local, (n + 1) * local)) for n in range(nodes)]
    inter = [[i + n * local for n in range(nodes)] for i in range(local)]
    return intra, inter


def stage_groups(topo: Topology, new_group: Callable):
    """``(intra, inter)``: the groups of the two-level split that hold
    this rank, made with ``new_group(ranks)`` (collective: every rank
    makes every group, in the same order). None for a world of one."""
    if topo.size == 1:
        return None, None
    intra_lists, inter_lists = stage_ranks(topo.size, topo.local_size)
    mine = {}
    for kind, lists in (("intra", intra_lists), ("inter", inter_lists)):
        for ranks in lists:
            group = new_group(ranks)
            if topo.rank in ranks:
                mine[kind] = group
    return mine["intra"], mine["inter"]


def hierarchical_stage_groups(world: int, local: int):
    """The two-level rank lists ``(intra, inter)`` for ``local`` ranks a
    slice, or None when the split degenerates (one slice, slices of one
    rank, or a ``local`` that does not divide ``world``); the JAX
    package's ``hierarchical_stage_groups``."""
    if local <= 1 or world <= local or world % local:
        return None
    return stage_ranks(int(world), int(local))


def stage_positions(groups) -> np.ndarray:
    """``[world]`` int32: each rank's index within its group of
    ``groups`` (position-j members of every group exchange chunk j)."""
    world = sum(len(g) for g in groups)
    pos = np.zeros(world, dtype=np.int32)
    for g in groups:
        for j, r in enumerate(g):
            pos[r] = j
    return pos
