"""Named multi-axis meshes over ``torch.distributed`` process groups.

The counterpart of ``horovod_tpu/parallel/mesh.py``: the same
:class:`MeshSpec` (fields, :data:`AXIS_ORDER`, ``size``, ``auto`` and
their errors). Where the JAX ``build`` returns a device ``Mesh`` whose
axes collectives name, here each rank is its own process, so
:meth:`MeshSpec.build` returns a :class:`Mesh` holding this rank's
coordinate on each axis and one process group per axis, and one per
combination of axes that a step reduces over (:data:`COMBOS`).

Rank ``r`` of the mesh sits at the coordinate of ``r`` in the row-major
grid of :data:`AXIS_ORDER` (dp outermost, tp innermost), as the JAX mesh
reshapes its device list. Every group is made in :meth:`MeshSpec.build`,
in one fixed order, on every rank of the world (``dist.new_group`` is
collective: a group made lazily, or in an order that depends on the
rank, deadlocks the world). A group of one member is never made, and one
spanning the world is the world's own.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch.distributed as dist

# Outer→inner order: dp spans hosts first, tp stays innermost.
AXIS_ORDER = ("dp", "pp", "ep", "sp", "tp")
# combinations of axes a composed step reduces over (the loss over the
# data axes; the gradients of expert-sharded leaves over dp and sp)
COMBOS = (("dp", "ep", "sp"), ("dp", "sp"))


class Axis(NamedTuple):
    """One axis (or combination of axes) as this rank sees it: its
    process group (None when it has one member), the global ranks along
    it in axis order, this rank's position there, and every instance's
    rank list (each rank of the mesh lies on exactly one)."""

    name: str
    group: object
    ranks: Tuple[int, ...]
    index: int
    size: int
    instances: Tuple[Tuple[int, ...], ...]


def world_axis() -> Axis:
    """The whole world as one axis (what a collective means when it names
    no axis)."""
    n, me = dist.get_world_size(), dist.get_rank()
    ranks = tuple(range(n))
    return Axis("world", dist.group.WORLD if n > 1 else None, ranks, me, n,
                (ranks,))


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    dp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.ep * self.sp * self.tp

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(getattr(self, a) for a in AXIS_ORDER)

    def build(self, ranks: Optional[Sequence[int]] = None) -> "Mesh":
        """The mesh over ``ranks`` (global ranks in mesh order; default
        the whole world). Every rank of the world calls it, members or
        not: it makes the process groups."""
        ranks = list(range(dist.get_world_size()) if ranks is None
                     else ranks)
        if len(ranks) != self.size:
            raise ValueError(
                f"mesh spec {self} needs {self.size} devices, "
                f"got {len(ranks)}"
            )
        return Mesh(self, ranks)

    @staticmethod
    def auto(
        n_devices: int,
        tp: Optional[int] = None,
        sp: int = 1,
        pp: int = 1,
        ep: int = 1,
    ) -> "MeshSpec":
        """Factor n_devices into a sensible default: fix the model axes,
        give the remainder to dp (the reference's only axis)."""
        tp = tp if tp is not None else 1
        denom = tp * sp * pp * ep
        if n_devices % denom != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by tp*sp*pp*ep={denom}"
            )
        return MeshSpec(dp=n_devices // denom, pp=pp, ep=ep, sp=sp, tp=tp)


def _instances(shape, names: Tuple[str, ...], ranks) -> list:
    """Rank lists of every instance of the axes ``names``: for each
    coordinate of the other axes, the ranks along ``names`` in
    row-major order."""
    along = [AXIS_ORDER.index(a) for a in names]
    other = [i for i in range(len(AXIS_ORDER)) if i not in along]
    out = []
    for fixed in itertools.product(*(range(shape[i]) for i in other)):
        members = []
        for moving in itertools.product(*(range(shape[i]) for i in along)):
            coord = [0] * len(AXIS_ORDER)
            for i, c in zip(other, fixed):
                coord[i] = c
            for i, c in zip(along, moving):
                coord[i] = c
            flat = 0
            for i, c in enumerate(coord):
                flat = flat * shape[i] + c
            members.append(ranks[flat])
        out.append(tuple(members))
    return out


class Mesh:
    """A built :class:`MeshSpec`: ``coords`` (this rank's coordinate on
    each axis, None off the mesh), ``member``, and :meth:`axis` for one
    axis or a combination of :data:`COMBOS`."""

    def __init__(self, spec: MeshSpec, ranks):
        self.spec = spec
        self.ranks = tuple(int(r) for r in ranks)
        self.shape = spec.shape
        me = dist.get_rank()
        self.member = me in self.ranks
        self.coords: Dict[str, Optional[int]] = dict.fromkeys(AXIS_ORDER)
        if self.member:
            flat = self.ranks.index(me)
            for a, n in zip(reversed(AXIS_ORDER), reversed(self.shape)):
                self.coords[a] = flat % n
                flat //= n
        world = tuple(range(dist.get_world_size()))
        made: Dict[Tuple[int, ...], object] = {}
        self._axes: Dict[Tuple[str, ...], Axis] = {}
        for names in [(a,) for a in AXIS_ORDER] + list(COMBOS):
            names = tuple(a for a in AXIS_ORDER if a in names)
            lists = _instances(self.shape, names, self.ranks)
            mine = None
            for members in lists:  # the same order on every rank
                if members not in made:
                    if len(members) == 1:
                        made[members] = None
                    elif members == world:
                        made[members] = dist.group.WORLD
                    else:
                        made[members] = dist.new_group(list(members))
                if me in members:
                    mine = members
            if mine is not None:
                self._axes[names] = Axis(
                    "+".join(names), made[mine], mine, mine.index(me),
                    len(mine), tuple(lists))

    def size(self, name: str) -> int:
        return self.shape[AXIS_ORDER.index(name)]

    def axis(self, *names: str) -> Axis:
        """The :class:`Axis` of one mesh axis, or of several together
        (any order; they are taken in :data:`AXIS_ORDER`). Only members
        of the mesh have axes, and a combination must be one of
        :data:`COMBOS`."""
        key = tuple(a for a in AXIS_ORDER if a in names)
        if len(key) != len(set(names)) or not key:
            raise ValueError(f"unknown mesh axes {names}; the axes are "
                             f"{AXIS_ORDER}")
        if not self.member:
            raise ValueError(f"rank {dist.get_rank()} is not on this mesh")
        if key not in self._axes:
            raise ValueError(
                f"no process group was built for the axes {key}; the "
                f"combinations are {COMBOS}")
        return self._axes[key]
