"""Tensor fusion: batch pending collectives into few large ones.

The core of ``horovod_tpu/ops/fusion.py`` on ``torch.distributed``:

- Allreduce entries of one fusion key (dtype, device, op, pre/postscale
  factors, process set, wire, join mask) are packed (``_pack``) into one
  flat buffer up to ``threshold_bytes``, as ``_batches_by_threshold``
  cuts a group: a batch closes when the next unit would push it past the
  threshold, an entry over the threshold goes alone, and a grouped
  allreduce is one indivisible unit. Batches are cut as entries arrive,
  so the gradient hooks of a backward pass put collectives in flight
  while the pass runs.
- One collective runs per batch with ``async_op=True``. For CUDA
  tensors NCCL runs it on its own stream, ordered after the pack on the
  current stream; for CPU tensors gloo runs it on its own thread.
- ``Handle.wait`` waits on the batch's work (the current stream waits
  on NCCL's for CUDA tensors, without a host sync) and unpacks
  (``_unpack``) the batch into every entry's output, applying Average's
  division by the set's size and the postscale once over the flat
  buffer.
- Allgather, broadcast and alltoall go one collective per entry; a
  grouped reducescatter is one collective over its members' per-rank
  panes. Adasum entries go one per entry too, never fused
  (``fusion.py:628-637``): Adasum's coefficients are per tensor. Each
  runs ``ops/adasum.py``.
- The wire of an allreduce batch is ``fp32`` (the payload's own width),
  ``bf16`` (fp32 payloads cast for the collective) or ``int8``: the
  entry's compressor names it, else the manager's ``HOROVOD_FUSION_WIRE``.
  The int8 wire (:meth:`FusionManager._allreduce_q`, the JAX package's
  ``_core_allreduce_q``) block-quantizes the batch's per-peer chunks on
  kernel B3, exchanges int8 values and fp32 scales with
  ``all_to_all_single``, sums the dequantized chunks in fp32, quantizes
  the reduced shard on B3 again and allgathers it; the prescale folds
  into the stage-1 wire scales. Sum and Average of floating payloads
  only: Min, Max, Product and integers ride the exact wire. With
  ``return_residual`` the batch also yields the error-feedback residual
  in input units, per entry. Its plain-PyTorch passes run inside
  ``torch.profiler`` ranges named
  ``hvd.int8_wire.{pack,exchange,dequantize_sum,residual,unpack}``
  (``WIRE_RANGES``), so a profiled step splits the wire's device time by
  pass.
- **The two-level route** (:meth:`FusionManager._allreduce_hier`, the
  JAX package's ``hierarchical_allreduce_groups``): a Sum or Average
  batch of floating payloads over the whole world, with no join mask,
  reduce-scatters within its node (the intra group), reduces its 1/L
  shard across nodes (the inter group) and allgathers within its node.
  ``intra_wire`` names both intra hops and ``wire`` the inter hop. The
  routing decision is :func:`~..common.topology.hierarchy_stages`'s:
  ``HOROVOD_HIERARCHICAL`` for every such batch, or an explicit request
  (``Compression.hier_int8``, ``HOROVOD_FUSION_WIRE_HIER`` with the int8
  wire) whenever a split resolves. An explicit int8 request takes bf16
  on the intra hops and B3's two-stage int8 recipe over the inter group
  (``traced.py:_quantized_sum_groups``); its residual is the inter
  stage's, allgathered over the node and divided by L, in input units.
  A batch that asks for a residual from the eager API rides the flat
  int8 wire, as the JAX package routes it; ``DistributedOptimizer``'s
  error feedback on ``Compression.hier_int8`` (``two_level``) takes the
  two-level route, as the JAX optimizer does. A process set or a join
  mask keeps the batch flat.
- **Local SGD** (``local_sgd.py``, ``horovod_tpu/ops/fusion.py:993-1030``):
  while a local phase is active (``local_sgd.local_phase``), a Sum or
  Average allreduce with no join mask and no process set reduces within
  its intra group only, Average dividing by the group's size: the
  two-level route is off, and an ``int8_hier`` request, whose int8 was
  for the inter hop, rides bf16 (``DistributedOptimizer``'s own
  ``hier_int8`` entries keep int8 within the group, as the JAX
  optimizer's grouped wire does). The optimizer in local mode names its
  intra groups on every entry itself. The groups are resolved at
  enqueue and are part of the fusion key, so a batch never mixes
  entries of either side of a phase switch; ``local_dispatches`` counts
  such batches.
- **Join** (``join_mask``): a masked allreduce batch zeroes the joined
  ranks' contributions (the identity of Min, Max and Product), on the
  exact and the int8 wire, and Average divides by the active count.
- Reducescatter and allgather take the two-level recipes too
  (``traced.py:1216-1315``) when ``hierarchy_stages`` resolves for the
  world: an intra reduce-scatter of the panes that share this rank's
  node-local slot, then an inter one; an inter allgather, then an intra
  one, reordered to rank order.
- An allreduce entry may ask for the grad guard's sentinel
  (``guard=True``, the optimizer's ``grad_guard``): its floating batch
  then also yields one ``all(isfinite)`` flag over the reduced flat
  buffer (``horovod_tpu/ops/fusion.py:1168``), a device tensor that
  :meth:`Handle.finite` returns without a host read. Integer batches
  have no flag. With ``HOROVOD_GUARD=1`` (``FusionManager(guard=True)``)
  every floating batch but an alltoall's yields one, the eager guard:
  the manager keeps each, unread, when the batch's outputs are made
  (the 256 newest), and :meth:`FusionManager.guard_poll`, which
  ``hvd.guard_check()`` calls, reads them and counts the non-finite
  batches into ``guard.nonfinite_batches``.
- The ``fusion.dispatch`` fault site (``testing/chaos.py``) fires once a
  batch, before its launch: from :meth:`FusionManager.flush` or from an
  enqueue that closes a batch, since the port cuts batches as entries
  arrive. ``reset``, ``timeout`` and ``5xx`` raise
  ``HorovodInternalError`` (and so do the batch's handles); ``nan``
  poisons element 0 of the batch's first floating payload.
- ``dispatched_batches``/``dispatched_bytes`` count the collectives
  issued and the bytes they carried, by the JAX package's payload-width
  model (``_hop_bytes``: an int8 batch of ``elems`` elements over ``n``
  ranks carries ``elems + nb·(n+1)·4`` bytes, ``nb`` blocks a chunk);
  ``wire_bytes_saved`` and ``quant_blocks`` add up what the int8 and
  bf16 wires saved against the payload width, ``last_wire_format`` names
  the last batch's wire (the inter hop's on the two-level route). A
  two-level batch also splits the model by hop (``_account_wire``): the
  intra hop carries the whole buffer at ``intra_wire``, the inter hop
  the 1/L shard at ``wire``, in ``wire_bytes_intra``/``_inter``,
  ``wire_bytes_saved_intra``/``_inter`` and
  ``last_wire_format_intra``/``_inter``; ``hier_dispatches`` counts
  them. The port counts this rank's bytes; the JAX package, one
  controller for all ranks, counts every rank's row. Beside the model,
  ``handed_bytes_intra``/``_inter`` count what a two-level batch hands
  each hop's collectives (the numel × itemsize of every input): the
  intra hops get the padded buffer, its 1/L shard and, with a
  residual, the fp32 residual shard; the int8 inter hop both stages'
  values and scales.

Collectives are issued in enqueue order, so every rank must enqueue the
same entries in the same order (the gradient hooks of identical models
do). The int8 wire's rounding seed, folded with the rank, is equal on
every rank for the same reason. An entry that carries a ``seed`` base
(``DistributedOptimizer``'s: its update count times its parameter
count, which its ``state_dict`` carries) takes the base plus the
batch's index among the batches of that base, so a resume or a re-init
continues the stream instead of replaying it. A bare ``hvd.allreduce``
takes a per-dispatch counter of this manager, which starts at 0 in
every ``init()``: its stream is the process's, not the job's. Left for
ROADMAP A3: the exact and bucket executor tiers.

**Cycles and observability** (``horovod_tpu/ops/fusion.py:543-720``).
A cycle is a :meth:`FusionManager.flush` that finds work (pending
entries, or batches dispatched since the last cycle); the port's fusion
ticks at poll/wait/step/flush, never by the clock. The manager feeds:

- the timeline (``common/timeline.py``, while one is attached):
  ``QUEUE`` from enqueue to the batch's dispatch, the op phase around
  the dispatch, ``MEMCPY_IN_FUSION_BUFFER`` around the pack and
  ``MEMCPY_OUT_FUSION_BUFFER`` around the unpack of a batch of more than
  one tensor, a ``CYCLE`` mark a cycle and the per-cycle counters
  (``fusion.pad_bytes``, ``fusion.dispatches``,
  ``fusion.wire_bytes_saved``, ``fusion.wire_format``). While a
  timeline is active each batch is waited on and the card synchronized
  once, for its ``<OP>_DEVICE`` span: the JAX package's rule, a cost
  only a watched run pays;
- the stall inspector: ``record_enqueue`` at enqueue,
  ``record_complete`` when the handle's output is made, ``check()``
  once a cycle (dict operations, no device read, no lock held across a
  launch);
- the metrics registry (``fusion.*``, ``alltoall.*``) once a cycle;
- the parameter manager (``HOROVOD_AUTOTUNE``): each cycle adds its
  useful bytes and its seconds, from its first enqueue to its end, to
  the step's; :meth:`FusionManager.end_step`, called at each step of a
  world ``DistributedOptimizer`` and at ``hvd.step_end()``, hands the
  step to the manager as one record and applies its threshold (a
  ``step_end`` right after an optimizer's step records nothing more). At
  a sample's boundary the manager synchronizes the card and takes the
  world's maximum (``autotune.agree_sample``). Steps, not cycles: every
  rank takes the same steps, while a process set's batches add cycles
  on its members only, so every rank proposes, and applies, the same
  threshold at the same step.

**The tuned wire** (``HOROVOD_FUSION_WIRE=auto``, ``fusion.py:883-1030``):
a Sum or Average batch of floating payloads takes its wire at dispatch
from the :class:`~..common.autotune.WireTuner` of its bucket tier
(``("allreduce", 2**ceil(log2(elems)), dtype)``, per hop on the
two-level route, the intra hop choosing between fp32 and bf16 only; a
process set's batches key by its ranks too, ``autotune.group_key``). A
dispatch whose (tier, wire) still needs trials is a trial: the manager
waits for the batches in flight and synchronizes the card, dispatches,
waits for the batch and synchronizes again, takes the maximum of the
seconds over the batch's group (one small CPU collective), and records
useful bytes over those seconds. Every rank of the group so records the
same numbers under a key only that group's batches use, and makes the
same choices; the tuner starts from the world's agreed state
(``autotune.adopt``). A residual asks for int8, and anything the int8
wire cannot take rides fp32, as in the JAX package.

**The schedule audit** (``HOROVOD_SCHED_AUDIT``, on by default;
``horovod_tpu/ops/fusion.py:1139-1160,2155``): each dispatch, its wire
resolved, folds into ``analysis/sched_audit.py``'s rolling fingerprint
under the JAX package's key: ``<kind>:<op>`` (``alltoall`` alone), then
``(family, entry names, shapes, dtype)`` with each shape rank-major
(``(world, *shape)``, the JAX payload's), an auto-name's counter
dropped (:func:`_sched_entry_name`) and the caller's dtype where a
compressor cast the payload (``src_dtype``), then the wire (``<intra>/<inter>``
on the two-level route) and the process set's id. A batch of the same
entries so folds to the same digest in both packages; the port sends
allgather, broadcast and Adasum one entry a collective, the JAX package
fuses them, so those agree when a batch holds one entry.
"""

from __future__ import annotations

import dataclasses
import math
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..analysis import sched_audit
from ..common import autotune, basics
from ..common import topology as topo_mod
from ..common.logging import get_logger
from ..common.process_sets import ProcessSet
from . import int8_wire
from ._collectives import gather_into, scatter_reduce_into
from .adasum import adasum_allreduce
from .int8_wire import WIRE_RANGES
from .traced import _exchange, _mine
from .reduction_ops import Adasum, Average, Max, Min, Product, ReduceOp, Sum

_log = get_logger("fusion")

_DIST_OPS = {
    Average: dist.ReduceOp.SUM,
    Sum: dist.ReduceOp.SUM,
    Min: dist.ReduceOp.MIN,
    Max: dist.ReduceOp.MAX,
    Product: dist.ReduceOp.PRODUCT,
}


_SCHED_NONAME = re.compile(r"^(\w+)\.noname\.\d+(\..+)?$")


def _sched_entry_name(name: str) -> str:
    """An entry's name as the schedule fingerprint folds it: an
    automatic ``<op>.noname.<counter>`` becomes ``<op>`` (the counter
    only restates the dispatch order, and a rejoined worker restarts
    it), a grouped member's ``<op>.noname.<counter>.<i>`` keeps its
    index ``<i>``, a caller's name stays as it is (the JAX package's
    ``_sched_entry_name``)."""
    m = _SCHED_NONAME.match(name or "")
    if m is None:
        return name or ""
    return m.group(1) + (m.group(2) or "")


def _sched_record(entries) -> None:
    """Fold one dispatch into the schedule audit (module docstring)."""
    e0 = entries[0]
    world = dist.get_world_size()
    dtype = _dtype_name(e0.src_dtype or e0.tensor.dtype)
    ps = e0.process_set
    pset = 0 if ps is None else ps.process_set_id
    if e0.kind == "alltoall":
        sched_audit.record(
            "alltoall", (_sched_entry_name(e0.name),
                         (world,) + tuple(e0.tensor.shape), dtype),
            wire=e0.wire, pset=pset)
        return
    family = e0.kind
    if e0.op == Adasum and not _is_world(ps):
        family = "adasum_pset"
    wire = e0.wire if e0.kind == "allreduce" else None
    if e0.hier:
        wire = f"{e0.intra_wire}/{e0.wire}"
    sched_audit.record(
        f"{e0.kind}:{int(e0.op)}",
        (family, tuple(_sched_entry_name(e.name) for e in entries),
         tuple((world,) + tuple(e.tensor.shape) for e in entries), dtype),
        wire=wire, pset=pset)


@dataclasses.dataclass(eq=False)
class _Entry:
    """One pending collective (the reference's TensorTableEntry)."""

    # "allreduce" | "allgather" | "broadcast" | "reducescatter" | "alltoall"
    kind: str
    tensor: torch.Tensor
    name: str
    op: ReduceOp = Average
    prescale: float = 1.0
    postscale: float = 1.0
    root_rank: int = 0
    process_set: Optional[ProcessSet] = None
    handle: Optional["Handle"] = None
    # allreduce wire: None defers to the manager's; resolved at enqueue
    # ("int8_hier" asks for the two-level placement explicitly)
    wire: Optional[str] = None
    wire_block: Optional[int] = None
    want_residual: bool = False
    guard: bool = False  # the batch yields a non-finite sentinel
    # the join mask over the world's ranks (True: contributes)
    mask: Optional[Tuple[bool, ...]] = None
    # DistributedOptimizer's hier_int8 residual batch: two-level route
    two_level: bool = False
    # local SGD: the intra groups the batch reduces within (the
    # optimizer's, or the active phase's, resolved at enqueue)
    local: Optional[Tuple[Tuple[int, ...], ...]] = None
    # resolved at enqueue: the two-level route and its intra hops' wire
    hier: bool = False
    intra_wire: Optional[str] = None
    splits: Optional[List[int]] = None  # alltoall: rows sent to each rank
    # the int8 wire's seed base (DistributedOptimizer's); None: the
    # manager's per-dispatch counter
    seed: Optional[int] = None
    # the caller's dtype where a compressor cast the payload for the wire
    # (the schedule audit folds it, as the JAX package folds its payload's)
    src_dtype: Optional[torch.dtype] = None

    @property
    def nbytes(self) -> int:
        return self.tensor.numel() * self.tensor.element_size()

    def key(self) -> Tuple:
        ps = self.process_set
        return (self.kind, self.tensor.dtype, self.tensor.device, int(self.op),
                self.prescale, self.postscale, self.root_rank,
                None if ps is None else ps.process_set_id, self.wire,
                self.wire_block, self.want_residual, self.guard, self.mask,
                self.local, self.hier, self.intra_wire, self.seed is None)


def _is_world(ps: Optional[ProcessSet]) -> bool:
    return ps is None or ps.process_set_id == 0


def _group(ps: Optional[ProcessSet]):
    return None if _is_world(ps) else ps.group


def _set_size(ps: Optional[ProcessSet]) -> int:
    return dist.get_world_size() if _is_world(ps) else ps.size


def _pack(entries: List[_Entry]) -> torch.Tensor:
    """Flatten and concatenate the batch into a fresh flat buffer (the
    collective reduces it in place; the inputs stay untouched)."""
    return torch.cat([e.tensor.reshape(-1) for e in entries])


def _rank_in(ps: Optional[ProcessSet]) -> int:
    r = dist.get_rank()
    return r if _is_world(ps) else ps.rank_in_set(r)


def _scope(e0: _Entry) -> Tuple[int, int]:
    """(the size of the ranks the batch reduces over, this rank's place
    among them): its intra group under local SGD, else its set."""
    if e0.local is not None:
        _, me, n = _mine(e0.local)
        return n, me
    return _set_size(e0.process_set), _rank_in(e0.process_set)


def _active(e0: _Entry) -> Tuple[bool, int]:
    """(whether this rank contributes, how many ranks of the batch's set
    contribute) under the batch's join mask."""
    if e0.local is not None:
        return True, len(e0.local[0])
    ps = e0.process_set
    members = range(dist.get_world_size()) if _is_world(ps) else ps.ranks
    if e0.mask is None:
        return True, len(members)
    return (e0.mask[dist.get_rank()],
            max(sum(1 for r in members if e0.mask[r]), 1))


def _identity(flat: torch.Tensor, op: ReduceOp) -> torch.Tensor:
    """``flat`` filled with the identity of ``op`` (a joined rank's
    contribution)."""
    if op == Product:
        return flat.fill_(1)
    if op in (Min, Max):
        info = (torch.finfo if flat.is_floating_point() else torch.iinfo)(
            flat.dtype)
        return flat.fill_(info.max if op == Min else info.min)
    return flat.zero_()


def _stage(x: torch.Tensor, wire: str) -> torch.Tensor:
    """``x`` on one hop's wire: bf16 narrows fp32 payloads."""
    return x.to(torch.bfloat16) if (
        wire == "bf16" and x.dtype == torch.float32) else x


def _scale_out(flat: torch.Tensor, count: int, op: ReduceOp,
               postscale: float, masked: bool = False) -> torch.Tensor:
    """Average's division by ``count``, then the postscale, in place, in
    the JAX package's arithmetic: XLA turns its division by the static
    set size into one multiply by ``postscale / count``, while a join
    mask's live count is a true division."""
    if masked and op == Average and flat.is_floating_point():
        flat.div_(count)
        op = Sum
    post = postscale / count if op == Average else postscale
    if post != 1.0:
        if flat.is_floating_point():
            flat.mul_(post)
        else:
            flat.copy_(torch.trunc(flat.double() * post))
    return flat


def hop_bytes(elems: int, wire: str, itemsize: int, n: int, block: int):
    """Payload-width model of one allreduce's wire bytes and quantization
    blocks (the JAX package's ``FusionManager._hop_bytes``): ``elems``
    elements at ``wire`` over ``n`` ranks; int8 adds both stages' block
    scales."""
    if wire == "bf16":
        return elems * 2, 0
    if wire == "int8":
        chunk = -(-elems // max(n, 1))
        nb = -(-chunk // block)
        return elems + nb * (n + 1) * 4, nb * (n + 1)
    return elems * itemsize, 0


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _finite(e0: _Entry, flat: torch.Tensor) -> Optional[torch.Tensor]:
    """The guard's sentinel of a reduced batch: one device bool, or None
    when the batch asked for none or carries integers."""
    if not e0.guard or not flat.is_floating_point():
        return None
    return torch.isfinite(flat).all()


def _unpack(flat: torch.Tensor, entries: List[_Entry]) -> List[torch.Tensor]:
    """Views of the flat buffer in each entry's shape."""
    out, off = [], 0
    for e in entries:
        n = e.tensor.numel()
        out.append(flat[off:off + n].view(e.tensor.shape))
        off += n
    return out


def _memcpy(tl, entries: List[_Entry], phase: str, fn):
    """``fn()`` inside the timeline's ``phase`` for a batch of more
    than one tensor (the fusion buffer's copy in or out)."""
    if tl is None or len(entries) < 2:
        return fn()
    for e in entries:
        tl.begin(e.name, phase)
    out = fn()
    for e in entries:
        tl.end(e.name, phase)
    return out


_IN, _OUT = "MEMCPY_IN_FUSION_BUFFER", "MEMCPY_OUT_FUSION_BUFFER"


def _rows(n_rows: int, n: int, j: int) -> Tuple[int, int]:
    """(offset, count) of rank j's rows when ``n_rows`` rows scatter over
    n ranks, the earlier ranks taking one extra row."""
    base, rem = divmod(n_rows, n)
    return j * base + min(j, rem), base + (j < rem)


class _Works:
    """The works of one batch's collectives, waited together."""

    def __init__(self, *works):
        self._works = works

    def is_completed(self) -> bool:
        return all(w.is_completed() for w in self._works)

    def wait(self) -> None:
        for w in self._works:
            w.wait()


class _Batch:
    """A dispatched collective; ``finish`` holds what it needs to make
    the outputs and is let go once it has made them. ``note`` takes the
    batch's sentinel once it is made (the manager's eager guard)."""

    def __init__(self, work, finish, note=None):
        self.work = work
        # () -> (list of outputs, sentinel or None), after work.wait()
        self._finish = finish
        self._note = note
        self._outputs: Optional[List[torch.Tensor]] = None
        self.finite: Optional[torch.Tensor] = None
        self._lock = threading.Lock()

    def done(self) -> bool:
        work = self.work  # None once the outputs are made
        return work is None or work.is_completed()

    def wait(self) -> None:
        with self._lock:
            if self.work is not None:
                self.work.wait()

    def output(self, index: int) -> torch.Tensor:
        with self._lock:
            if self._outputs is None:
                self.work.wait()
                self._outputs, self.finite = self._finish()
                self.work = self._finish = None
                if self._note is not None and self.finite is not None:
                    self._note(self.finite)
        return self._outputs[index]


class Handle:
    """Async completion handle (``fusion.py:131-158``). ``poll`` never
    blocks; ``wait`` waits and returns the output. Either one, on an
    entry still queued, first runs a cycle: it dispatches everything
    pending. The JAX package ticks its cycle by the clock
    (``HOROVOD_CYCLE_TIME``); with one process per rank a clock would cut
    batches differently on different ranks, so the port ticks at these
    calls, which every rank reaches after the same enqueues."""

    def __init__(self, fusion: "FusionManager", name: str = ""):
        self._fusion = fusion
        self._name = name  # the stall inspector's key
        self._batch: Optional[_Batch] = None
        self._index = 0  # the entry's place in its batch
        # the fault that dropped the entry's batch before its launch
        self._error: Optional[Exception] = None

    def _dispatched(self) -> _Batch:
        if self._batch is None and self._error is None:
            self._fusion.flush()
        if self._error is not None:
            raise self._error
        return self._batch

    def poll(self) -> bool:
        return self._dispatched().done()

    def wait(self) -> torch.Tensor:
        out = self._dispatched().output(self._index)
        self._fusion._forget(self._batch)
        insp = self._fusion.stall_inspector
        if insp is not None:
            insp.record_complete(self._name)
        return out

    def finite(self) -> Optional[torch.Tensor]:
        """The batch's non-finite sentinel (a device bool, True when
        every reduced value is finite) after :meth:`wait`; None unless
        the entry asked for it."""
        self.wait()
        return self._batch.finite


WIRES = ("fp32", "bf16", "int8")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rpartition(".")[2]


def _tier(elems: int) -> int:
    """A batch's bucket tier for the wire tuner's key: its element
    count rounded up to a power of two."""
    return 1 << max(int(elems) - 1, 0).bit_length()


@dataclasses.dataclass(frozen=True)
class _Split:
    """This rank's view of the two-level split: L ranks a node, H nodes,
    the groups built at ``init`` and its position in the inter group."""

    L: int
    H: int
    intra: object
    inter: object
    pos: int


class FusionManager:
    """Pending entries by fusion key, cut into batches by bytes."""

    def __init__(self, threshold_bytes: int, wire: str = "fp32",
                 wire_block: int = 512, wire_hier: bool = False,
                 wire_min_bytes: int = 64 * 1024, guard: bool = False):
        if wire not in WIRES + ("auto",):
            raise ValueError(f"fusion wire must be one of {WIRES} or auto, "
                             f"got {wire!r}")
        if int(wire_block) < 1:
            raise ValueError(f"wire block must be >= 1, got {wire_block}")
        self.threshold_bytes = int(threshold_bytes)
        self.wire = wire
        self.wire_block = int(wire_block)
        self.wire_hier = bool(wire_hier)
        self._lock = threading.RLock()
        self._pending: Dict[Tuple, List[List[_Entry]]] = {}
        self._pending_bytes: Dict[Tuple, int] = {}
        self._inflight: List[_Batch] = []
        self._splits: Dict[bool, Optional[_Split]] = {}
        self.dispatched_batches = 0
        self.dispatched_bytes = 0
        self.wire_bytes_saved = 0
        self.quant_blocks = 0
        self.last_wire_format = "fp32"
        self.hier_dispatches = 0
        self.wire_bytes_intra = 0
        self.wire_bytes_inter = 0
        self.wire_bytes_saved_intra = 0
        self.wire_bytes_saved_inter = 0
        self.last_wire_format_intra = "fp32"
        self.last_wire_format_inter = "fp32"
        self.handed_bytes_intra = 0
        self.handed_bytes_inter = 0
        self.local_dispatches = 0
        self._seed_counter = 0  # the int8 wire's per-dispatch seed
        self._seed_base = [None, 0]  # a seed base and its batches so far
        # observability, attached by basics.init (common/timeline.py,
        # stall_inspector.py, autotune.py)
        self.timeline = None
        self.stall_inspector = None
        self.parameter_manager = None
        self.ef_residual_norm = 0.0  # L2 of the last EF residual batch
        self._clock = time.monotonic
        self.cycles = 0
        self.flushed_bytes = 0  # useful payload bytes of allreduce batches
        self.alltoall_dispatches = 0
        self.alltoall_wire_bytes = 0
        self._cycle_t0: Optional[float] = None  # first enqueue this cycle
        self._cycle = [0, 0, 0]  # batches, useful bytes, bytes saved
        self._step = [0, 0.0, 0]  # the parameter manager's: bytes, s, wire
        # the tuned wire (HOROVOD_FUSION_WIRE=auto): trials taken, the
        # batches of each wire, and each tier's last choice
        self.wire_min_bytes = int(wire_min_bytes)
        self.wire_tuner = self._make_wire_tuner() if wire == "auto" else None
        self.wire_trials = 0
        self.wire_batches = {w: 0 for w in WIRES}
        self.wire_choices: Dict[Tuple, str] = {}
        # the eager guard (HOROVOD_GUARD): every floating batch's sentinel,
        # held as device bools until guard_poll() reads them
        self.guard = bool(guard)
        self._guard_flags: List[torch.Tensor] = []
        self._guard_lock = threading.Lock()
        # the last step the parameter manager recorded was an optimizer's
        # (end_step)
        self._optimizer_closed = False

    def _make_wire_tuner(self):
        """The per-dispatch WireTuner, started from the world's agreed
        ``HOROVOD_TUNER_CACHE`` state and persisted with it
        (``fusion.py:485-504``)."""
        tuner = autotune.WireTuner(min_int8_bytes=self.wire_min_bytes)
        autotune.adopt(tuner, "wire")
        return tuner

    def _wire_seed(self, e0: _Entry) -> int:
        """The int8 wire's seed for a batch led by ``e0``: its base plus
        the batch's index among that base's batches, else the
        per-dispatch counter."""
        if e0.seed is None:
            seed = self._seed_counter
            self._seed_counter += 1
            return seed
        if self._seed_base[0] != e0.seed:
            self._seed_base = [e0.seed, 0]
        seed = e0.seed + self._seed_base[1]
        self._seed_base[1] += 1
        return seed & 0xFFFFFFFF

    def _split(self, explicit: bool = False) -> Optional["_Split"]:
        """The two-level split a batch takes: ``hierarchy_stages`` in
        ``HOROVOD_HIERARCHICAL``'s mode, or in mode ``on`` for an
        explicit request; None when the wire stays flat. The groups are
        the ones ``init`` built from the same topology (its
        ``local_size`` is the split's L)."""
        if explicit not in self._splits:
            stages = topo_mod.hierarchy_stages(
                world=dist.get_world_size(),
                mode="on" if explicit else None)
            st = basics.state()
            self._splits[explicit] = None if stages is None else _Split(
                len(stages[0][0]), len(stages[1][0]), st.intra_group,
                st.inter_group, st.topology.cross_rank)
        return self._splits[explicit]

    def _resolve_wire(self, e: _Entry) -> None:
        """Fix the entry's wire, block and route: the int8 wire takes
        Sum and Average of floating payloads; anything else rides the
        exact wire, as the JAX package routes it (callers asking for a
        residual were checked at enqueue). A floating Sum or Average
        over the world with no join mask takes the two-level route when
        :meth:`_split` resolves (an explicit request: ``int8_hier``, or
        the int8 wire under ``HOROVOD_FUSION_WIRE_HIER``); a residual
        asked for from the eager API keeps the flat int8 wire. Under local
        SGD (the entry's groups, else the active phase's) the batch stays
        within its intra group (module docstring)."""
        wire = self.wire if e.wire is None else e.wire
        if (e.local is None and e.op in (Sum, Average) and e.mask is None
                and _is_world(e.process_set)):
            from .. import local_sgd

            e.local = local_sgd.active_intra_groups()
        if wire == "auto":
            # the batch's wire is the tuner's, at dispatch (_tune_wire)
            eligible = (e.op in (Sum, Average)
                        and e.tensor.is_floating_point())
            if e.want_residual:
                wire = "int8"
            elif not eligible:
                wire = "fp32"
            else:
                e.wire = "auto"
                return
        explicit = wire == "int8_hier" or (wire == "int8" and self.wire_hier)
        if wire == "int8_hier":
            wire = "int8" if e.local is None or e.two_level else "bf16"
        eligible = e.op in (Sum, Average) and e.tensor.is_floating_point()
        if wire == "int8" and not eligible and not e.want_residual:
            wire = "fp32"
        if wire == "bf16" and (not e.tensor.is_floating_point()
                               or e.tensor.element_size() > 4):
            wire = "fp32"  # fp32 payloads narrow; 2-byte ones already are
        e.hier = (eligible and e.mask is None and _is_world(e.process_set)
                  and e.local is None
                  and (not e.want_residual or e.two_level)
                  and self._split(explicit) is not None)
        e.wire = wire
        e.intra_wire = ("bf16" if wire == "int8" else wire) if e.hier \
            else None
        e.wire_block = (e.wire_block or self.wire_block) if wire == "int8" \
            else None

    def enqueue(self, entries: List[_Entry]) -> List[Handle]:
        """Queue ``entries`` as one unit (a grouped allreduce's members
        share one batch, a grouped reducescatter's one collective) and
        dispatch every batch the unit closes."""
        handles = []
        with self._lock:
            tl, insp = self.timeline, self.stall_inspector
            for e in entries:
                e.handle = Handle(self, e.name)
                handles.append(e.handle)
                if (self.guard and e.kind != "alltoall"
                        and e.tensor.is_floating_point()):
                    e.guard = True
                if tl is not None:
                    tl.begin(e.name, "QUEUE")
                if insp is not None:
                    insp.record_enqueue(e.name)
            if self._cycle_t0 is None:
                self._cycle_t0 = self._clock()
            kind = entries[0].kind
            if kind == "reducescatter":
                self._dispatch(entries)
                return handles
            if kind != "allreduce" or entries[0].op == Adasum:
                for e in entries:
                    self._dispatch([e])
                return handles
            for e in entries:
                self._resolve_wire(e)
            for key in dict.fromkeys(e.key() for e in entries):
                unit = [e for e in entries if e.key() == key]
                nbytes = sum(e.nbytes for e in unit)
                held = self._pending_bytes.get(key, 0)
                if held and held + nbytes > self.threshold_bytes:
                    self._dispatch_key(key)
                    held = 0
                self._pending.setdefault(key, []).append(unit)
                self._pending_bytes[key] = held + nbytes
                if held + nbytes >= self.threshold_bytes:
                    self._dispatch_key(key)
        return handles

    def flush(self) -> None:
        """Run a cycle: dispatch every pending batch, in enqueue order
        of its key, then publish the cycle (module docstring). A flush
        that finds no work is no cycle."""
        with self._lock:
            if not self._pending and self._cycle_t0 is None:
                return
            if self.timeline is not None:
                self.timeline.mark_cycle()
            if self.stall_inspector is not None:
                self.stall_inspector.check()
            for key in list(self._pending):
                self._dispatch_key(key)
            self._end_cycle()

    def stats(self) -> Dict[str, float]:
        """The ``fusion.*`` gauges (the JAX ``cache_stats`` names the
        port has; it has no executor cache, so no hits)."""
        from ..common.metrics import WIRE_FORMAT_CODES as codes

        return {
            "dispatches": self.dispatched_batches,
            "dispatched_bytes": self.dispatched_bytes,
            "cycles": self.cycles,
            "flushed_bytes": self.flushed_bytes,
            "wire_bytes_saved": self.wire_bytes_saved,
            "quant_blocks": self.quant_blocks,
            "hier_dispatches": self.hier_dispatches,
            "wire_bytes_saved_intra": self.wire_bytes_saved_intra,
            "wire_bytes_saved_inter": self.wire_bytes_saved_inter,
            "local_dispatches": self.local_dispatches,
            "wire_trials": self.wire_trials,
            "wire_format": codes.get(self.last_wire_format, 0),
            "wire_format_intra": codes.get(self.last_wire_format_intra, 0),
            "wire_format_inter": codes.get(self.last_wire_format_inter, 0),
        }

    def _end_cycle(self) -> None:
        """Close the cycle: the registry, the timeline's counters and
        the parameter manager's record (``fusion.py:646-717``)."""
        from ..common.metrics import WIRE_FORMAT_CODES, registry

        t0 = self._cycle_t0 if self._cycle_t0 is not None else self._clock()
        batches, useful, saved = self._cycle
        self._cycle_t0, self._cycle = None, [0, 0, 0]
        self.cycles += 1
        if _log.isEnabledFor(10):  # DEBUG: the cycle's numbers
            _log.debug("cycle %d: %d batches, %dB useful, %dB saved, "
                       "%.2fms", self.cycles, batches, useful, saved,
                       (self._clock() - t0) * 1e3)
        registry.update("fusion", self.stats())
        registry.gauge("alltoall.dispatches", self.alltoall_dispatches)
        registry.gauge("alltoall.wire_bytes", self.alltoall_wire_bytes)
        registry.gauge("fusion.last_flush_bytes", useful)
        registry.gauge("fusion.last_cycle_dispatches", batches)
        registry.gauge("fusion.last_cycle_wire_saved", saved)
        registry.maybe_dump()
        tl = self.timeline
        if tl is not None:
            tl.counter("fusion.pad_bytes", 0)
            tl.counter("fusion.dispatches", batches)
            tl.counter("fusion.wire_bytes_saved", saved)
            tl.counter("fusion.wire_format",
                       WIRE_FORMAT_CODES.get(self.last_wire_format, 0))
        if self.parameter_manager is not None:
            self._step[0] += useful
            self._step[1] += self._clock() - t0
            self._step[2] += max(useful - saved, 0)

    def end_step(self, source: str = "optimizer") -> None:
        """A step ended: a world ``DistributedOptimizer``'s step
        (``source="optimizer"``) or ``hvd.step_end()`` (``"step_end"``),
        which every rank reaches as often. The step's cycles make the
        parameter manager's one record, and its threshold applies from
        the next batch. A ``step_end`` right after an optimizer's step
        closes the step that step closed, and records nothing."""
        pm = self.parameter_manager
        if pm is None:
            return
        with self._lock:
            closed, self._optimizer_closed = (self._optimizer_closed,
                                              source == "optimizer")
            if source == "step_end" and closed:
                return
            useful, seconds, wire = self._step
            self._step = [0, 0.0, 0]
            pm.record(bytes_=useful, seconds=seconds, wire_bytes=wire)
            self.threshold_bytes = int(pm.current()[0])

    def _note_guard_flag(self, ok: torch.Tensor) -> None:
        """Keep a batch's sentinel without reading it; at most the 256
        newest are kept, so that a guard nobody polls holds no more
        (the poll is a health check, not an exact ledger)."""
        with self._guard_lock:
            self._guard_flags.append(ok)
            if len(self._guard_flags) > 256:
                del self._guard_flags[:len(self._guard_flags) - 256]

    def guard_poll(self) -> int:
        """Read the sentinels kept since the last poll (the host waits
        for them here, not at each batch), count the non-finite batches
        into ``guard.nonfinite_batches`` and return the count
        (``horovod_tpu/ops/fusion.py:1502-1523``). A batch's sentinel is
        kept when its outputs are made, at its handle's wait."""
        with self._guard_lock:
            flags, self._guard_flags = self._guard_flags, []
        bad = sum(1 for f in flags if not bool(f))
        if bad:
            from ..common.metrics import registry

            registry.counter("guard.nonfinite_batches", bad)
            _log.warning("non-finite values in %d fused batch(es) since the "
                         "last guard poll", bad)
        return bad

    def wait_all(self) -> None:
        """Wait for every dispatched batch."""
        with self._lock:
            batches, self._inflight = self._inflight, []
        for b in batches:
            b.wait()

    def _forget(self, batch: _Batch) -> None:
        """Take a batch whose outputs are made off the in-flight list:
        its handles hold them now, and the list would keep them until
        the next dispatch (past the optimizer's step)."""
        with self._lock:
            if batch in self._inflight:
                self._inflight.remove(batch)

    def _dispatch_key(self, key) -> None:
        units = self._pending.pop(key, [])
        self._pending_bytes.pop(key, None)
        if units:
            self._dispatch([e for unit in units for e in unit])

    def _tune_wire(self, entries: List[_Entry]) -> List[Tuple]:
        """Resolve an ``auto`` batch's wire from the tuner
        (``fusion.py:925-960``) and set the route as ``_resolve_wire``
        would for that wire; returns the (key, wire) pairs this dispatch
        is a trial for."""
        e0 = entries[0]
        elems = sum(e.tensor.numel() for e in entries)
        itemsize = e0.tensor.element_size()
        key = autotune.group_key(
            ("allreduce", _tier(elems), _dtype_name(e0.tensor.dtype)),
            _group(e0.process_set))
        tuner = self.wire_tuner  # made at construction: auto is the knob's
        hier = (e0.mask is None and _is_world(e0.process_set)
                and e0.local is None and self._split(False) is not None)
        if hier:
            plan = self._split(False)
            wire = tuner.choose(key + ("inter",),
                                payload_bytes=key[1] * itemsize // plan.L,
                                itemsize=itemsize)
            intra = tuner.choose(key + ("intra",),
                                 payload_bytes=key[1] * itemsize,
                                 itemsize=itemsize,
                                 candidates=("fp32", "bf16"))
            pairs = [(key + ("inter",), wire), (key + ("intra",), intra)]
        else:
            wire = tuner.choose(key, payload_bytes=key[1] * itemsize,
                                itemsize=itemsize)
            if e0.local is not None and wire == "int8":
                wire = "fp32"  # no int8 inside a slice; never a trial
            pairs = [] if e0.local is not None else [(key, wire)]
            intra = None
            if wire == "int8" and self.wire_hier and e0.mask is None \
                    and _is_world(e0.process_set) and e0.local is None:
                hier = self._split(True) is not None
                intra = "bf16" if hier else None
        for e in entries:
            e.wire = wire
            e.hier = hier
            e.intra_wire = intra if hier else None
            e.wire_block = (e.wire_block or self.wire_block) \
                if wire == "int8" else None
        for k, c in pairs:
            self.wire_choices[k] = c
        return [(k, c) for k, c in pairs if tuner.needs_trial(k, c)]

    def _drain(self) -> None:
        """Wait for every batch in flight and synchronize the card: a
        trial's clock then measures its own dispatch alone."""
        for b in list(self._inflight):
            b.wait()
        autotune.device_sync(basics.state().device)

    def _inject_fault(self, entries: List[_Entry]) -> None:
        """The ``fusion.dispatch`` fault site, once a batch before it
        is launched (``horovod_tpu/ops/fusion.py:573-600``). A transport
        fault raises ``HorovodInternalError``, the exception
        ``hvd.elastic.run`` restores from, and the batch's handles raise
        it too; ``nan`` writes NaN into element 0 of the batch's first
        floating payload (a copy: the caller's tensor stays as it was)."""
        from ..testing import chaos

        try:
            kind = chaos.inject("fusion.dispatch")
        except (ConnectionResetError, TimeoutError,
                chaos.InjectedServerError) as e:
            err = basics.HorovodInternalError(
                f"fusion.dispatch: {type(e).__name__}: {e}")
            for e_ in entries:
                e_.handle._error = err
            raise err from e
        if kind != "nan":
            return
        for e in entries:
            if e.tensor.is_floating_point():
                poisoned = e.tensor.detach().clone(
                    memory_format=torch.contiguous_format)
                poisoned.view(-1)[0] = float("nan")
                e.tensor = poisoned
                return

    def _dispatch(self, entries: List[_Entry]) -> None:
        e0 = entries[0]
        self._inject_fault(entries)
        trials: List[Tuple] = []
        if e0.kind == "allreduce" and e0.wire == "auto":
            trials = self._tune_wire(entries)
        if sched_audit.enabled():
            _sched_record(entries)
        tl = self.timeline
        phase = e0.kind.upper()
        if tl is not None:
            for e in entries:
                tl.begin(e.name, phase)
        if trials:
            self._drain()
        t_disp = self._clock()
        batch, group = self._launch(entries)
        if trials or (tl is not None and tl.active):
            batch.wait()
            autotune.device_sync(e0.tensor.device)
        if trials:
            seconds = autotune.agree_max([self._clock() - t_disp], group)[0]
            useful = (sum(e.nbytes for e in entries)
                      * _scope(e0)[0])
            for k, c in trials:
                self.wire_tuner.record(k, c, useful_bytes=useful,
                                       seconds=seconds)
            self.wire_trials += 1
        if tl is not None:
            if tl.active:
                dur_us = (self._clock() - t_disp) * 1e6
                t0_us = tl.now_us() - dur_us
                for e in entries:
                    tl.span(e.name, f"{phase}_DEVICE", t0_us, dur_us)
            for e in entries:
                tl.end(e.name, phase)
                tl.end(e.name, "QUEUE")

    def _launch(self, entries: List[_Entry]):
        """Issue the batch's collectives; returns the batch and the
        process group it runs over."""
        e0 = entries[0]
        ps = e0.process_set
        if ps is not None and not ps.included(dist.get_rank()):
            raise ValueError(
                f"{e0.kind} {e0.name!r}: rank {dist.get_rank()} is not a "
                f"member of {ps}"
            )
        group = _group(ps)
        if e0.kind == "allreduce" and e0.local is not None:
            group = _mine(e0.local)[0]
            self.local_dispatches += 1
        if e0.kind == "allreduce" and e0.op == Adasum:
            work, finish, nbytes = self._adasum(e0, ps)
        elif e0.kind == "allreduce" and e0.hier:
            work, finish, nbytes = self._allreduce_hier(entries)
        elif e0.kind == "allreduce" and e0.wire == "int8":
            work, finish, nbytes = self._allreduce_q(entries, group, ps)
        elif e0.kind == "allreduce":
            work, finish, nbytes = self._allreduce(entries, group, ps)
        elif e0.kind == "allgather":
            work, finish, nbytes = self._allgather(e0, group, ps)
        elif e0.kind == "reducescatter":
            work, finish, nbytes = self._reducescatter(entries, group, ps)
        elif e0.kind == "alltoall":
            work, finish, nbytes = self._alltoall(e0, group)
        elif e0.kind == "broadcast":
            buf = e0.tensor.detach().clone()
            work = dist.broadcast(buf, src=e0.root_rank, group=group,
                                  async_op=True)
            finish, nbytes = (lambda: ([buf], _finite(e0, buf))), e0.nbytes
        else:
            raise ValueError(f"unknown collective {e0.kind!r}")
        batch = _Batch(work, finish,
                       self._note_guard_flag if self.guard else None)
        # an entry lets go of its handle here: the handle holds the batch,
        # whose finish holds the entries, and a cycle among them would
        # keep the batch's device buffers until the cyclic collector ran
        for i, e in enumerate(entries):
            e.handle._batch, e.handle._index = batch, i
            e.handle = None
            if e.kind == "allreduce":
                # and of its payload, which the batch packed: a payload
                # made for the call (the optimizer's gradient plus its
                # residual) would otherwise live until the wait; the
                # unpack needs only its shape, dtype and device
                e.tensor = e.tensor.new_empty(()).expand(e.tensor.shape)
        self._inflight = [b for b in self._inflight if not b.done()]
        self._inflight.append(batch)
        self.dispatched_batches += 1
        self.dispatched_bytes += nbytes
        self._cycle[0] += 1
        if e0.kind == "allreduce":
            useful = sum(e.tensor.numel() for e in entries) \
                * e0.tensor.element_size()
            self.flushed_bytes += useful
            self._cycle[1] += useful
            self.wire_batches[e0.wire if e0.wire in WIRES else "fp32"] += 1
        return batch, group

    def _note_residuals(self, flat: torch.Tensor) -> None:
        """Error-feedback observability: the L2 norm of the batch's
        residuals (``flat``, every entry's carry packed in order), as
        the registry gauge and the timeline counter
        ``fusion.ef_residual_norm``. Only when a timeline or a metrics
        sink is watching: the norm is one host transfer."""
        from ..common.metrics import registry as _metrics

        if self.timeline is None and not _metrics.exporting:
            return
        self.ef_residual_norm = float(
            torch.linalg.vector_norm(flat.float()))
        _metrics.gauge("fusion.ef_residual_norm", self.ef_residual_norm)
        if self.timeline is not None:
            self.timeline.counter("fusion.ef_residual_norm",
                                  self.ef_residual_norm)

    def _account(self, elems: int, wire: str, itemsize: int, n: int,
                 block: int) -> int:
        """Count one flat allreduce batch's wire bytes and what its wire
        saved against the payload width; returns the wire bytes."""
        nbytes, blocks = hop_bytes(elems, wire, itemsize, n, block)
        saved = max(elems * itemsize - nbytes, 0)
        self.wire_bytes_saved += saved
        self._cycle[2] += saved
        self.quant_blocks += blocks
        self.last_wire_format = wire
        return nbytes

    def _account_wire(self, elems: int, itemsize: int, e0: _Entry,
                      plan: _Split) -> int:
        """Count one two-level batch by hop (``fusion.py:1404-1460``):
        the intra hop carries the whole buffer at ``intra_wire``, the
        inter hop the 1/L shard at ``wire``; returns both hops' bytes."""
        block = e0.wire_block or self.wire_block
        full = elems * itemsize
        intra, _ = hop_bytes(elems, e0.intra_wire, itemsize, plan.L, block)
        inter, blocks = hop_bytes(-(-elems // plan.L), e0.wire, itemsize,
                                  plan.H, block)
        self.quant_blocks += blocks
        self.wire_bytes_intra += intra
        self.wire_bytes_inter += inter
        self.wire_bytes_saved_intra += max(full - intra, 0)
        self.wire_bytes_saved_inter += max(full - inter, 0)
        self.wire_bytes_saved += max(full - intra - inter, 0)
        self._cycle[2] += max(full - intra - inter, 0)
        self.last_wire_format_intra = e0.intra_wire
        self.last_wire_format_inter = self.last_wire_format = e0.wire
        self.hier_dispatches += 1
        return intra + inter

    def _allreduce(self, entries, group, ps):
        e0 = entries[0]
        tl = self.timeline
        flat = _memcpy(tl, entries, _IN, lambda: _pack(entries))
        active, count = _active(e0)
        if not active:
            _identity(flat, e0.op)
        elif e0.prescale != 1.0:
            flat.mul_(e0.prescale)
        wire_buf = _stage(flat, e0.wire)
        work = dist.all_reduce(wire_buf, op=_DIST_OPS[e0.op], group=group,
                               async_op=True)

        def finish():
            if wire_buf is not flat:
                flat.copy_(wire_buf)
            _scale_out(flat, count, e0.op, e0.postscale,
                       e0.mask is not None)
            return (_memcpy(tl, entries, _OUT, lambda: _unpack(flat, entries)),
                    _finite(e0, flat))

        nbytes = self._account(flat.numel(), e0.wire, flat.element_size(),
                               _scope(e0)[0], self.wire_block)
        return work, finish, nbytes

    def _allreduce_hier(self, entries):
        """The two-level route (``hierarchical_allreduce_groups``): pack,
        pad to a multiple of L, prescale; reduce-scatter within the node
        at ``intra_wire``; reduce the 1/L shard across nodes, at
        ``wire`` (an exact allreduce, or :meth:`_quantized_sum` on the
        int8 wire); allgather within the node at ``intra_wire``, the one
        collective in flight when this returns; Average divides by n
        after the gather. Exact on integer-valued fp32: the same sums as
        the flat route in another order."""
        e0 = entries[0]
        # resolved at enqueue, so a split exists; mode "on" finds the
        # split any other mode that resolves finds
        plan = self._split(True)
        dtype = e0.tensor.dtype
        quantized = e0.wire == "int8"
        tl = self.timeline
        with record_function(WIRE_RANGES["pack"]):
            flat = _memcpy(tl, entries, _IN, lambda: _pack(entries))
            if quantized:
                flat = flat.to(torch.float32)
            m = flat.numel()
            flat = torch.nn.functional.pad(flat, (0, (-m) % plan.L))
            if e0.prescale != 1.0:
                flat.mul_(e0.prescale)
        acc = flat.dtype  # the hops' arithmetic: fp32 on the int8 wire
        wire_in = _stage(flat, e0.intra_wire)
        shard = wire_in.new_empty(wire_in.numel() // plan.L)
        scatter_reduce_into(shard, wire_in, plan.intra)
        self.handed_bytes_intra += _nbytes(wire_in)
        del flat, wire_in  # the batch's outputs must not keep them alive
        shard = shard.to(acc)
        res = res_all = None
        if quantized:
            red, res = self._quantized_sum(shard, plan, e0.wire_block,
                                           e0.want_residual,
                                           self._wire_seed(e0))
        else:
            red = _stage(shard, e0.wire)
            dist.all_reduce(red, group=plan.inter)
            self.handed_bytes_inter += _nbytes(red)
            red = red.to(acc)
        red = _stage(red, e0.intra_wire)
        gathered = red.new_empty(red.numel() * plan.L)
        works = [gather_into(gathered, red, plan.intra, True)]
        self.handed_bytes_intra += _nbytes(red)
        if res is not None:
            with record_function(WIRE_RANGES["residual"]):
                if e0.prescale == 0.0:
                    res.zero_()  # nothing was sent: no carry, not 0/0
                elif e0.prescale != 1.0:
                    res.div_(e0.prescale)
                res.div_(plan.L)
                res_all = res.new_empty(res.numel() * plan.L)
            works.append(gather_into(res_all, res, plan.intra, True))
            self.handed_bytes_intra += _nbytes(res)

        def finish():
            with record_function(WIRE_RANGES["unpack"]):
                out = gathered.to(acc)[:m]
                _scale_out(out, plan.L * plan.H, e0.op, e0.postscale)
                out = out.to(dtype)
                outs = _memcpy(tl, entries, _OUT,
                               lambda: _unpack(out, entries))
                if res_all is not None:
                    carry = res_all[:m].to(dtype)
                    self._note_residuals(carry)
                    outs = list(zip(outs, _unpack(carry, entries)))
                return outs, _finite(e0, out)

        nbytes = self._account_wire(m, e0.tensor.element_size(), e0, plan)
        return _Works(*works), finish, nbytes

    def _quantized_sum(self, shard, plan: _Split, block: int,
                       want_residual: bool, seed: int):
        """B3's two-stage int8 recipe (``ops/int8_wire.py``) over the
        inter group, with Sum semantics (``traced.py:_quantized_sum_groups``):
        chunk the shard over the H nodes, quantize, exchange values and
        scales, sum the dequantized chunks, quantize the summed chunk,
        allgather it. Returns the reduced shard and, when asked for, the
        residual of both stages on the shard (the owned chunk, by the
        position in the inter group, carries the second stage's error
        unscaled: the caller divides after the gather, so the error and a
        correction added to the next input pass the same division)."""
        H, m = plan.H, shard.numel()
        chunk = -(-m // H)
        chunks = torch.nn.functional.pad(shard, (0, chunk * H - m)).view(
            H, chunk)
        rank = dist.get_rank()

        def gather(q2, s2):
            all_q = q2.new_empty((H,) + q2.shape)
            all_s = s2.new_empty((H,) + s2.shape)
            gather_into(all_q, q2, plan.inter)
            gather_into(all_s, s2, plan.inter)
            return all_q, all_s

        st = int8_wire.quantized_sum(
            chunks, block, seed, (2 * rank, 2 * rank + 1),
            _exchange(plan.inter), gather)
        self.handed_bytes_inter += _nbytes(st.q, st.scales, st.q2, st.s2)
        red = int8_wire.unpack(st.all_q, st.all_s, block, m)
        res = None
        if want_residual:
            res = int8_wire.residual(chunks, st, block, plan.pos,
                                     m).contiguous()
        return red, res

    def _allreduce_q(self, entries, group, ps):
        """The int8 fused wire (``_core_allreduce_q``): pack; split into
        one chunk per rank; run the two-stage recipe of
        ``ops/int8_wire.py`` on B3 (block-quantize the chunk rows with
        the prescale folded into the wire scales; ``all_to_all_single``
        of values and of scales; dequantize and sum the received chunks
        in fp32, ÷n for Average; block-quantize this rank's reduced
        shard; allgather values and scales); dequantize into the unpack
        and apply the postscale. Only the final allgather is in flight
        when this returns. A joined rank (the join mask) sends zeros,
        and Average divides by the active count.

        The residual (``want_residual``) follows the JAX contract
        (``fusion.py:1993-2025``): the stage-1 error against the
        unscaled block scales everywhere, plus on the owned chunk the
        stage-2 error times n for Average and divided by the prescale;
        a zero prescale gives a zero carry; input units, per entry."""
        e0 = entries[0]
        n, me = _scope(e0)
        active, count = _active(e0)
        block = e0.wire_block
        dtype = e0.tensor.dtype
        tl = self.timeline
        with record_function(WIRE_RANGES["pack"]):
            row = _memcpy(tl, entries, _IN,
                          lambda: _pack(entries)).to(torch.float32)
            if not active:
                row.zero_()
            m = row.numel()
            chunk = -(-m // n)
            chunks = torch.nn.functional.pad(row, (0, chunk * n - m)).view(
                n, chunk)
        seed = self._wire_seed(e0)
        rank = dist.get_rank()
        works = []

        def gather(q2, s2):
            all_q = q2.new_empty((n,) + q2.shape)
            all_s = s2.new_empty((n,) + s2.shape)
            works.extend([gather_into(all_q, q2, group, True),
                          gather_into(all_s, s2, group, True)])
            return all_q, all_s

        average = e0.op == Average
        st = int8_wire.quantized_sum(
            chunks, block, seed, (2 * rank, 2 * rank + 1), _exchange(group),
            gather, prescale=e0.prescale, divisor=count if average else None)
        res = None
        if e0.want_residual:
            if e0.prescale == 0.0:
                res = row.new_zeros(m, dtype=dtype)
            else:
                res = int8_wire.residual(
                    chunks, st, block, me, m,
                    e2_mul=count if average else None,
                    e2_div=e0.prescale if e0.prescale != 1.0 else None,
                ).to(dtype)

        def finish():
            out = int8_wire.unpack(st.all_q, st.all_s, block, m)
            with record_function(WIRE_RANGES["unpack"]):
                if e0.postscale != 1.0:
                    out = out * e0.postscale
                out = out.to(dtype)
                outs = _memcpy(tl, entries, _OUT,
                               lambda: _unpack(out, entries))
                if res is not None:
                    self._note_residuals(res)
                    outs = list(zip(outs, _unpack(res, entries)))
                return outs, _finite(e0, out)

        nbytes = self._account(m, "int8", e0.tensor.element_size(), n, block)
        return _Works(*works), finish, nbytes

    def _adasum(self, e0, ps):
        """One Adasum entry through ``ops/adasum.py``, computed now; the
        returned work is already complete. A joined rank contributes
        zeros, Adasum's identity."""
        x = e0.tensor
        if not _active(e0)[0]:
            x = torch.zeros_like(x)
        elif e0.prescale != 1.0:
            x = x * e0.prescale
        out = adasum_allreduce(x, process_set=ps)
        out = out.clone() if out is e0.tensor else out
        if e0.postscale != 1.0:
            out = out * e0.postscale
        self.last_wire_format = "fp32"
        return _Works(), (lambda: ([out], _finite(e0, out))), e0.nbytes

    def _allgather(self, e0, group, ps):
        """Allgather-v along dim 0: sizes first, then one gather of
        equal-length padded rows, trimmed and concatenated. Over the
        world with a two-level split, an inter gather among the ranks of
        this node-local slot, then an intra gather, reordered to rank
        order (``traced.hierarchical_allgather``)."""
        x = e0.tensor.detach()
        n = _set_size(ps)
        dim0 = torch.tensor([x.shape[0] if x.dim() else 1],
                            dtype=torch.int64, device=x.device)
        sizes = [torch.empty_like(dim0) for _ in range(n)]
        dist.all_gather(sizes, dim0, group=group)
        sizes = [int(s) for s in torch.cat(sizes).tolist()]
        rows = x if x.dim() else x.reshape(1)
        longest = max(sizes)
        if rows.shape[0] < longest:
            pad = rows.new_zeros((longest - rows.shape[0],) + rows.shape[1:])
            rows = torch.cat([rows, pad])
        rows = rows.contiguous()
        plan = self._split() if _is_world(ps) else None
        if plan is not None:
            inter = rows.new_empty((plan.H,) + rows.shape)
            gather_into(inter, rows, plan.inter)
            both = rows.new_empty((plan.L, plan.H) + rows.shape)
            work = gather_into(both, inter, plan.intra, True)
            parts = None
        else:
            parts = torch.empty((n,) + rows.shape, dtype=rows.dtype,
                                device=rows.device)
            work = gather_into(parts, rows, group, True)

        def finish():
            got = parts if parts is not None else both.transpose(
                0, 1).reshape((n,) + rows.shape)
            out = torch.cat([p[:s] for p, s in zip(got, sizes)])
            return [out], _finite(e0, out)

        return work, finish, rows.numel() * rows.element_size() * n

    def _reducescatter(self, entries, group, ps):
        """Reduce-scatter along dim 0, Sum or Average, of a unit of
        entries in one collective: rank j of the set gets its rows of
        every entry (the earlier ranks one extra when dim 0 does not
        divide), summed over the set. Each entry's rows for rank j,
        zero-padded to the longest count, make one pane; the panes of
        every entry for rank j make row j of the ``[n, P]`` buffer. Over
        the world with a two-level split, an intra reduce-scatter of the
        panes bound for this node-local slot, then an inter one
        (``traced.hierarchical_reducescatter``)."""
        e0 = entries[0]
        n, me = _set_size(ps), _rank_in(ps)
        layout, panes = [], []
        for e in entries:
            x = e.tensor.detach()
            width = math.prod(x.shape[1:])
            longest = -(-x.shape[0] // n)
            rows = x.reshape(x.shape[0], width)
            if x.shape[0] % n == 0:
                pane = rows.reshape(n, longest * width)
            else:
                pane = rows.new_zeros((n, longest, width))
                for j in range(n):
                    off, cnt = _rows(x.shape[0], n, j)
                    pane[j, :cnt] = rows[off:off + cnt]
            panes.append(pane.reshape(n, -1))
            layout.append((longest * width, _rows(x.shape[0], n, me)[1]))
        buf = torch.cat(panes, dim=1)  # a fresh buffer, even for one entry
        if e0.prescale != 1.0:
            buf.mul_(e0.prescale)
        out = buf.new_empty(buf.shape[1])
        plan = self._split() if _is_world(ps) else None
        if plan is not None:
            by_slot = buf.view(plan.H, plan.L, -1).transpose(0, 1).contiguous()
            node = buf.new_empty((plan.H, buf.shape[1]))
            scatter_reduce_into(node, by_slot, plan.intra)
            work = scatter_reduce_into(out, node, plan.inter, True)
        else:
            work = scatter_reduce_into(out, buf, group, True)

        def finish():
            _scale_out(out, n, e0.op, e0.postscale)
            outs, off = [], 0
            for e, (size, cnt) in zip(entries, layout):
                mine = out[off:off + size].view(-1, *e.tensor.shape[1:])
                outs.append(mine[:cnt])
                off += size
            return outs, _finite(e0, out)

        return work, finish, buf.numel() * buf.element_size()

    def _alltoall(self, e0, group):
        """All-to-all along dim 0: equal slices, or ``splits`` rows to
        each rank of the set, whose counts are exchanged first; with
        splits the output is ``(tensor, received_splits)``."""
        x = e0.tensor.detach().contiguous()
        n = dist.get_world_size(group)
        self.alltoall_dispatches += 1
        self.alltoall_wire_bytes += e0.nbytes * (n - 1) // max(n, 1)
        if e0.splits is None:
            out = torch.empty_like(x)
            work = dist.all_to_all_single(out, x, group=group, async_op=True)
            return work, (lambda: ([out], None)), e0.nbytes
        send = torch.tensor(e0.splits, dtype=torch.int64, device=x.device)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        got = [int(v) for v in recv.tolist()]
        out = x.new_empty((sum(got),) + x.shape[1:])
        work = dist.all_to_all_single(out, x, got, list(e0.splits),
                                      group=group, async_op=True)
        counts = torch.tensor(got, dtype=torch.int32)
        return work, (lambda: ([(out, counts)], None)), e0.nbytes
