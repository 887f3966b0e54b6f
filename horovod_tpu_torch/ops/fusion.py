"""Tensor fusion: batch pending collectives into few large ones.

The core of ``horovod_tpu/ops/fusion.py`` on ``torch.distributed``:

- Allreduce entries of one fusion key (dtype, device, op, pre/postscale
  factors, process set) are packed (``_pack``) into one flat buffer up
  to ``threshold_bytes``, as ``_batches_by_threshold`` cuts a group: a
  batch closes when the next unit would push it past the threshold, an
  entry over the threshold goes alone, and a grouped allreduce is one
  indivisible unit. Batches are cut as entries arrive, so the gradient
  hooks of a backward pass put collectives in flight while the pass
  runs.
- One collective runs per batch with ``async_op=True``. For CUDA
  tensors NCCL runs it on its own stream, ordered after the pack on the
  current stream; for CPU tensors gloo runs it on its own thread.
- ``Handle.wait`` waits on the batch's work (the current stream waits
  on NCCL's for CUDA tensors, without a host sync) and unpacks
  (``_unpack``) the batch into every entry's output, applying the
  postscale (and 1/n for Average) once over the flat buffer.
- Allgather and broadcast go one collective per entry.
- ``dispatched_batches``/``dispatched_bytes`` count the collectives
  issued and the bytes they carried.

Collectives are issued in enqueue order, so every rank must enqueue the
same entries in the same order (the gradient hooks of identical models
do). Left for ROADMAP A3: the exact and bucket executor tiers, the int8
fused wire, the hierarchical route and autotune.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..common.process_sets import ProcessSet
from .reduction_ops import Average, Max, Min, Product, ReduceOp, Sum

_DIST_OPS = {
    Average: dist.ReduceOp.SUM,
    Sum: dist.ReduceOp.SUM,
    Min: dist.ReduceOp.MIN,
    Max: dist.ReduceOp.MAX,
    Product: dist.ReduceOp.PRODUCT,
}


@dataclasses.dataclass(eq=False)
class _Entry:
    """One pending collective (the reference's TensorTableEntry)."""

    kind: str  # "allreduce" | "allgather" | "broadcast"
    tensor: torch.Tensor
    name: str
    op: ReduceOp = Average
    prescale: float = 1.0
    postscale: float = 1.0
    root_rank: int = 0
    process_set: Optional[ProcessSet] = None
    handle: Optional["Handle"] = None

    @property
    def nbytes(self) -> int:
        return self.tensor.numel() * self.tensor.element_size()

    def key(self) -> Tuple:
        ps = self.process_set
        return (self.kind, self.tensor.dtype, self.tensor.device, int(self.op),
                self.prescale, self.postscale, self.root_rank,
                None if ps is None else ps.process_set_id)


def _group(ps: Optional[ProcessSet]):
    return None if ps is None or ps.process_set_id == 0 else ps.group


def _set_size(ps: Optional[ProcessSet]) -> int:
    if ps is None or ps.process_set_id == 0:
        return dist.get_world_size()
    return ps.size


def _pack(entries: List[_Entry]) -> torch.Tensor:
    """Flatten and concatenate the batch into a fresh flat buffer (the
    collective reduces it in place; the inputs stay untouched)."""
    return torch.cat([e.tensor.reshape(-1) for e in entries])


def _unpack(flat: torch.Tensor, entries: List[_Entry]) -> List[torch.Tensor]:
    """Views of the flat buffer in each entry's shape."""
    out, off = [], 0
    for e in entries:
        n = e.tensor.numel()
        out.append(flat[off:off + n].view(e.tensor.shape))
        off += n
    return out


class _Batch:
    """A dispatched collective and the entries it serves."""

    def __init__(self, entries: List[_Entry], work, finish):
        self.entries = entries
        self.work = work
        self._finish = finish  # () -> list of outputs, after work.wait()
        self._outputs: Optional[List[torch.Tensor]] = None
        self._lock = threading.Lock()

    def done(self) -> bool:
        return self._outputs is not None or self.work.is_completed()

    def output(self, index: int) -> torch.Tensor:
        with self._lock:
            if self._outputs is None:
                self.work.wait()
                self._outputs = self._finish()
        return self._outputs[index]


class Handle:
    """Async completion handle (``fusion.py:131-158``). ``poll`` never
    blocks; ``wait`` waits and returns the output. Either one, on an
    entry still queued, first runs a cycle: it dispatches everything
    pending. The JAX package ticks its cycle by the clock
    (``HOROVOD_CYCLE_TIME``); with one process per rank a clock would cut
    batches differently on different ranks, so the port ticks at these
    calls, which every rank reaches after the same enqueues."""

    def __init__(self, fusion: "FusionManager", entry: _Entry):
        self._fusion = fusion
        self._entry = entry
        self._batch: Optional[_Batch] = None
        self._index = 0  # the entry's place in its batch

    def poll(self) -> bool:
        if self._batch is None:
            self._fusion.flush()
        return self._batch.done()

    def wait(self) -> torch.Tensor:
        if self._batch is None:
            self._fusion.flush()
        return self._batch.output(self._index)


class FusionManager:
    """Pending entries by fusion key, cut into batches by bytes."""

    def __init__(self, threshold_bytes: int):
        self.threshold_bytes = int(threshold_bytes)
        self._lock = threading.RLock()
        self._pending: Dict[Tuple, List[List[_Entry]]] = {}
        self._pending_bytes: Dict[Tuple, int] = {}
        self._inflight: List[_Batch] = []
        self.dispatched_batches = 0
        self.dispatched_bytes = 0

    def enqueue(self, entries: List[_Entry]) -> List[Handle]:
        """Queue ``entries`` as one unit (a grouped allreduce's members
        share one batch) and dispatch every batch the unit closes."""
        handles = []
        with self._lock:
            for e in entries:
                e.handle = Handle(self, e)
                handles.append(e.handle)
            if entries[0].kind != "allreduce":
                for e in entries:
                    self._dispatch([e])
                return handles
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
        """Dispatch every pending batch, in enqueue order of its key."""
        with self._lock:
            for key in list(self._pending):
                self._dispatch_key(key)

    def wait_all(self) -> None:
        """Wait for every dispatched batch."""
        with self._lock:
            batches, self._inflight = self._inflight, []
        for b in batches:
            b.work.wait()

    def _dispatch_key(self, key) -> None:
        units = self._pending.pop(key, [])
        self._pending_bytes.pop(key, None)
        if units:
            self._dispatch([e for unit in units for e in unit])

    def _dispatch(self, entries: List[_Entry]) -> None:
        e0 = entries[0]
        ps = e0.process_set
        if ps is not None and not ps.included(dist.get_rank()):
            raise ValueError(
                f"{e0.kind} {e0.name!r}: rank {dist.get_rank()} is not a "
                f"member of {ps}"
            )
        group = _group(ps)
        if e0.kind == "allreduce":
            work, finish, nbytes = self._allreduce(entries, group, ps)
        elif e0.kind == "allgather":
            work, finish, nbytes = self._allgather(e0, group, ps)
        elif e0.kind == "broadcast":
            buf = e0.tensor.detach().clone()
            work = dist.broadcast(buf, src=e0.root_rank, group=group,
                                  async_op=True)
            finish, nbytes = (lambda: [buf]), e0.nbytes
        else:
            raise ValueError(f"unknown collective {e0.kind!r}")
        batch = _Batch(entries, work, finish)
        for i, e in enumerate(entries):
            e.handle._batch, e.handle._index = batch, i
        self._inflight = [b for b in self._inflight if not b.done()]
        self._inflight.append(batch)
        self.dispatched_batches += 1
        self.dispatched_bytes += nbytes

    def _allreduce(self, entries, group, ps):
        e0 = entries[0]
        flat = _pack(entries)
        if e0.prescale != 1.0:
            flat.mul_(e0.prescale)
        work = dist.all_reduce(flat, op=_DIST_OPS[e0.op], group=group,
                               async_op=True)
        post = e0.postscale
        if e0.op == Average:
            post /= _set_size(ps)

        def finish():
            if post != 1.0:
                if flat.is_floating_point():
                    flat.mul_(post)
                else:
                    flat.copy_(torch.trunc(flat.double() * post))
            return _unpack(flat, entries)

        return work, finish, flat.numel() * flat.element_size()

    def _allgather(self, e0, group, ps):
        """Allgather-v along dim 0: sizes first, then one gather of
        equal-length padded rows, trimmed and concatenated."""
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
        parts = [torch.empty_like(rows) for _ in range(n)]
        work = dist.all_gather(parts, rows, group=group, async_op=True)

        def finish():
            return [torch.cat([p[:s] for p, s in zip(parts, sizes)])]

        return work, finish, rows.numel() * rows.element_size() * n
