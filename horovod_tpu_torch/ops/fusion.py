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
- Allgather and broadcast go one collective per entry. Adasum entries
  go one per entry too, never fused (``fusion.py:628-637``): Adasum's
  coefficients are per tensor. Each runs ``ops/adasum.py``.
- The wire of an allreduce batch is ``fp32`` (the payload's own width),
  ``bf16`` (fp32 payloads cast for the collective) or ``int8``: the
  entry's compressor names it, else the manager's ``HOROVOD_FUSION_WIRE``.
  The int8 wire (:meth:`FusionManager._allreduce_q`, the JAX package's
  ``_core_allreduce_q`` without its mask, hierarchy and local groups)
  block-quantizes the batch's per-peer chunks on kernel B3, exchanges
  int8 values and fp32 scales with ``all_to_all_single``, sums the
  dequantized chunks in fp32, quantizes the reduced shard on B3 again
  and allgathers it; the prescale folds into the stage-1 wire scales.
  Sum and Average of floating payloads only: Min, Max, Product and
  integers ride the exact wire. With ``return_residual`` the batch also
  yields the error-feedback residual in input units, per entry. Its
  plain-PyTorch passes run inside ``torch.profiler`` ranges named
  ``hvd.int8_wire.{pack,exchange,dequantize_sum,residual,unpack}``
  (``WIRE_RANGES``), so a profiled step splits the wire's device time by
  pass.
- An allreduce entry may ask for the grad guard's sentinel
  (``guard=True``, the optimizer's ``grad_guard``): its floating batch
  then also yields one ``all(isfinite)`` flag over the reduced flat
  buffer (``horovod_tpu/ops/fusion.py:1168``), a device tensor that
  :meth:`Handle.finite` returns without a host read. Integer batches
  have no flag.
- ``dispatched_batches``/``dispatched_bytes`` count the collectives
  issued and the bytes they carried, by the JAX package's payload-width
  model (``_hop_bytes``: an int8 batch of ``elems`` elements over ``n``
  ranks carries ``elems + nb·(n+1)·4`` bytes, ``nb`` blocks a chunk);
  ``wire_bytes_saved`` and ``quant_blocks`` add up what the int8 and
  bf16 wires saved against the payload width, ``last_wire_format`` names
  the last batch's wire. The port counts this rank's bytes; the JAX
  package, one controller for all ranks, counts every rank's row.

Collectives are issued in enqueue order, so every rank must enqueue the
same entries in the same order (the gradient hooks of identical models
do). The int8 wire's rounding seed is a per-dispatch counter, equal on
every rank for the same reason, folded with the rank. Left for ROADMAP
A3: the exact and bucket executor tiers, the hierarchical route and
autotune.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..common.process_sets import ProcessSet
from . import cuda_kernels
from ._collectives import gather_into
from .adasum import adasum_allreduce
from .reduction_ops import Adasum, Average, Max, Min, Product, ReduceOp, Sum

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
    # allreduce wire: None defers to the manager's; resolved at enqueue
    wire: Optional[str] = None
    wire_block: Optional[int] = None
    want_residual: bool = False
    guard: bool = False  # the batch yields a non-finite sentinel

    @property
    def nbytes(self) -> int:
        return self.tensor.numel() * self.tensor.element_size()

    def key(self) -> Tuple:
        ps = self.process_set
        return (self.kind, self.tensor.dtype, self.tensor.device, int(self.op),
                self.prescale, self.postscale, self.root_rank,
                None if ps is None else ps.process_set_id, self.wire,
                self.wire_block, self.want_residual, self.guard)


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


def _rank_in(ps: Optional[ProcessSet]) -> int:
    r = dist.get_rank()
    if ps is None or ps.process_set_id == 0:
        return r
    return ps.rank_in_set(r)


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
    the outputs and is let go once it has made them."""

    def __init__(self, work, finish):
        self.work = work
        # () -> (list of outputs, sentinel or None), after work.wait()
        self._finish = finish
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
        return self._outputs[index]


class Handle:
    """Async completion handle (``fusion.py:131-158``). ``poll`` never
    blocks; ``wait`` waits and returns the output. Either one, on an
    entry still queued, first runs a cycle: it dispatches everything
    pending. The JAX package ticks its cycle by the clock
    (``HOROVOD_CYCLE_TIME``); with one process per rank a clock would cut
    batches differently on different ranks, so the port ticks at these
    calls, which every rank reaches after the same enqueues."""

    def __init__(self, fusion: "FusionManager"):
        self._fusion = fusion
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

    def finite(self) -> Optional[torch.Tensor]:
        """The batch's non-finite sentinel (a device bool, True when
        every reduced value is finite) after :meth:`wait`; None unless
        the entry asked for it."""
        self.wait()
        return self._batch.finite


WIRES = ("fp32", "bf16", "int8")
# the int8 wire's profiler ranges, by pass (B3's launches lie outside them)
WIRE_RANGES = {k: f"hvd.int8_wire.{k}" for k in (
    "pack", "exchange", "dequantize_sum", "residual", "unpack")}


class FusionManager:
    """Pending entries by fusion key, cut into batches by bytes."""

    def __init__(self, threshold_bytes: int, wire: str = "fp32",
                 wire_block: int = 512):
        if wire not in WIRES:
            raise ValueError(f"fusion wire must be one of {WIRES}, got "
                             f"{wire!r}")
        if int(wire_block) < 1:
            raise ValueError(f"wire block must be >= 1, got {wire_block}")
        self.threshold_bytes = int(threshold_bytes)
        self.wire = wire
        self.wire_block = int(wire_block)
        self._lock = threading.RLock()
        self._pending: Dict[Tuple, List[List[_Entry]]] = {}
        self._pending_bytes: Dict[Tuple, int] = {}
        self._inflight: List[_Batch] = []
        self.dispatched_batches = 0
        self.dispatched_bytes = 0
        self.wire_bytes_saved = 0
        self.quant_blocks = 0
        self.last_wire_format = "fp32"
        self._seed_counter = 0  # the int8 wire's per-dispatch seed

    def _resolve_wire(self, e: _Entry) -> None:
        """Fix the entry's wire and block: the int8 wire takes Sum and
        Average of floating payloads; anything else rides the exact
        wire, as the JAX package routes it (callers asking for a
        residual were checked at enqueue)."""
        wire = self.wire if e.wire is None else e.wire
        exact = e.op not in (Sum, Average) or not e.tensor.is_floating_point()
        if wire == "int8" and exact and not e.want_residual:
            wire = "fp32"
        if wire == "bf16" and (not e.tensor.is_floating_point()
                               or e.tensor.element_size() > 4):
            wire = "fp32"  # fp32 payloads narrow; 2-byte ones already are
        e.wire = wire
        e.wire_block = (e.wire_block or self.wire_block) if wire == "int8" \
            else None

    def enqueue(self, entries: List[_Entry]) -> List[Handle]:
        """Queue ``entries`` as one unit (a grouped allreduce's members
        share one batch) and dispatch every batch the unit closes."""
        handles = []
        with self._lock:
            for e in entries:
                e.handle = Handle(self)
                handles.append(e.handle)
            if entries[0].kind != "allreduce" or entries[0].op == Adasum:
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
        """Dispatch every pending batch, in enqueue order of its key."""
        with self._lock:
            for key in list(self._pending):
                self._dispatch_key(key)

    def wait_all(self) -> None:
        """Wait for every dispatched batch."""
        with self._lock:
            batches, self._inflight = self._inflight, []
        for b in batches:
            b.wait()

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
        if e0.kind == "allreduce" and e0.op == Adasum:
            work, finish, nbytes = self._adasum(e0, ps)
        elif e0.kind == "allreduce" and e0.wire == "int8":
            work, finish, nbytes = self._allreduce_q(entries, group, ps)
        elif e0.kind == "allreduce":
            work, finish, nbytes = self._allreduce(entries, group, ps)
        elif e0.kind == "allgather":
            work, finish, nbytes = self._allgather(e0, group, ps)
        elif e0.kind == "broadcast":
            buf = e0.tensor.detach().clone()
            work = dist.broadcast(buf, src=e0.root_rank, group=group,
                                  async_op=True)
            finish, nbytes = (lambda: ([buf], None)), e0.nbytes
        else:
            raise ValueError(f"unknown collective {e0.kind!r}")
        batch = _Batch(work, finish)
        # an entry lets go of its handle here: the handle holds the batch,
        # whose finish holds the entries, and a cycle among them would
        # keep the batch's device buffers until the cyclic collector ran
        for i, e in enumerate(entries):
            e.handle._batch, e.handle._index = batch, i
            e.handle = None
        self._inflight = [b for b in self._inflight if not b.done()]
        self._inflight.append(batch)
        self.dispatched_batches += 1
        self.dispatched_bytes += nbytes

    def _account(self, elems: int, wire: str, itemsize: int, n: int,
                 block: int) -> int:
        """Count one allreduce batch's wire bytes and what its wire
        saved against the payload width; returns the wire bytes."""
        nbytes, blocks = hop_bytes(elems, wire, itemsize, n, block)
        self.wire_bytes_saved += max(elems * itemsize - nbytes, 0)
        self.quant_blocks += blocks
        self.last_wire_format = wire
        return nbytes

    def _allreduce(self, entries, group, ps):
        e0 = entries[0]
        flat = _pack(entries)
        if e0.prescale != 1.0:
            flat.mul_(e0.prescale)
        wire_buf = (flat.to(torch.bfloat16)
                    if e0.wire == "bf16" and flat.dtype == torch.float32
                    else flat)
        work = dist.all_reduce(wire_buf, op=_DIST_OPS[e0.op], group=group,
                               async_op=True)
        post = e0.postscale
        if e0.op == Average:
            post /= _set_size(ps)

        def finish():
            if wire_buf is not flat:
                flat.copy_(wire_buf)
            if post != 1.0:
                if flat.is_floating_point():
                    flat.mul_(post)
                else:
                    flat.copy_(torch.trunc(flat.double() * post))
            return _unpack(flat, entries), _finite(e0, flat)

        nbytes = self._account(flat.numel(), e0.wire, flat.element_size(),
                               _set_size(ps), self.wire_block)
        return work, finish, nbytes

    def _allreduce_q(self, entries, group, ps):
        """The int8 fused wire (``_core_allreduce_q``): pack; split into
        one chunk per rank; block-quantize the chunk rows on B3 with the
        prescale folded into the wire scales; ``all_to_all_single`` of
        values and of scales; dequantize and sum the received chunks in
        fp32 (÷n for Average); block-quantize this rank's reduced shard
        on B3; allgather values and scales; dequantize into the unpack
        and apply the postscale. Only the final allgather is in flight
        when this returns.

        The residual (``want_residual``) follows the JAX contract
        (``fusion.py:1993-2025``): the stage-1 error against the
        unscaled block scales everywhere, plus on the owned chunk the
        stage-2 error times n for Average and divided by the prescale;
        a zero prescale gives a zero carry; input units, per entry."""
        e0 = entries[0]
        n, me = _set_size(ps), _rank_in(ps)
        block = e0.wire_block
        dtype = e0.tensor.dtype
        with record_function(WIRE_RANGES["pack"]):
            row = _pack(entries).to(torch.float32)
            m = row.numel()
            chunk = -(-m // n)
            chunks = torch.nn.functional.pad(row, (0, chunk * n - m)).view(
                n, chunk)
        seed = self._seed_counter
        self._seed_counter += 1
        rank = dist.get_rank()
        q, scales = cuda_kernels.int8_block_quantize(
            chunks, block, seed=seed, stream=2 * rank, rows=True)
        wire_scales = scales * e0.prescale if e0.prescale != 1.0 else scales
        with record_function(WIRE_RANGES["exchange"]):
            recv_q = torch.empty_like(q)
            recv_s = torch.empty_like(wire_scales)
            dist.all_to_all_single(recv_q, q, group=group)
            dist.all_to_all_single(recv_s, wire_scales, group=group)
        with record_function(WIRE_RANGES["dequantize_sum"]):
            shard = cuda_kernels.int8_block_dequantize(recv_q, recv_s,
                                                       block).sum(0)
            if e0.op == Average:
                shard = shard / n
        q2, s2 = cuda_kernels.int8_block_quantize(
            shard[None], block, seed=seed, stream=2 * rank + 1, rows=True)
        with record_function(WIRE_RANGES["exchange"]):
            all_q = q.new_empty((n, chunk))
            all_s = s2.new_empty((n, s2.shape[1]))
            work = _Works(gather_into(all_q, q2[0], group, True),
                          gather_into(all_s, s2[0], group, True))
        res = None
        if e0.want_residual:
            with record_function(WIRE_RANGES["residual"]):
                if e0.prescale == 0.0:
                    res = row.new_zeros(m, dtype=dtype)
                else:
                    res1 = chunks - cuda_kernels.int8_block_dequantize(
                        q, scales, block)
                    e2 = shard - cuda_kernels.int8_block_dequantize(
                        q2, s2, block)[0]
                    if e0.op == Average:
                        e2 = e2 * n
                    if e0.prescale != 1.0:
                        e2 = e2 / e0.prescale
                    res1[me] += e2
                    res = res1.reshape(-1)[:m].to(dtype)

        def finish():
            with record_function(WIRE_RANGES["unpack"]):
                out = cuda_kernels.int8_block_dequantize(all_q, all_s, block)
                out = out.reshape(-1)[:m]
                if e0.postscale != 1.0:
                    out = out * e0.postscale
                out = out.to(dtype)
                outs = _unpack(out, entries)
                if res is not None:
                    outs = list(zip(outs, _unpack(res, entries)))
                return outs, _finite(e0, out)

        nbytes = self._account(m, "int8", e0.tensor.element_size(), n, block)
        return work, finish, nbytes

    def _adasum(self, e0, ps):
        """One Adasum entry through ``ops/adasum.py``, computed now; the
        returned work is already complete."""
        x = e0.tensor
        if e0.prescale != 1.0:
            x = x * e0.prescale
        out = adasum_allreduce(x, process_set=ps)
        out = out.clone() if out is e0.tensor else out
        if e0.postscale != 1.0:
            out = out * e0.postscale
        self.last_wire_format = "fp32"
        return _Works(), (lambda: ([out], _finite(e0, out))), e0.nbytes

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
            return [torch.cat([p[:s] for p, s in zip(parts, sizes)])], None

        return work, finish, rows.numel() * rows.element_size() * n
