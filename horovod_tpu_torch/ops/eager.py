"""Eager collectives with async handles, on the fusion manager.

The counterpart of ``horovod_tpu/ops/eager.py`` with the signatures of
``horovod_tpu/torch/__init__.py`` (the reference's
``horovod/torch/mpi_ops.py``): each rank passes its own tensor and gets
the collective's result back as a tensor on the same device.

- ``allreduce(_async)`` and the in-place ``allreduce_(_async_)``, with
  ``op=`` (Adasum included), ``prescale_factor``/``postscale_factor``
  (the result is ``postscale · reduce(prescale · x)``, divided by the
  set's size for Average) and ``compression=``. A quantized compressor
  (``Compression.int8``/``int8_block``) is not applied tensor by tensor
  (summing raw int8 wraps): it selects the fusion manager's int8 wire
  for the whole fused buffer, at the compressor's block size.
  ``Compression.none`` selects the exact wire even when
  ``HOROVOD_FUSION_WIRE=int8``; no ``compression=`` defers to it.
  ``return_residual=True`` (the int8 wire, Sum/Average of a floating
  tensor) makes the result ``(output, residual)``, the error-feedback
  carry of this tensor in input units. ``guard=True`` (the optimizer's
  ``grad_guard``) makes the handle's ``finite()`` return the fused
  batch's non-finite sentinel;
- ``grouped_allreduce(_async)``: the list reduces as one unit, in one
  fused collective per dtype;
- ``allgather(_async)``: concatenation along dim 0, sizes may differ by
  rank;
- ``broadcast(_async)`` and ``broadcast_(_async_)`` from a global
  ``root_rank``;
- ``reducescatter(_async)`` along dim 0, Sum or Average with pre/post
  scale factors (an uneven dim 0 gives the earlier ranks one extra
  row), and ``grouped_reducescatter(_async)``, whose members share one
  collective;
- ``alltoall(_async)``: equal slices of dim 0, or ``splits=`` (the rows
  this rank sends to each rank), which returns ``(output,
  received_splits)``;
- ``grouped_allgather(_async)``;
- ``join_ranks(ranks)``, a context in which every allreduce takes the
  join mask: the joined ranks contribute nothing (they still call the
  collective and get its result) and Average divides by the active
  count; ``current_join_mask()``; ``join(joined_ranks=None)`` flushes and
  returns the last joined rank, or -1;
- ``synchronize``, ``poll``, ``flush`` (dispatch everything pending
  now) and ``barrier``.

Under ``HOROVOD_HIERARCHICAL`` (``common/topology.py
hierarchy_stages``) the allreduce batches, reducescatter and allgather
over the world take the two-level route (``ops/fusion.py``).
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..common import basics
from ..common.process_sets import ProcessSet
from .fusion import _Entry
from .reduction_ops import Average, Sum, resolve_op

_names = itertools.count()


def _auto_name(kind: str, name: Optional[str]) -> str:
    return name if name is not None else f"{kind}.noname.{next(_names)}"


def _fusion():
    return basics._require_init().fusion


class TorchHandle:
    """The result of an async collective: ``wait()`` returns the output
    tensor (after ``post``, and copied into ``target`` for the in-place
    spellings); ``poll()`` says whether it is ready without blocking."""

    def __init__(self, inner, post=None, target=None):
        self._inner = inner
        self._post = post
        self._target = target

    def poll(self) -> bool:
        return self._inner.poll()

    def finite(self) -> Optional[torch.Tensor]:
        """The fused batch's non-finite sentinel (``guard=True``)."""
        return self._inner.finite()

    def wait(self) -> torch.Tensor:
        out = self._inner.wait()
        if self._post is not None:
            out = self._post(out)
        if self._target is not None:
            with torch.no_grad():
                self._target.copy_(out)
            return self._target
        return out


class GroupedHandle:
    """One handle over a list: ``wait()`` returns the list of outputs."""

    def __init__(self, handles: List[TorchHandle]):
        self._handles = handles

    def poll(self) -> bool:
        return all(h.poll() for h in self._handles)

    def wait(self) -> List[torch.Tensor]:
        return [h.wait() for h in self._handles]


def _wire_of(compression, return_residual: bool) -> Optional[str]:
    """The fused wire an allreduce asks for: the compressor's
    ``wire_format`` (None, no compressor: the manager's configured
    wire). A residual needs the int8 wire."""
    wire = getattr(compression, "wire_format", None)
    if return_residual and wire not in (None, "int8", "int8_hier"):
        raise ValueError(
            "return_residual=True needs the int8 quantized wire "
            "(Compression.int8 / int8_block / hier_int8, or no "
            "compression= with HOROVOD_FUSION_WIRE=int8); the "
            "error-feedback residual IS the quantization error"
        )
    if return_residual and wire is None:
        return "int8"
    return wire


def _check_residual_eligible(op, tensor) -> None:
    """return_residual's op and dtype limits, checked at enqueue so the
    caller at fault gets the exception, not a later flush."""
    if op not in (Average, Sum):
        raise ValueError(
            f"return_residual needs the int8 quantized wire, which "
            f"supports Sum/Average only (got op={op!r})"
        )
    if not tensor.is_floating_point():
        raise ValueError(
            f"return_residual needs a floating payload (got "
            f"{tensor.dtype}); integer tensors ride the exact wire, which "
            "has no quantization residual"
        )


def _allreduce_entry(tensor, name, op, prescale, postscale, process_set,
                     compression, return_residual=False, guard=False,
                     two_level=False, local=None):
    """One allreduce entry. ``two_level`` and ``local`` are
    ``DistributedOptimizer``'s alone: its ``Compression.hier_int8``
    residual batch may take the two-level route, where the eager rule
    keeps a residual on the flat int8 wire; ``local`` (intra rank lists)
    keeps the batch within this rank's group under local SGD."""
    wire = _wire_of(compression, return_residual)
    if return_residual:
        _check_residual_eligible(op, tensor)
    if compression is None or getattr(compression, "quantized_wire", False):
        payload, post = tensor.detach(), None
    else:
        payload, ctx = compression.compress(tensor.detach())
        post = lambda out: compression.decompress(out, ctx)  # noqa: E731
    entry = _Entry(kind="allreduce", tensor=payload, name=name, op=op,
                   prescale=float(prescale), postscale=float(postscale),
                   process_set=process_set, wire=wire,
                   wire_block=getattr(compression, "block_size", None),
                   want_residual=bool(return_residual), guard=bool(guard),
                   mask=_mask_key(), two_level=bool(two_level),
                   local=None if local is None else tuple(
                       tuple(int(r) for r in g) for g in local))
    return entry, post


def _submit(entry: _Entry, post) -> TorchHandle:
    """Enqueue one allreduce entry alone and wrap its handle."""
    (handle,) = _fusion().enqueue([entry])
    return TorchHandle(handle, post)


def allreduce_async(tensor, average=None, name=None, op=None,
                    process_set: Optional[ProcessSet] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    compression=None,
                    return_residual: bool = False, *,
                    guard: bool = False) -> TorchHandle:
    """``guard`` serves ``DistributedOptimizer``: the batch's non-finite
    sentinel."""
    return _submit(*_allreduce_entry(
        tensor, _auto_name("allreduce", name), resolve_op(op, average),
        prescale_factor, postscale_factor, process_set, compression,
        return_residual, guard,
    ))


def allreduce(tensor, average=None, name=None, op=None, process_set=None,
              prescale_factor=1.0, postscale_factor=1.0,
              compression=None, return_residual: bool = False):
    return allreduce_async(
        tensor, average, name, op, process_set, prescale_factor,
        postscale_factor, compression, return_residual,
    ).wait()


def allreduce_async_(tensor, average=None, name=None, op=None,
                     process_set=None, prescale_factor=1.0,
                     postscale_factor=1.0) -> TorchHandle:
    """In place: ``wait()`` writes the result into ``tensor``."""
    handle = allreduce_async(tensor, average, name, op, process_set,
                             prescale_factor, postscale_factor)
    handle._target = tensor
    return handle


def allreduce_(tensor, average=None, name=None, op=None, process_set=None,
               prescale_factor=1.0, postscale_factor=1.0) -> torch.Tensor:
    return allreduce_async_(tensor, average, name, op, process_set,
                            prescale_factor, postscale_factor).wait()


def grouped_allreduce_async(tensors: Sequence[torch.Tensor], average=None,
                            name=None, op=None, process_set=None,
                            prescale_factor=1.0, postscale_factor=1.0,
                            compression=None,
                            return_residual: bool = False) -> GroupedHandle:
    """The list as one unit: its members share one fused collective
    (per dtype), whatever the threshold."""
    base = _auto_name("grouped_allreduce", name)
    resolved = resolve_op(op, average)
    pairs = [
        _allreduce_entry(t, f"{base}.{i}", resolved, prescale_factor,
                         postscale_factor, process_set, compression,
                         return_residual)
        for i, t in enumerate(tensors)
    ]
    handles = _fusion().enqueue([e for e, _ in pairs])
    return GroupedHandle([TorchHandle(h, post)
                          for h, (_, post) in zip(handles, pairs)])


def grouped_allreduce(tensors, average=None, name=None, op=None,
                      process_set=None, prescale_factor=1.0,
                      postscale_factor=1.0, compression=None,
                      return_residual: bool = False) -> list:
    return grouped_allreduce_async(
        tensors, average, name, op, process_set, prescale_factor,
        postscale_factor, compression, return_residual,
    ).wait()


def allgather_async(tensor, name=None,
                    process_set: Optional[ProcessSet] = None) -> TorchHandle:
    entry = _Entry(kind="allgather", tensor=tensor.detach(),
                   name=_auto_name("allgather", name),
                   process_set=process_set)
    (handle,) = _fusion().enqueue([entry])
    return TorchHandle(handle)


def allgather(tensor, name=None, process_set=None) -> torch.Tensor:
    return allgather_async(tensor, name, process_set).wait()


def broadcast_async(tensor, root_rank: int, name=None,
                    process_set: Optional[ProcessSet] = None) -> TorchHandle:
    entry = _Entry(kind="broadcast", tensor=tensor.detach(),
                   name=_auto_name("broadcast", name),
                   root_rank=int(root_rank), process_set=process_set)
    (handle,) = _fusion().enqueue([entry])
    return TorchHandle(handle)


def broadcast(tensor, root_rank: int, name=None,
              process_set=None) -> torch.Tensor:
    return broadcast_async(tensor, root_rank, name, process_set).wait()


def broadcast_async_(tensor, root_rank: int, name=None,
                     process_set=None) -> TorchHandle:
    """In place: ``wait()`` writes root's value into ``tensor``."""
    handle = broadcast_async(tensor, root_rank, name, process_set)
    handle._target = tensor
    return handle


def broadcast_(tensor, root_rank: int, name=None,
               process_set=None) -> torch.Tensor:
    return broadcast_async_(tensor, root_rank, name, process_set).wait()


def grouped_allgather_async(tensors: Sequence[torch.Tensor], name=None,
                            process_set: Optional[ProcessSet] = None
                            ) -> GroupedHandle:
    """An allgather of each tensor, enqueued together."""
    base = _auto_name("grouped_allgather", name)
    entries = [_Entry(kind="allgather", tensor=t.detach(),
                      name=f"{base}.{i}", process_set=process_set)
               for i, t in enumerate(tensors)]
    return GroupedHandle([TorchHandle(h)
                          for h in _fusion().enqueue(entries)])


def grouped_allgather(tensors, name=None, process_set=None) -> list:
    return grouped_allgather_async(tensors, name, process_set).wait()


def _reducescatter_entry(tensor, name, op, prescale, postscale,
                         process_set) -> _Entry:
    if op not in (Sum, Average):
        raise ValueError(f"reducescatter supports Sum and Average, got "
                         f"op={op!r}")
    if tensor.dim() == 0:
        raise ValueError("reducescatter needs a tensor with a dim 0 to "
                         "scatter")
    return _Entry(kind="reducescatter", tensor=tensor.detach(), name=name,
                  op=op, prescale=float(prescale),
                  postscale=float(postscale), process_set=process_set)


def reducescatter_async(tensor, op=None, name=None,
                        prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0,
                        process_set: Optional[ProcessSet] = None
                        ) -> TorchHandle:
    """Reduce every rank's ``tensor`` and scatter dim 0: rank j gets its
    rows of the reduction (``ceil`` rows for the first ``dim0 % n``
    ranks, ``floor`` for the rest)."""
    entry = _reducescatter_entry(
        tensor, _auto_name("reducescatter", name), resolve_op(op),
        prescale_factor, postscale_factor, process_set)
    (handle,) = _fusion().enqueue([entry])
    return TorchHandle(handle)


def reducescatter(tensor, op=None, name=None, prescale_factor=1.0,
                  postscale_factor=1.0, process_set=None) -> torch.Tensor:
    return reducescatter_async(tensor, op, name, prescale_factor,
                               postscale_factor, process_set).wait()


def grouped_reducescatter_async(tensors: Sequence[torch.Tensor], op=None,
                                name=None, prescale_factor: float = 1.0,
                                postscale_factor: float = 1.0,
                                process_set: Optional[ProcessSet] = None
                                ) -> GroupedHandle:
    """The list as one unit: one collective over every member's
    per-rank panes."""
    base = _auto_name("grouped_reducescatter", name)
    resolved = resolve_op(op)
    entries = [_reducescatter_entry(t, f"{base}.{i}", resolved,
                                    prescale_factor, postscale_factor,
                                    process_set)
               for i, t in enumerate(tensors)]
    return GroupedHandle([TorchHandle(h)
                          for h in _fusion().enqueue(entries)])


def grouped_reducescatter(tensors, op=None, name=None, prescale_factor=1.0,
                          postscale_factor=1.0, process_set=None) -> list:
    return grouped_reducescatter_async(
        tensors, op, name, prescale_factor, postscale_factor,
        process_set).wait()


def alltoall_async(tensor, splits=None, name=None,
                   process_set: Optional[ProcessSet] = None) -> TorchHandle:
    """Scatter dim 0 of ``tensor`` over the ranks and gather what every
    rank sent this one, in rank order. ``splits`` (one count a rank of
    the set, summing to dim 0) are the rows this rank sends to each;
    without it dim 0 splits evenly. With ``splits`` the result is
    ``(output, received_splits)``."""
    n = basics.size() if process_set is None else process_set.size
    if tensor.dim() == 0:
        raise ValueError("alltoall needs a tensor with a dim 0 to split")
    if splits is None:
        if tensor.shape[0] % n:
            raise ValueError(
                f"alltoall without splits needs dim 0 ({tensor.shape[0]}) "
                f"divisible by the {n} ranks")
    else:
        splits = [int(s) for s in (splits.tolist() if torch.is_tensor(
            splits) else splits)]
        if len(splits) != n or min(splits) < 0 or sum(splits) != (
                tensor.shape[0]):
            raise ValueError(
                f"alltoall splits {splits} must be {n} non-negative counts "
                f"summing to dim 0 ({tensor.shape[0]})")
    entry = _Entry(kind="alltoall", tensor=tensor.detach(),
                   name=_auto_name("alltoall", name),
                   process_set=process_set, splits=splits)
    (handle,) = _fusion().enqueue([entry])
    return TorchHandle(handle)


def alltoall(tensor, splits=None, name=None, process_set=None):
    return alltoall_async(tensor, splits, name, process_set).wait()


def synchronize(handle):
    return handle.wait()


def poll(handle) -> bool:
    return handle.poll()


def flush() -> None:
    """Dispatch every pending collective now."""
    _fusion().flush()


class JoinContext:
    """Masked participation for uneven data (the reference's
    ``hvd.join``): inside the context every allreduce takes the mask,
    so a rank that ran out of data contributes nothing while it still
    calls the collective, and Average divides by the active count.
    Every rank enters the same context around the same allreduces."""

    _active_mask: Optional[np.ndarray] = None

    def __init__(self, joined_ranks: Sequence[int]):
        mask = np.ones(basics.size(), dtype=bool)
        for r in joined_ranks:
            mask[int(r)] = False
        self._mask = mask
        self._prev = None

    def __enter__(self):
        self._prev = JoinContext._active_mask
        JoinContext._active_mask = self._mask
        return self

    def __exit__(self, *exc):
        JoinContext._active_mask = self._prev
        return False


def _mask_key() -> Optional[tuple]:
    mask = JoinContext._active_mask
    return None if mask is None else tuple(bool(b) for b in mask)


def join_ranks(joined: Sequence[int]) -> JoinContext:
    return JoinContext(joined)


def current_join_mask() -> Optional[np.ndarray]:
    """The active join mask over the world's ranks (True: contributes),
    or None outside ``join_ranks``."""
    mask = JoinContext._active_mask
    return None if mask is None else mask.copy()


def join(joined_ranks: Optional[Sequence[int]] = None) -> int:
    """Flush what is pending; the last joined rank (the largest of
    ``joined_ranks``), or -1 when none is named."""
    _fusion().flush()
    if joined_ranks:
        return max(int(r) for r in joined_ranks)
    return -1


def barrier(process_set: Optional[ProcessSet] = None) -> None:
    """Block until every rank (of ``process_set``) reaches the barrier;
    collectives queued before it are dispatched first."""
    state = basics._require_init()
    state.fusion.flush()
    group = None
    if process_set is not None and process_set.process_set_id != 0:
        group = process_set.group
    dist.barrier(group=group)
