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
- ``synchronize``, ``poll`` and ``barrier``.

Alltoall, reducescatter and join come with ROADMAP A2.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..common import basics
from ..common.process_sets import ProcessSet
from .compression import check_supported
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
    if return_residual and wire not in (None, "int8"):
        raise ValueError(
            "return_residual=True needs the int8 quantized wire "
            "(Compression.int8 / int8_block, or no compression= with "
            "HOROVOD_FUSION_WIRE=int8); the error-feedback residual IS "
            "the quantization error"
        )
    return "int8" if return_residual else wire


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
                     compression, return_residual=False, guard=False):
    check_supported(compression)
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
                   want_residual=bool(return_residual), guard=bool(guard))
    return entry, post


def allreduce_async(tensor, average=None, name=None, op=None,
                    process_set: Optional[ProcessSet] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    compression=None,
                    return_residual: bool = False, *,
                    guard: bool = False) -> TorchHandle:
    entry, post = _allreduce_entry(
        tensor, _auto_name("allreduce", name), resolve_op(op, average),
        prescale_factor, postscale_factor, process_set, compression,
        return_residual, guard,
    )
    (handle,) = _fusion().enqueue([entry])
    return TorchHandle(handle, post)


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


def synchronize(handle):
    return handle.wait()


def poll(handle) -> bool:
    return handle.poll()


def barrier(process_set: Optional[ProcessSet] = None) -> None:
    """Block until every rank (of ``process_set``) reaches the barrier;
    collectives queued before it are dispatched first."""
    state = basics._require_init()
    state.fusion.flush()
    group = None
    if process_set is not None and process_set.process_set_id != 0:
        group = process_set.group
    dist.barrier(group=group)
