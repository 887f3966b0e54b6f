"""``torch.distributed`` helpers below the fusion manager
(``ops/fusion.py``), Adasum (``ops/adasum.py``) and the eager
collectives, so that a PyTorch rename or a backend's gap is handled in
one place.

- Newer PyTorch releases rename ``all_gather_into_tensor`` to
  ``all_gather_single`` and ``reduce_scatter_tensor`` to
  ``reduce_scatter_single``, keeping the old names as warning aliases;
  :func:`gather_into` and :func:`scatter_reduce_into` call whichever
  name the release has.
- gloo refuses point-to-point calls on CUDA tensors: ``isend``/``irecv``
  of a device pointer kill the process, and gloo has no list
  ``all_to_all`` at all. It takes ``all_to_all_single`` with split sizes
  on CUDA and on CPU tensors, so :func:`exchange` composes a pairwise
  exchange from that on a gloo group, chosen by the backend's name, and
  uses ``batch_isend_irecv`` on every other backend; :func:`permute`,
  the ring shift of ring attention and the pipeline schedules, is built
  the same way.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

_all_gather = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)
_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)


def gather_into(out: torch.Tensor, x: torch.Tensor, group=None,
                async_op: bool = False):
    """Allgather of every rank's contiguous ``x`` into the contiguous
    ``out`` of n times its size, rank-major."""
    return _all_gather(out.view(-1), x.reshape(-1), group=group,
                       async_op=async_op)


def scatter_reduce_into(out: torch.Tensor, x: torch.Tensor, group=None,
                        async_op: bool = False):
    """Reduce-scatter (Sum) of every rank's contiguous ``x``, n times the
    size of ``out``: rank j of the group gets the sum of every rank's
    j-th slice of ``x``."""
    return _reduce_scatter(out.view(-1), x.reshape(-1), group=group,
                           async_op=async_op)


def _backend(group, device: torch.device) -> str:
    """The backend that runs a collective of ``device`` tensors on
    ``group`` ("cpu:gloo,cuda:nccl" names one a device type)."""
    name = str(dist.get_backend(group))
    if ":" not in name:
        return name
    table = dict(part.split(":") for part in name.split(","))
    return table.get(device.type, name)


def exchange(send: Optional[torch.Tensor], recv: Optional[torch.Tensor],
             peer: Optional[int], group=None,
             like: Optional[torch.Tensor] = None) -> None:
    """Send ``send`` to and/or receive ``recv`` from the global rank
    ``peer``. Every rank of ``group`` calls it together; a rank with no
    partner this round passes ``peer=None`` and ``like``, a tensor of
    the exchange's device and dtype. On a gloo group the exchange is one
    ``all_to_all_single`` over the group, zero elements to every rank
    but the peer; elsewhere the pair calls ``batch_isend_irecv`` and the
    others return at once."""
    ref = next(t for t in (send, recv, like) if t is not None)
    if _backend(group, ref.device) != "gloo":
        ops = []
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send, peer, group=group))
        if recv is not None:
            ops.append(dist.P2POp(dist.irecv, recv, peer, group=group))
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()
        return
    n = dist.get_world_size(group)
    in_splits, out_splits = [0] * n, [0] * n
    if peer is not None:
        pos = peer if group is None else dist.get_group_rank(group, peer)
        in_splits[pos] = 0 if send is None else send.numel()
        out_splits[pos] = 0 if recv is None else recv.numel()
    empty = ref.new_empty(0)
    dist.all_to_all_single(
        empty if recv is None else recv.view(-1),
        empty if send is None else send.reshape(-1),
        out_splits, in_splits, group=group)


def permute(send: Optional[torch.Tensor], recv: Optional[torch.Tensor],
            perm, group=None, like: Optional[torch.Tensor] = None) -> None:
    """``lax.ppermute`` over ``group``: member i's ``send`` lands in
    member ``perm[i]``'s ``recv`` (positions in the group; ``perm`` a
    permutation). Every member calls it together. A member with nothing
    to send passes ``send=None``, and the member it would reach then
    passes ``recv=None``; a member with neither passes ``like``, a
    tensor of the exchange's device and dtype. On a gloo group the shift
    is one ``all_to_all_single`` with split sizes, nonzero only toward
    ``perm[me]`` and from ``perm⁻¹[me]``; elsewhere ``batch_isend_irecv``
    (a self-send is a copy)."""
    ref = next(t for t in (send, recv, like) if t is not None)
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst, src = perm[me], list(perm).index(me)
    if n == 1 or (dst == me and _backend(group, ref.device) != "gloo"):
        if recv is not None:
            recv.copy_(send.reshape(recv.shape))
        return
    if _backend(group, ref.device) != "gloo":
        def glob(pos):
            return pos if group is None else dist.get_global_rank(group, pos)

        ops = []
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send.contiguous(), glob(dst),
                                  group=group))
        if recv is not None:
            ops.append(dist.P2POp(dist.irecv, recv, glob(src), group=group))
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()
        return
    in_splits, out_splits = [0] * n, [0] * n
    in_splits[dst] = 0 if send is None else send.numel()
    out_splits[src] = 0 if recv is None else recv.numel()
    empty = ref.new_empty(0)
    dist.all_to_all_single(
        empty if recv is None else recv.view(-1),
        empty if send is None else send.reshape(-1),
        out_splits, in_splits, group=group)
