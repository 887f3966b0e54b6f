"""Tensor parallelism: Megatron-style column/row parallel matmuls.

The counterpart of ``horovod_tpu/parallel/tp.py``. Weight shards live on
the tp axis and activations stay replicated across it. Here each rank
differentiates its own program with autograd, so the collective of each
layer is an autograd Function with its conjugate in the backward, as
Megatron-LM places them:

- :func:`copy_to` (Megatron's f): the identity forward, an all-reduce of
  the gradient backward; it sits where a replicated activation enters
  the sharded matmuls, so each rank's input gradient sums every shard's
  share;
- :func:`reduce_from` (Megatron's g): an all-reduce forward, the
  identity backward; it sits where the shards' partial outputs combine.

With both in place every tp rank holds the whole gradient of each
replicated leaf and the exact gradient of its own shards: the JAX step's
division of sharded leaves' gradients by the axis size (shard_map's
transpose of psum over-counts them) has no counterpart here.

- column parallel: W split along output features → :func:`copy_to`, a
  local matmul; activations become tp-sharded on the feature dim.
- row parallel: W split along input features → a local matmul,
  :func:`reduce_from` (one all-reduce, exactly where Megatron places it).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Axis, world_axis


def _all_reduce(x: torch.Tensor, axis: Axis, op=dist.ReduceOp.SUM):
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=axis.group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, axis: Optional[Axis] = None) -> torch.Tensor:
    """Megatron's f over ``axis`` (default the world): identity forward,
    all-reduce (Sum) of the gradient backward."""
    axis = axis or world_axis()
    return x if axis.size == 1 else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Optional[Axis] = None
                ) -> torch.Tensor:
    """Megatron's g over ``axis`` (default the world): all-reduce (Sum)
    forward, identity backward."""
    axis = axis or world_axis()
    return x if axis.size == 1 else _ReduceFrom.apply(x, axis)


def column_parallel_dense(x, w_shard, b_shard=None,
                          axis: Optional[Axis] = None):
    """x: [..., D]; w_shard: [D, F/tp] → [..., F/tp]. No communication
    forward; the input's gradient is summed over ``axis``."""
    y = torch.einsum("...d,df->...f", copy_to(x, axis), w_shard)
    if b_shard is not None:
        y = y + b_shard
    return y


def row_parallel_dense(x_shard, w_shard, b=None,
                       axis: Optional[Axis] = None):
    """x_shard: [..., F/tp]; w_shard: [F/tp, D] → all-reduce over
    ``axis`` → [..., D].

    The bias is added after the reduce on every rank (it is replicated)."""
    y = torch.einsum("...f,fd->...d", x_shard, w_shard)
    y = reduce_from(y, axis)
    if b is not None:
        y = y + b
    return y
