"""Batch norm with the statistics of the whole world: ``hvd.SyncBatchNorm``.

The counterpart of ``horovod_tpu/torch/sync_batch_norm.py``. Every rank
normalises, and differentiates, with the global batch's statistics:

* :func:`global_moments` (a ``torch.autograd.Function``) reduces each
  channel's sum, sum of squares and the element count in **one** fused
  allreduce through :func:`~.ops.eager.allreduce` and returns the global
  mean, mean of squares and count. Its backward sums the two gradients
  that reach the mean and the mean of squares in **one** more allreduce,
  so each rank's input gradient is that of the loss summed over every
  rank's batch. Parameter gradients stay local, for
  ``DistributedOptimizer`` to reduce, as in the reference;
* :class:`SyncBatchNorm` is the drop-in for ``torch.nn.BatchNorm1d/2d/
  3d`` on top of it, with the reference's running statistics: momentum
  0.1 on the new value (None: the cumulative mean) and the unbiased
  variance over the global count.

The reference ResNet's batch norm (``models/layers.py``'s
:class:`~.models.layers.BatchNorm`, Flax's rules) takes its statistics
from the same function when it syncs. In a world of one either equals
local batch norm.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .common.config import resolve_device
from .common.process_sets import ProcessSet
from .ops import eager
from .ops.reduction_ops import Sum


def _dims(x: torch.Tensor):
    return [0] + list(range(2, x.dim()))


def _shape(x: torch.Tensor):
    return (1, -1) + (1,) * (x.dim() - 2)


def _acc(x: torch.Tensor) -> torch.dtype:
    """The statistics' dtype: fp32, or x's own where it is wider."""
    return torch.promote_types(x.dtype, torch.float32)


def local_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's per-channel mean and mean of squares, accumulated in
    fp32 or wider (the squares in x's dtype, as the reference squares
    them)."""
    dims, acc = _dims(x), _acc(x)
    return (torch.mean(x, dims, dtype=acc), torch.mean(x * x, dims, dtype=acc))


class _GlobalMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, process_set):
        dims, c, acc = _dims(x), x.shape[1], _acc(x)
        count = x.new_full((1,), x.numel() // c, dtype=acc)
        local = torch.cat([torch.sum(x, dims, dtype=acc),
                           torch.sum(x * x, dims, dtype=acc), count])
        total = eager.allreduce(local, op=Sum, process_set=process_set,
                                name="sync_batch_norm.stats")
        n = total[2 * c]
        ctx.save_for_backward(x, n)
        ctx.process_set = process_set
        ctx.mark_non_differentiable(n)
        return total[:c] / n, total[c:2 * c] / n, n

    @staticmethod
    def backward(ctx, g_mean, g_mean2, _g_n):
        x, n = ctx.saved_tensors
        c = x.shape[1]
        zeros = x.new_zeros(c, dtype=n.dtype)
        local = torch.cat([zeros if g_mean is None else g_mean.to(n.dtype),
                           zeros if g_mean2 is None else g_mean2.to(n.dtype)])
        total = eager.allreduce(local, op=Sum, process_set=ctx.process_set,
                                name="sync_batch_norm.grads")
        # d mean / dx = 1/n; d mean2 / dx = 2x/n: one multiply-add in
        # x's dtype
        shape = _shape(x)
        dx = (x * (2.0 * total[c:] / n).to(x.dtype).view(shape)
              + (total[:c] / n).to(x.dtype).view(shape))
        return dx, None


def global_moments(x: torch.Tensor, process_set: Optional[ProcessSet] = None):
    """The per-channel (axis 1) mean and mean of squares over every
    rank's ``x`` (of ``process_set``; None: the world), in fp32 or x's
    dtype where wider, and the global element count a channel, as a
    device scalar."""
    return _GlobalMoments.apply(x, process_set)


class SyncBatchNorm(nn.Module):
    """``torch.nn.BatchNorm1d/2d/3d`` with the world's statistics in
    training (the reference's ``hvd.SyncBatchNorm``). In evaluation it
    normalises with the running statistics, or, without them, with the
    local batch's and no collective."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: Optional[float] = 0.1, affine: bool = True,
                 track_running_stats: bool = True,
                 process_set: Optional[ProcessSet] = None, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_features = num_features
        self.eps, self.momentum = eps, momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.process_set = process_set
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features,
                                                  device=device))
            self.bias = nn.Parameter(torch.zeros(num_features,
                                                 device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        if track_running_stats:
            self.register_buffer("running_mean",
                                 torch.zeros(num_features, device=device))
            self.register_buffer("running_var",
                                 torch.ones(num_features, device=device))
            self.register_buffer("num_batches_tracked",
                                 torch.tensor(0, dtype=torch.long,
                                              device=device))
        else:
            for name in ("running_mean", "running_var",
                         "num_batches_tracked"):
                self.register_buffer(name, None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() < 2:
            raise ValueError(f"expected at least 2D input, got {x.dim()}D")
        if x.shape[1] != self.num_features:
            raise ValueError(f"expected {self.num_features} channels, got "
                             f"{x.shape[1]}")
        if self.training:
            mean, mean2, n = global_moments(x, self.process_set)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            if self.track_running_stats:
                with torch.no_grad():
                    self.num_batches_tracked += 1
                    m = (self.momentum if self.momentum is not None
                         else 1.0 / float(self.num_batches_tracked))
                    unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
                    self.running_mean.mul_(1 - m).add_(m * mean)
                    self.running_var.mul_(1 - m).add_(m * unbiased)
        elif self.track_running_stats:
            mean, var = self.running_mean, self.running_var
        else:
            mean, mean2 = local_moments(x)
            var = mean2 - mean * mean
        shape = _shape(x)
        out = (x - mean.to(x.dtype).view(shape)) * torch.rsqrt(
            var + self.eps).to(x.dtype).view(shape)
        if self.affine:
            out = out * self.weight.view(shape) + self.bias.view(shape)
        return out

    def extra_repr(self) -> str:
        return (f"{self.num_features}, eps={self.eps}, "
                f"momentum={self.momentum}, affine={self.affine}, "
                f"track_running_stats={self.track_running_stats}")
