"""The convolutional zoo's building blocks, with Flax's numerics in NCHW.

Shared by :mod:`.resnet`, :mod:`.inception`, :mod:`.vgg`, :mod:`.mnist`
and :mod:`.vit`, the counterparts of ``horovod_tpu/models/``. The JAX
models run NHWC; the port keeps PyTorch's NCHW and matches them where
the order shows:

* :class:`Conv` is ``flax.linen.Conv``: an OIHW weight (the carrier
  transposes Flax's HWIO kernel), ``lecun_normal`` initialisation, the
  weight and input cast to ``dtype`` at use, and Flax's ``'SAME'``
  padding, which XLA splits with the extra row and column at the end:
  a 3 × 3 stride-2 convolution of an even input pads (0, 1), where
  ``torch.nn.Conv2d(padding=1)`` pads (1, 1) and gives the same size
  and shifted values. The pads are worked out from each input's size.
* :class:`BatchNorm` is the reference ResNet's ``SyncBatchNorm``:
  statistics accumulate in fp32, the running statistics take momentum
  0.9 on the old value and keep the biased variance ``E[x²] − E[x]²``,
  and the normalisation is one multiply-add in the compute dtype. With
  ``sync=True`` the statistics are those of the whole world (or of
  ``process_set``), reduced by :func:`~..sync_batch_norm.global_moments`,
  forward and backward.
* :class:`FlaxNames` gives child modules Flax's automatic names
  (``Conv_0``, ``SyncBatchNorm_1``, …) in the order the JAX module
  builds them, so :func:`.convert.cnn_params_from_flax` maps a
  parameter tree by name alone.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..common.process_sets import ProcessSet
from ..sync_batch_norm import global_moments, local_moments
from .transformer import _trunc_normal_

Padding = Union[str, Sequence[Tuple[int, int]]]


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``'SAME'`` padding of one axis: ``ceil(size / stride)``
    outputs, the odd row or column of padding at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class FlaxNames(nn.Module):
    """A module whose children take Flax's automatic names: the k-th
    child of a kind is ``f"{kind}_{k}"``."""

    def __init__(self):
        super().__init__()
        self._counts = {}

    def named(self, kind: str, module: nn.Module) -> nn.Module:
        k = self._counts.get(kind, 0)
        self._counts[kind] = k + 1
        self.add_module(f"{kind}_{k}", module)
        return module


class Conv(nn.Module):
    """``flax.linen.Conv`` in NCHW: ``weight [out, in, kh, kw]`` (fp32,
    ``lecun_normal``), an optional fp32 bias (zeros), ``padding``
    ``'SAME'``, ``'VALID'`` or explicit ``[(lo, hi), (lo, hi)]``; the
    input, weight and bias cast to ``dtype`` at use (None: the input's
    dtype)."""

    def __init__(self, in_features: int, features: int,
                 kernel: Sequence[int], strides: Sequence[int] = (1, 1),
                 padding: Padding = "SAME", use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator=None):
        super().__init__()
        kh, kw = kernel
        self.kernel, self.strides = (kh, kw), tuple(strides)
        self.padding, self.dtype = padding, dtype
        self.weight = nn.Parameter(
            torch.empty(features, in_features, kh, kw, device=device))
        _trunc_normal_(self.weight, in_features * kh * kw, generator)
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def _pads(self, x: torch.Tensor) -> Tuple[int, int, int, int]:
        """(top, bottom, left, right)."""
        if self.padding == "VALID":
            return 0, 0, 0, 0
        if self.padding == "SAME":
            return (*same_pads(x.shape[2], self.kernel[0], self.strides[0]),
                    *same_pads(x.shape[3], self.kernel[1], self.strides[1]))
        (t, b), (l, r) = self.padding
        return t, b, l, r

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        x = x.to(dt)
        t, b, l, r = self._pads(x)
        if t == b and l == r:
            pad = (t, l)
        else:  # asymmetric: pad explicitly, then convolve unpadded
            x = F.pad(x, (l, r, t, b))
            pad = (0, 0)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x, self.weight.to(dt), bias, self.strides, pad)


class BatchNorm(nn.Module):
    """The reference ResNet's batch norm (``resnet.py:24-73``) over the
    channel axis of NCHW: ``weight`` (Flax's scale) and ``bias`` in
    fp32, fp32 ``running_mean``/``running_var`` (Flax's ``batch_stats``
    mean and var). Training normalises with the batch's statistics and
    updates the running ones as ``0.9 · old + 0.1 · new`` with the
    biased variance; evaluation uses the running ones. The output is in
    ``dtype`` (None: the input's)."""

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype: Optional[torch.dtype] = None,
                 sync: bool = False,
                 process_set: Optional[ProcessSet] = None, device=None):
        super().__init__()
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
        self.sync, self.process_set = sync, process_set
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if train:
            if self.sync:
                mean, mean2, _ = global_moments(x, self.process_set)
            else:
                mean, mean2 = local_moments(x)
            var = mean2 - mean * mean
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        # fold in fp32 over [C], then one multiply-add in x's dtype
        inv = torch.rsqrt(var + self.epsilon) * self.weight
        shape = (1, -1) + (1,) * (x.dim() - 2)
        y = (x * inv.to(x.dtype).view(shape)
             + (self.bias - mean * inv).to(x.dtype).view(shape))
        return y.to(self.dtype or x.dtype)


def avg_pool_same(x, window: int = 3):
    """``flax.linen.avg_pool(x, (w, w), (1, 1), padding='SAME')``: the
    zero padding counts in the mean (Flax's ``count_include_pad``)."""
    return F.avg_pool2d(x, window, 1, window // 2, count_include_pad=True)


def dropout(x: torch.Tensor, rate: float, train: bool,
            rng: Optional[torch.Generator]) -> torch.Tensor:
    """``flax.linen.Dropout``: in training keep each element with
    probability ``1 − rate`` (masks from ``rng``) and scale the kept
    ones by ``1 / (1 − rate)``; the identity otherwise."""
    if not train or rate == 0.0:
        return x
    if rng is None:
        raise ValueError("train=True with dropout > 0 needs rng= (a "
                         "torch.Generator on the model's device)")
    keep = 1.0 - rate
    kept = torch.rand(x.shape, generator=rng, device=x.device) < keep
    return torch.where(kept, x / keep, 0.0).to(x.dtype)
