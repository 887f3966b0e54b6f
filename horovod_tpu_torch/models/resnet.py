"""ResNet-v1.5: ``bench.py``'s model, the reference's headline benchmark.

The counterpart of ``horovod_tpu/models/resnet.py`` in NCHW: bf16
compute on fp32 parameters and statistics, the reference's batch norm
(:class:`~.layers.BatchNorm`: fp32 statistics, momentum 0.9 on the old
value, the biased variance, one multiply-add in the compute dtype), an
fp32 classifier, and both stems: ``conv7`` (7 × 7 stride 2) and
``space_to_depth`` (the image folded 2× into 12 channels, then a 4 × 4
stride-1 convolution over the same output grid). Flax's ``'SAME'``
padding is asymmetric at stride 2 (:class:`~.layers.Conv` pads each
stage's first 3 × 3 stride-2 convolution (0, 1) on an even input).

The reference's ``axis_name`` becomes ``sync=True`` with an optional
``process_set``: the batch statistics are then those of the world (or
the set), through :func:`~..sync_batch_norm.global_moments`, forward
and backward. Parameters keep Flax's names (``Conv_0``,
``SyncBatchNorm_0``, ``Bottleneck_3``, ``proj_conv``, …) so
:func:`.convert.cnn_params_from_flax` carries a JAX tree across.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..common.config import resolve_device
from ..common.process_sets import ProcessSet
from .layers import BatchNorm, Conv, FlaxNames
from .transformer import DenseGeneral


class Bottleneck(FlaxNames):
    """1 × 1, 3 × 3 (with the stride), 1 × 1 to 4 × ``features``, each
    with batch norm; a projected shortcut where the shape changes."""

    def __init__(self, in_features: int, features: int, strides=(1, 1),
                 *, dtype, sync, process_set, device, generator):
        super().__init__()
        conv = dict(use_bias=False, dtype=dtype, device=device,
                    generator=generator)
        norm = dict(dtype=dtype, sync=sync, process_set=process_set,
                    device=device)
        out = features * 4
        self.named("Conv", Conv(in_features, features, (1, 1), **conv))
        self.named("SyncBatchNorm", BatchNorm(features, **norm))
        self.named("Conv", Conv(features, features, (3, 3), strides, **conv))
        self.named("SyncBatchNorm", BatchNorm(features, **norm))
        self.named("Conv", Conv(features, out, (1, 1), **conv))
        self.named("SyncBatchNorm", BatchNorm(out, **norm))
        self.proj = tuple(strides) != (1, 1) or in_features != out
        if self.proj:
            self.proj_conv = Conv(in_features, out, (1, 1), strides, **conv)
            self.proj_bn = BatchNorm(out, **norm)

    def forward(self, x, train: bool = True):
        y = F.relu(self.SyncBatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.SyncBatchNorm_1(self.Conv_1(y), train))
        y = self.SyncBatchNorm_2(self.Conv_2(y), train)
        residual = x
        if self.proj:
            residual = self.proj_bn(self.proj_conv(x), train)
        return F.relu(y + residual)


class ResNet(FlaxNames):
    """``stage_sizes`` bottlenecks a stage, ``width`` · 2^i features in
    stage i (times 4 out), stride 2 at each stage's first block but the
    first stage's. Input ``[batch, channels, H, W]``; fp32 logits.
    Parameters are fp32 on ``device`` (None: the CUDA card), initialised
    from ``generator`` as Flax initialises the JAX model."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 width: int = 64, dtype: torch.dtype = torch.bfloat16,
                 stem: str = "conv7", *,
                 sync: bool = False, process_set: Optional[ProcessSet] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype, self.stem = dtype, stem
        if stem == "space_to_depth":
            stem_conv = Conv(12, width, (4, 4),
                             padding=[(2, 1), (2, 1)], use_bias=False,
                             dtype=dtype, device=device, generator=generator)
        elif stem == "conv7":
            stem_conv = Conv(3, width, (7, 7), (2, 2),
                             padding=[(3, 3), (3, 3)], use_bias=False,
                             dtype=dtype, device=device, generator=generator)
        else:
            raise ValueError(f"unknown stem {stem!r}")
        self.named("Conv", stem_conv)
        norm = dict(dtype=dtype, sync=sync, process_set=process_set,
                    device=device)
        self.named("SyncBatchNorm", BatchNorm(width, **norm))
        features, self.n_blocks = width, sum(stage_sizes)
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                self.named("Bottleneck", Bottleneck(
                    features, width * 2 ** i, strides, dtype=dtype,
                    sync=sync, process_set=process_set, device=device,
                    generator=generator))
                features = width * 2 ** i * 4
        self.named("Dense", DenseGeneral(
            (features,), (num_classes,), torch.float32, device=device,
            generator=generator))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.stem == "space_to_depth":
            n, c, h, w = x.shape
            if h % 2 or w % 2:
                raise ValueError(f"space_to_depth stem needs even spatial "
                                 f"dims, got {(h, w)}")
            # channel (py·2 + px)·c + cc, as the reference's NHWC fold
            x = (x.reshape(n, c, h // 2, 2, w // 2, 2)
                 .permute(0, 3, 5, 1, 2, 4)
                 .reshape(n, 4 * c, h // 2, w // 2))
        x = F.relu(self.SyncBatchNorm_0(self.Conv_0(x), train))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for i in range(self.n_blocks):
            x = getattr(self, f"Bottleneck_{i}")(x, train)
        return self.Dense_0(x.mean((2, 3)).float())


def ResNet50(**kwargs) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), **kwargs)


def ResNet101(**kwargs) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), **kwargs)
