"""VGG-16, the reference's hardest-scaling benchmark model, in NCHW.

The counterpart of ``horovod_tpu/models/vgg.py``: configuration "D"'s
13 3 × 3 convolutions in five stages, each stage closed by a 2 × 2 max
pool, two dense layers of ``classifier_width`` with ReLU and dropout,
and an fp32 classifier; bf16 compute on fp32 parameters. Its 138 M
parameters make the gradient reduction weigh more against the compute
than ResNet's. The first dense layer's rows are reordered by
:func:`.convert.vgg_params_from_flax` for the NCHW flatten.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..common.config import resolve_device
from .layers import Conv, FlaxNames, dropout
from .transformer import DenseGeneral

_VGG16_STAGES: Tuple[Tuple[int, int], ...] = (
    (64, 2), (128, 2), (256, 3), (512, 3), (512, 3)
)


class VGG(FlaxNames):
    """Input ``[batch, 3, H, W]`` (H, W multiples of 32), fp32 logits.
    ``train=True`` with ``dropout`` > 0 needs ``rng``."""

    def __init__(self, stages: Sequence[Tuple[int, int]] = _VGG16_STAGES,
                 num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16,
                 classifier_width: int = 4096, dropout: float = 0.5,
                 image_size: int = 224, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype, self.dropout = dtype, dropout
        kw = dict(device=device, generator=generator)
        self.n_convs, c = 0, 3
        for width, n_convs in stages:
            for _ in range(n_convs):
                self.named("Conv", Conv(c, width, (3, 3), dtype=dtype, **kw))
                c, self.n_convs = width, self.n_convs + 1
        side = image_size // 2 ** len(stages)
        features = c * side * side
        for _ in range(2):
            self.named("Dense", DenseGeneral((features,), (classifier_width,),
                                             dtype, **kw))
            features = classifier_width
        self.named("Dense", DenseGeneral((features,), (num_classes,),
                                         torch.float32, **kw))
        self.pools = {sum(n for _, n in stages[:i + 1]) - 1
                      for i in range(len(stages))}

    def forward(self, x: torch.Tensor, train: bool = True,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
            if i in self.pools:
                x = F.max_pool2d(x, 2, 2)
        x = x.reshape(x.shape[0], -1)
        for i in range(2):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
            x = dropout(x, self.dropout, train, rng)
        return self.Dense_2(x.float())


def VGG16(**kwargs) -> VGG:
    return VGG(stages=_VGG16_STAGES, **kwargs)
