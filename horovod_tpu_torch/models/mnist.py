"""The MNIST ConvNet of the reference's example (BASELINE.json's first
configuration), in NCHW.

The counterpart of ``horovod_tpu/models/mnist.py``: 5 × 5 convolutions
to 10 and 20 channels, each with ReLU and a 2 × 2 max pool, a dense
layer of 50, dropout 0.5, and the classifier. The JAX model flattens
NHWC before its first dense layer; the port flattens NCHW, and
:func:`.convert.mnist_params_from_flax` reorders that layer's rows to
match.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..common.config import resolve_device
from .layers import Conv, FlaxNames, dropout
from .transformer import DenseGeneral


class MNISTConvNet(FlaxNames):
    """Input ``[batch, 1, 28, 28]``, fp32 logits. ``train=True`` drops
    out with the masks of ``rng``."""

    def __init__(self, num_classes: int = 10, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.named("Conv", Conv(1, 10, (5, 5), padding="VALID", **kw))
        self.named("Conv", Conv(10, 20, (5, 5), padding="VALID", **kw))
        self.named("Dense", DenseGeneral((320,), (50,), torch.float32, **kw))
        self.named("Dense", DenseGeneral((50,), (num_classes,),
                                         torch.float32, **kw))

    def forward(self, x: torch.Tensor, train: bool = True,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.max_pool2d(F.relu(self.Conv_0(x.float())), 2, 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = F.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        return self.Dense_1(dropout(x, 0.5, train, rng))
