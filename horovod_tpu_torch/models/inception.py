"""Inception V3, the reference's headline scaling model, in NCHW.

The counterpart of ``horovod_tpu/models/inception.py``: the stem from
299² to 35², three A blocks, the B reduction to 17², four C blocks with
the factorised 7 × 1 / 1 × 7 towers, the D reduction to 8², two E
blocks, global mean, dropout and an fp32 classifier; no auxiliary head,
as in the reference. Every convolution is a :class:`ConvBN` (no bias,
the reference ResNet's batch norm, ReLU). Branches concatenate on the
channel axis. The 3 × 3 average pools count their zero padding, as
Flax's ``avg_pool(..., padding='SAME')`` does.

Each block lists its ``ConvBN_k`` in the order the JAX module builds
them, which is not the order they run: in ``conv(96)(conv(64)(x))`` the
outer one is built first. So the parameter names match the JAX tree's
and :func:`.convert.cnn_params_from_flax` maps it by name.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..common.config import resolve_device
from ..common.process_sets import ProcessSet
from .layers import BatchNorm, Conv, FlaxNames, avg_pool_same, dropout
from .transformer import DenseGeneral


class ConvBN(FlaxNames):
    """Convolution without bias, batch norm, ReLU."""

    def __init__(self, in_features, features, kernel=(3, 3), strides=(1, 1),
                 padding="SAME", *, dtype, sync, process_set, device,
                 generator):
        super().__init__()
        self.named("Conv", Conv(in_features, features, kernel, strides,
                                padding, use_bias=False, dtype=dtype,
                                device=device, generator=generator))
        self.named("SyncBatchNorm", BatchNorm(
            features, dtype=dtype, sync=sync, process_set=process_set,
            device=device))

    def forward(self, x, train: bool = True):
        return F.relu(self.SyncBatchNorm_0(self.Conv_0(x), train))


class _Block(FlaxNames):
    """A block of :class:`ConvBN` layers ``ConvBN_0 …`` built from
    ``specs``: (in_features, features, kernel, strides, padding)."""

    def __init__(self, specs, **kw):
        super().__init__()
        for in_f, f, kernel, strides, padding in specs:
            self.named("ConvBN", ConvBN(in_f, f, kernel, strides, padding,
                                        **kw))

    def conv(self, k: int, x, train: bool):
        return getattr(self, f"ConvBN_{k}")(x, train)


_S1, _S2 = (1, 1), (2, 2)


class InceptionA(_Block):
    def __init__(self, c: int, pool_features: int, **kw):
        super().__init__([
            (c, 64, (1, 1), _S1, "SAME"),
            (48, 64, (5, 5), _S1, "SAME"), (c, 48, (1, 1), _S1, "SAME"),
            (96, 96, (3, 3), _S1, "SAME"), (64, 96, (3, 3), _S1, "SAME"),
            (c, 64, (1, 1), _S1, "SAME"),
            (c, pool_features, (1, 1), _S1, "SAME"),
        ], **kw)

    def forward(self, x, train: bool = True):
        b1 = self.conv(0, x, train)
        b2 = self.conv(1, self.conv(2, x, train), train)
        b3 = self.conv(3, self.conv(4, self.conv(5, x, train), train), train)
        b4 = self.conv(6, avg_pool_same(x), train)
        return torch.cat([b1, b2, b3, b4], dim=1)


class InceptionB(_Block):
    """Grid reduction 35 → 17."""

    def __init__(self, c: int, **kw):
        super().__init__([
            (c, 384, (3, 3), _S2, "VALID"),
            (96, 96, (3, 3), _S2, "VALID"), (64, 96, (3, 3), _S1, "SAME"),
            (c, 64, (1, 1), _S1, "SAME"),
        ], **kw)

    def forward(self, x, train: bool = True):
        b1 = self.conv(0, x, train)
        b2 = self.conv(1, self.conv(2, self.conv(3, x, train), train), train)
        return torch.cat([b1, b2, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(_Block):
    """The factorised 7 × 7 towers."""

    def __init__(self, c: int, c7: int, **kw):
        super().__init__([
            (c, 192, (1, 1), _S1, "SAME"),
            (c, c7, (1, 1), _S1, "SAME"), (c7, c7, (1, 7), _S1, "SAME"),
            (c7, 192, (7, 1), _S1, "SAME"),
            (c, c7, (1, 1), _S1, "SAME"), (c7, c7, (7, 1), _S1, "SAME"),
            (c7, c7, (1, 7), _S1, "SAME"), (c7, c7, (7, 1), _S1, "SAME"),
            (c7, 192, (1, 7), _S1, "SAME"),
            (c, 192, (1, 1), _S1, "SAME"),
        ], **kw)

    def forward(self, x, train: bool = True):
        b1 = self.conv(0, x, train)
        b2 = x
        for k in (1, 2, 3):
            b2 = self.conv(k, b2, train)
        b3 = x
        for k in (4, 5, 6, 7, 8):
            b3 = self.conv(k, b3, train)
        b4 = self.conv(9, avg_pool_same(x), train)
        return torch.cat([b1, b2, b3, b4], dim=1)


class InceptionD(_Block):
    """Grid reduction 17 → 8."""

    def __init__(self, c: int, **kw):
        super().__init__([
            (192, 320, (3, 3), _S2, "VALID"), (c, 192, (1, 1), _S1, "SAME"),
            (c, 192, (1, 1), _S1, "SAME"), (192, 192, (1, 7), _S1, "SAME"),
            (192, 192, (7, 1), _S1, "SAME"),
            (192, 192, (3, 3), _S2, "VALID"),
        ], **kw)

    def forward(self, x, train: bool = True):
        b1 = self.conv(0, self.conv(1, x, train), train)
        b2 = x
        for k in (2, 3, 4, 5):
            b2 = self.conv(k, b2, train)
        return torch.cat([b1, b2, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(_Block):
    """The expanded 8 × 8 blocks with split 1 × 3 / 3 × 1 branches."""

    def __init__(self, c: int, **kw):
        super().__init__([
            (c, 320, (1, 1), _S1, "SAME"),
            (c, 384, (1, 1), _S1, "SAME"), (384, 384, (1, 3), _S1, "SAME"),
            (384, 384, (3, 1), _S1, "SAME"),
            (c, 448, (1, 1), _S1, "SAME"), (448, 384, (3, 3), _S1, "SAME"),
            (384, 384, (1, 3), _S1, "SAME"), (384, 384, (3, 1), _S1, "SAME"),
            (c, 192, (1, 1), _S1, "SAME"),
        ], **kw)

    def forward(self, x, train: bool = True):
        b1 = self.conv(0, x, train)
        b2 = self.conv(1, x, train)
        b2 = torch.cat([self.conv(2, b2, train), self.conv(3, b2, train)],
                       dim=1)
        b3 = self.conv(5, self.conv(4, x, train), train)
        b3 = torch.cat([self.conv(6, b3, train), self.conv(7, b3, train)],
                       dim=1)
        b4 = self.conv(8, avg_pool_same(x), train)
        return torch.cat([b1, b2, b3, b4], dim=1)


class InceptionV3(FlaxNames):
    """Input ``[batch, 3, 299, 299]``, fp32 logits; bf16 compute on fp32
    parameters. ``sync``/``process_set`` as :class:`~.resnet.ResNet`'s;
    ``train=True`` with ``dropout`` > 0 needs ``rng``."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, dropout: float = 0.5,
                 *, sync: bool = False,
                 process_set: Optional[ProcessSet] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype, self.dropout = dtype, dropout
        kw = dict(dtype=dtype, sync=sync, process_set=process_set,
                  device=device, generator=generator)
        for in_f, f, kernel, strides, padding in (
                (3, 32, (3, 3), _S2, "VALID"),
                (32, 32, (3, 3), _S1, "VALID"), (32, 64, (3, 3), _S1, "SAME"),
                (64, 80, (1, 1), _S1, "VALID"),
                (80, 192, (3, 3), _S1, "VALID")):
            self.named("ConvBN", ConvBN(in_f, f, kernel, strides, padding,
                                        **kw))
        self.named("InceptionA", InceptionA(192, 32, **kw))
        self.named("InceptionA", InceptionA(256, 64, **kw))
        self.named("InceptionA", InceptionA(288, 64, **kw))
        self.named("InceptionB", InceptionB(288, **kw))
        for c7 in (128, 160, 160, 192):
            self.named("InceptionC", InceptionC(768, c7, **kw))
        self.named("InceptionD", InceptionD(768, **kw))
        self.named("InceptionE", InceptionE(1280, **kw))
        self.named("InceptionE", InceptionE(2048, **kw))
        self.named("Dense", DenseGeneral((2048,), (num_classes,),
                                         torch.float32, device=device,
                                         generator=generator))

    def forward(self, x: torch.Tensor, train: bool = True,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.to(self.dtype)
        x = self.ConvBN_1(self.ConvBN_0(x, train), train)
        x = F.max_pool2d(self.ConvBN_2(x, train), 3, 2)
        x = self.ConvBN_4(self.ConvBN_3(x, train), train)
        x = F.max_pool2d(x, 3, 2)
        for name in ("InceptionA_0", "InceptionA_1", "InceptionA_2",
                     "InceptionB_0", "InceptionC_0", "InceptionC_1",
                     "InceptionC_2", "InceptionC_3", "InceptionD_0",
                     "InceptionE_0", "InceptionE_1"):
            x = getattr(self, name)(x, train)
        x = dropout(x.mean((2, 3)), self.dropout, train, rng)
        return self.Dense_0(x.float())
