"""ViT-B/16, the reference's elastic-training benchmark model (BASELINE
.json's fifth configuration).

The counterpart of ``horovod_tpu/models/vit.py``: a strided convolution
cuts the image into patches, a learned cls token and position table are
added, the port's Transformer :class:`~.transformer.Block` runs
bidirectionally (``causal=False``), and the final LayerNorm's cls row
alone feeds an fp32 head.

The 14 × 14 + 1 = 197 tokens of ViT-B/16 keep ``flash_pad``'s
contract: ``True`` pads the sequence at the end to the next multiple of
8 and attends with ``lengths = 197`` (padded query rows come out zero
and no key past the length is seen); ``"auto"`` pads whenever the flash
kernels run, as the JAX model does on its chip, so on CUDA ViT-B/16
runs t = 200 with lengths 197 through the tensor-core flash kernels;
``False`` keeps the unpadded sequence.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..common.config import resolve_device
from .layers import Conv
from .transformer import _LN_EPS, Block, DenseGeneral, TransformerConfig


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12
    d_ff: int = 3072
    dtype: torch.dtype = torch.bfloat16
    # pad the tokens to a multiple of 8 with lengths=: True, False, or
    # "auto" = whenever the encoder takes the flash kernels
    flash_pad: Any = "auto"
    # the encoder blocks' TransformerConfig.flash_attention
    flash_attention: Any = "auto"

    @staticmethod
    def b16() -> "ViTConfig":
        return ViTConfig()

    @staticmethod
    def tiny() -> "ViTConfig":
        return ViTConfig(image_size=32, patch_size=8, num_classes=10,
                         num_layers=2, d_model=64, num_heads=4, d_ff=128,
                         dtype=torch.float32)

    @property
    def tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1

    def encoder_config(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=1, num_layers=self.num_layers, d_model=self.d_model,
            num_heads=self.num_heads, d_ff=self.d_ff, max_len=self.tokens,
            causal=False, dtype=self.dtype,
            flash_attention=self.flash_attention,
        )

    def pads(self, device) -> bool:
        """Whether the forward pads the tokens (``flash_pad``)."""
        t = self.tokens
        if t % 8 == 0:
            return False
        if self.flash_pad == "auto":
            return self.encoder_config().uses_flash(device=device)
        return bool(self.flash_pad)


class ViT(nn.Module):
    """Input ``[batch, 3, H, W]``, fp32 logits ``[batch, num_classes]``.
    Parameters in fp32 on ``device`` (None: the CUDA card), initialised
    from ``generator`` as Flax initialises the JAX model; the names
    follow its tree (``patchify``, ``cls``, ``pos_embed``, ``blocks``,
    ``ln``, ``head``)."""

    def __init__(self, cfg: ViTConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        enc = cfg.encoder_config()
        p, d = cfg.patch_size, cfg.d_model
        self.patchify = Conv(3, d, (p, p), (p, p), dtype=cfg.dtype,
                             device=device, generator=generator)
        self.cls = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.tokens, d,
                                                  device=device))
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        self.blocks = nn.ModuleList(
            Block(enc, device=device, generator=generator)
            for _ in range(cfg.num_layers))
        self.ln = nn.LayerNorm(d, eps=_LN_EPS, device=device)
        self.head = DenseGeneral((d,), (cfg.num_classes,), torch.float32,
                                 device=device, generator=generator)

    def forward(self, images: torch.Tensor, train: bool = True):
        """``train`` is the reference's argument; ViT has no dropout, so
        both modes compute the same."""
        cfg = self.cfg
        dt = cfg.dtype
        x = self.patchify(images.to(dt))  # [b, d, h, w]
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # [b, h·w, d], row-major patches
        x = torch.cat([self.cls.to(dt).expand(b, 1, -1), x], dim=1)
        x = x + self.pos_embed.to(dt)
        t = x.shape[1]
        lengths = None
        if cfg.pads(x.device):
            x = F.pad(x, (0, 0, 0, -(-t // 8) * 8 - t))
            lengths = torch.full((b,), t, dtype=torch.int32, device=x.device)
        for block in self.blocks:
            x = block(x, None, lengths)
        # only the cls row feeds the head; padded rows are never read
        x = self.ln(x[:, 0].float())
        return self.head(x)
