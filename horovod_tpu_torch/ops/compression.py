"""Gradient wire compression: ``Compression.none``, ``fp16`` and
``bf16``, each a (compress, decompress) pair around the allreduce, as in
``horovod_tpu/ops/compression.py`` and the reference's
``horovod/torch/compression.py``.

The int8 family (``int8``, ``int8_block``, ``hier_int8``) quantizes on
kernels B1–B3, which a later slice ports (ROADMAP A2, B1–B3): naming
one raises ``NotImplementedError`` instead of sending full width.
"""

from __future__ import annotations

import torch


class Compressor:
    """A (compress, decompress) pair. ``compress`` returns (tensor, ctx)."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    """Cast floating tensors to ``wire_dtype`` on the wire and back to
    their own type after."""

    wire_dtype: torch.dtype

    @classmethod
    def compress(cls, tensor):
        ctx = tensor.dtype
        if tensor.is_floating_point():
            tensor = tensor.to(cls.wire_dtype)
        return tensor, ctx

    @staticmethod
    def decompress(tensor, ctx):
        return tensor.to(ctx) if tensor.dtype != ctx else tensor


class FP16Compressor(_CastCompressor):
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    """bf16 on the wire: fp32's exponent range at half the bytes."""

    wire_dtype = torch.bfloat16


class _Unported:
    """A compressor of a later slice: any use raises."""

    def __init__(self, name: str):
        self.name = name

    def _raise(self, *_):
        raise NotImplementedError(
            f"Compression.{self.name} quantizes on kernels B1-B3, not "
            "ported yet (ROADMAP A2, B1-B3); use none, fp16 or bf16"
        )

    compress = decompress = _raise


class Compression:
    """``hvd.Compression`` namespace."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = _Unported("int8")
    int8_block = _Unported("int8_block")
    hier_int8 = _Unported("hier_int8")


def check_supported(compression) -> None:
    """Raise now, at construction, for a compressor of a later slice."""
    if isinstance(compression, _Unported):
        compression.compress(None)
