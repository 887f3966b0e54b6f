"""Gradient wire compression, as in ``horovod_tpu/ops/compression.py``
and the reference's ``horovod/torch/compression.py``: each compressor is
a (compress, decompress) pair around the allreduce.

- ``Compression.none``, ``fp16`` and ``bf16`` cast floating tensors on
  the wire. ``none`` names the ``fp32`` wire explicitly: passing it opts
  an allreduce out of a configured int8 wire (``HOROVOD_FUSION_WIRE``).
- ``Compression.int8`` (one scale per tensor) and ``int8_block`` (one
  per ``block_size`` elements, 512 by default; ``with_block_size(b)``
  makes a variant) quantize with stochastic rounding on kernels B2 and
  B3 (``ops/cuda_kernels.py``), and ``int8.decompress`` dequantizes on
  B1. Raw int8 must never be summed across ranks (it wraps, and each
  rank's scale differs), so an allreduce or ``DistributedOptimizer``
  handed one of these (``quantized_wire``) routes the whole fused
  buffer through the fusion manager's int8 wire instead of compressing
  tensor by tensor. ``compress``/``decompress`` serve the manual use:
  around an allgather or broadcast, where no arithmetic touches the
  wire values. Integer tensors pass through untouched.
- ``Compression.hier_int8`` is ``int8_block`` with the two-level
  placement: an allreduce or ``DistributedOptimizer`` handed it sends
  the fused buffer in bf16 within each node and as block-scaled int8
  across nodes whenever a two-level split resolves
  (``common/topology.py hierarchy_stages``; ``HOROVOD_INTRA_SIZE``
  works on one host), and over the flat int8 wire when the hierarchy
  degenerates.
"""

from __future__ import annotations

import torch

from . import cuda_kernels


class Compressor:
    """A (compress, decompress) pair. ``compress`` returns (tensor, ctx).
    ``wire_format`` is the fused wire an allreduce handed this
    compressor uses (None: the manager's configured wire)."""

    wire_format = None
    quantized_wire = False

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    # "fp32", not None: Compression.none opts out of a configured
    # quantized wire, so an exactness-sensitive reduction stays exact
    wire_format = "fp32"

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    """Cast floating tensors to ``wire_dtype`` on the wire and back to
    their own type after."""

    wire_format = "bf16"
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


class Int8Compressor(Compressor):
    """int8 values and one fp32 scale per tensor, stochastic rounding
    (unbiased), on kernel B2; ``decompress`` is kernel B1. Pass a fresh
    ``seed`` per call (the step counter, say) so the rounding stays
    unbiased over time and not merely per call."""

    quantized_wire = True
    wire_format = "int8"

    @staticmethod
    def compress(tensor, seed=0):
        ctx = tensor.dtype
        if tensor.is_floating_point():
            values, scale = cuda_kernels.int8_quantize(tensor, seed=seed)
            return values, (ctx, scale)
        return tensor, (ctx, None)

    @staticmethod
    def decompress(tensor, ctx):
        dtype, scale = ctx
        if scale is None:
            return tensor
        return cuda_kernels.int8_dequantize(tensor, scale, out_dtype=dtype)


class Int8BlockCompressor(Int8Compressor):
    """Block-scaled int8: one fp32 scale per ``block_size`` elements, so
    regions of different magnitude never share a dynamic range, on
    kernel B3. The fused int8 wire uses this granularity for an
    allreduce handed this compressor."""

    block_size = 512

    @classmethod
    def with_block_size(cls, block_size: int) -> type:
        """A variant of this compressor with another scale granularity;
        a full Compressor, routed like this one."""
        block_size = int(block_size)
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        return type(f"{cls.__name__}_b{block_size}", (cls,),
                    {"block_size": block_size})

    @classmethod
    def compress(cls, tensor, seed=0):
        ctx = tensor.dtype
        if tensor.is_floating_point():
            values, scales = cuda_kernels.int8_block_quantize(
                tensor, block_size=cls.block_size, seed=seed
            )
            return values, (ctx, scales)
        return tensor, (ctx, None)

    @classmethod
    def decompress(cls, tensor, ctx):
        dtype, scales = ctx
        if scales is None:
            return tensor
        return cuda_kernels.int8_block_dequantize(
            tensor, scales, block_size=cls.block_size, out_dtype=dtype
        )


class HierarchicalInt8Compressor(Int8BlockCompressor):
    """bf16 on the intra-node hops, block-scaled int8 on the inter-node
    hop only (EQuARX's placement): the fused wire's two-level route
    (``ops/fusion.py``) whenever a split resolves, the flat int8 wire
    otherwise. ``compress``/``decompress`` are ``int8_block``'s."""

    wire_format = "int8_hier"


class Compression:
    """``hvd.Compression`` namespace."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
    int8_block = Int8BlockCompressor
    hier_int8 = HierarchicalInt8Compressor
