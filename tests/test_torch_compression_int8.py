"""The port's int8 compressors (``horovod_tpu_torch/ops/compression.py``)
against the JAX package's ``Compression.int8`` and ``int8_block`` on the
same inputs, made from one numpy seed. Their rounding bits differ
(Philox against ``jax.random``), so they agree by contract: the scales
bitwise, and each round trip within one quantum (its scale) of the
input. Also the flags the allreduce and optimizer route by
(``quantized_wire``, ``wire_format``), ``with_block_size``, and integer
tensors passing through untouched."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.compression import Compression as JaxCompression
from horovod_tpu_torch import Compression


def _x(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x.reshape(-1)[::7] *= 1e-3
    return x


@pytest.mark.parametrize("name", ["int8", "int8_block"])
@pytest.mark.parametrize("shape", [(1,), (33, 17), (4, 1000)])
def test_round_trip_within_one_quantum(name, shape):
    x = _x(shape)
    comp, jcomp = getattr(Compression, name), getattr(JaxCompression, name)
    vals, ctx = comp.compress(torch.from_numpy(x), seed=5)
    back = comp.decompress(vals, ctx)
    jvals, jctx = jcomp.compress(jnp.asarray(x), seed=5)
    jback = np.asarray(jcomp.decompress(jvals, jctx))
    assert vals.dtype == torch.int8 and vals.shape == shape
    assert back.dtype == torch.float32 and back.shape == shape
    dtype, scale = ctx
    assert dtype == torch.float32
    assert np.array_equal(scale.numpy(), np.asarray(jctx[1]))
    if name == "int8":
        quantum = np.full(x.size, float(scale))
    else:
        quantum = np.repeat(scale.numpy(), comp.block_size)[:x.size]
    for got in (back.numpy(), jback):
        assert np.all(np.abs(got - x).reshape(-1) <= quantum * 1.0001)


@pytest.mark.parametrize("name", ["int8", "int8_block"])
def test_bf16_round_trip_keeps_dtype(name):
    x = torch.from_numpy(_x((64,))).to(torch.bfloat16)
    comp = getattr(Compression, name)
    vals, ctx = comp.compress(x)
    back = comp.decompress(vals, ctx)
    assert back.dtype == torch.bfloat16
    assert float((back.float() - x.float()).abs().max()) <= float(
        ctx[1].max()) * 1.01 + 2 ** -8 * float(x.float().abs().max())


@pytest.mark.parametrize("name", ["int8", "int8_block"])
def test_integers_pass_through(name):
    x = torch.arange(-5, 5, dtype=torch.int32)
    comp, jcomp = getattr(Compression, name), getattr(JaxCompression, name)
    vals, ctx = comp.compress(x)
    assert vals is x and ctx == (torch.int32, None)
    assert comp.decompress(vals, ctx) is x
    jx = jnp.arange(-5, 5, dtype=jnp.int32)
    jvals, jctx = jcomp.compress(jx)
    assert jctx[1] is None and np.array_equal(np.asarray(jvals), x.numpy())


@pytest.mark.parametrize("name", ["none", "fp16", "bf16", "int8",
                                  "int8_block"])
def test_wire_flags_match_jax(name):
    comp, jcomp = getattr(Compression, name), getattr(JaxCompression, name)
    assert comp.wire_format == jcomp.wire_format
    assert bool(getattr(comp, "quantized_wire", False)) == bool(
        getattr(jcomp, "quantized_wire", False))
    if name == "int8_block":
        assert comp.block_size == jcomp.block_size == 512


def test_with_block_size():
    for bad in (0, -3):
        with pytest.raises(ValueError, match="block_size"):
            Compression.int8_block.with_block_size(bad)
        with pytest.raises(ValueError, match="block_size"):
            JaxCompression.int8_block.with_block_size(bad)
    comp = Compression.int8_block.with_block_size(100)
    jcomp = JaxCompression.int8_block.with_block_size(100)
    assert comp.block_size == 100 and comp.quantized_wire
    assert issubclass(comp, Compression.int8_block)
    x = _x((1000,))
    vals, (_, scales) = comp.compress(torch.from_numpy(x))
    _, (_, jscales) = jcomp.compress(jnp.asarray(x))
    assert scales.shape == (10,)
    assert np.array_equal(scales.numpy(), np.asarray(jscales))
    back = comp.decompress(vals, (torch.float32, scales))
    assert np.all(np.abs(back.numpy() - x)
                  <= np.repeat(scales.numpy(), 100) * 1.0001)


def test_hier_int8_raises():
    """``Compression.hier_int8`` no longer raises: it is ``int8_block``
    with the two-level placement (its wire runs in
    tests/test_torch_hier_route.py), so its codec is int8_block's, bit
    for bit, and it names the JAX compressor's wire format."""
    comp = Compression.hier_int8
    assert comp.wire_format == JaxCompression.hier_int8.wire_format
    assert comp.quantized_wire and comp.block_size == 512
    assert issubclass(comp, Compression.int8_block)
    x = torch.from_numpy(_x((1500,)))
    vals, ctx = comp.compress(x, seed=3)
    want_vals, want_ctx = Compression.int8_block.compress(x, seed=3)
    assert torch.equal(vals, want_vals) and torch.equal(ctx[1], want_ctx[1])
    assert torch.equal(comp.decompress(vals, ctx),
                       Compression.int8_block.decompress(vals, ctx))
