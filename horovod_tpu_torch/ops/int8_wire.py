"""The two-stage int8 allreduce recipe, written once.

Every int8 allreduce of the port runs it: the fusion manager's flat wire
(``fusion.py:_allreduce_q``) and its two-level inter hop
(``_quantized_sum``), and the in-step collectives
(``traced.quantized_allreduce`` and ``traced._quantized_sum_groups``).
The JAX package writes it twice (``fusion.py:_core_allreduce_q`` and
``traced.py:quantized_allreduce``, whose docstring asks that a residual
change "land in both"); here a change lands once.

The input is ``chunks``, ``[n, chunk]`` fp32, row j bound for rank j of
the group. :func:`quantized_sum`:

1. quantizes each row to int8 with stochastic rounding: one scale a
   ``block`` elements (kernel B3), or, with ``block=None`` (the per-row
   wire of ``Compression.int8``), one scale a row (kernel B2 a row); the
   prescale is folded into the scales that travel, never multiplied
   through the values (quantization is scale-invariant);
2. exchanges values and scales (the scatter half of a reduce-scatter):
   row r of what comes back is what rank r quantized for this rank;
3. dequantizes and sums the received rows in fp32: this rank's shard,
   divided by ``divisor`` for Average;
4. quantizes the shard again (B3 blocks, or B2 one scale);
5. gathers every rank's quantized shard, values and scales.

:func:`unpack` dequantizes the gather into the reduced tensor, and
:func:`residual` gives the error-feedback carry: the stage-1 error of
every row against the unscaled scales, plus on the row this rank owns
the stage-2 error, times ``e2_mul`` then divided by ``e2_div`` (the
caller's Average count and prescale, which bring it back to input
units).

The collectives are the caller's: ``exchange(q, scales)`` returns the
received pair and ``gather(q2, s2)`` the gathered pair, which may still
be in flight (the fusion manager waits on its work before
:func:`unpack`). So are the kernels: :data:`EAGER` calls the wrappers of
``cuda_kernels``, :data:`COMPILABLE` their custom operators, which
``torch.compile`` can trace. The wire's device time splits by
``WIRE_RANGES`` in a profile (ignored inside a compiled region).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from . import cuda_kernels

# profiler ranges of the int8 wire's plain-PyTorch passes and exchanges
WIRE_RANGES = {k: f"hvd.int8_wire.{k}" for k in (
    "pack", "exchange", "dequantize_sum", "residual", "unpack")}


class Kernels(NamedTuple):
    """The quantizers a recipe runs: ``block(x2d, block, seed, stream)``
    gives int8 values and ``[rows, nb]`` scales; ``tensor(x, seed,
    stream)`` int8 values and one 0-dim scale."""

    block: Callable
    tensor: Callable


EAGER = Kernels(
    lambda x, block, seed, stream: cuda_kernels.int8_block_quantize(
        x, block, seed=seed, stream=stream, rows=True),
    lambda x, seed, stream: cuda_kernels.int8_quantize(
        x, seed=seed, stream=stream),
)
COMPILABLE = Kernels(
    lambda x, block, seed, stream: cuda_kernels.OPS.int8_block_quantize(
        x, block, seed, stream, True),
    lambda x, seed, stream: cuda_kernels.OPS.int8_quantize(x, seed, stream),
)

# the per-row wire's rows take streams ``stream + (row << ROW_SHIFT)``
ROW_SHIFT = 20


class Stages(NamedTuple):
    """What :func:`quantized_sum` made: stage 1's values and scales, the
    summed shard, stage 2's values and scales ``[1, chunk]``/``[1, nb]``,
    and the gathered ``[n, chunk]``/``[n, nb]``."""

    q: torch.Tensor
    scales: torch.Tensor
    shard: torch.Tensor
    q2: torch.Tensor
    s2: torch.Tensor
    all_q: torch.Tensor
    all_s: torch.Tensor


def dequantize(q: torch.Tensor, scales: torch.Tensor,
               block: Optional[int]) -> torch.Tensor:
    """``[rows, cols]`` int8 times its scales, in fp32: ``[rows, nb]``
    block scales, or one a row (``block=None``, scales ``[rows, 1]``)."""
    if block is None:
        return q.to(torch.float32) * scales
    return cuda_kernels.int8_block_dequantize(q, scales, block)


def _quantize(x2d, block, seed, stream, kernels):
    if block is not None:
        return kernels.block(x2d, block, seed, stream)
    pairs = [kernels.tensor(row, seed, stream + (j << ROW_SHIFT))
             for j, row in enumerate(x2d.unbind(0))]
    return (torch.stack([q for q, _ in pairs]),
            torch.stack([s for _, s in pairs]).reshape(-1, 1))


def quantized_sum(chunks: torch.Tensor, block: Optional[int], seed: int,
                  streams: Tuple[int, int], exchange: Callable,
                  gather: Callable, kernels: Kernels = EAGER, *,
                  prescale: float = 1.0,
                  divisor: Optional[float] = None) -> Stages:
    """Steps 1-5 of the module's recipe on ``chunks``; ``streams`` key
    the two stages' rounding (with ``seed``)."""
    q, scales = _quantize(chunks, block, seed, streams[0], kernels)
    wire_scales = scales * prescale if prescale != 1.0 else scales
    with record_function(WIRE_RANGES["exchange"]):
        recv_q, recv_s = exchange(q, wire_scales)
    with record_function(WIRE_RANGES["dequantize_sum"]):
        shard = dequantize(recv_q, recv_s, block).sum(0)
        if divisor is not None:
            shard = shard / divisor
    q2, s2 = _quantize(shard[None], block, seed, streams[1], kernels)
    with record_function(WIRE_RANGES["exchange"]):
        all_q, all_s = gather(q2[0], s2[0])
    return Stages(q, scales, shard, q2, s2, all_q, all_s)


def unpack(all_q: torch.Tensor, all_s: torch.Tensor, block: Optional[int],
           m: int) -> torch.Tensor:
    """The reduced flat tensor (fp32, ``m`` elements) from the gather."""
    with record_function(WIRE_RANGES["unpack"]):
        return dequantize(all_q, all_s, block).reshape(-1)[:m]


def residual(chunks: torch.Tensor, st: Stages, block: Optional[int],
             pos: int, m: int, e2_mul: Optional[float] = None,
             e2_div: Optional[float] = None) -> torch.Tensor:
    """The error-feedback carry of :func:`quantized_sum`, flat fp32 of
    ``m`` elements: both stages' errors, the second on row ``pos`` (the
    shard this rank owns) times ``e2_mul``, divided by ``e2_div``."""
    with record_function(WIRE_RANGES["residual"]):
        res = chunks - dequantize(st.q, st.scales, block)
        e2 = st.shard - dequantize(st.q2, st.s2, block)[0]
        if e2_mul is not None:
            e2 = e2 * e2_mul
        if e2_div is not None:
            e2 = e2 / e2_div
        res[pos] += e2
        return res.reshape(-1)[:m]
