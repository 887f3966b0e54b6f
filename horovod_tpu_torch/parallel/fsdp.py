"""Parameter-shard layout: the one source of how a parameter maps onto
per-rank shards.

The counterpart of the flat ZeRO layout of ``horovod_tpu/parallel/
fsdp.py`` (``:44-121``): every tensor that is not 0-d is flattened,
zero-padded to a multiple of the world size and split rank-major into
``[world, cols]`` rows, ``cols = ceil(size / world)``; a 0-d tensor is
replicated. ``ShardedDistributedOptimizer`` keeps its optimizer state
(ZeRO-1), gradient shards (ZeRO-2) and parameter storage (ZeRO-3) in
this layout, the bucketed reduce-scatter and all-gather legs of
``ops/overlap.py`` concatenate member panes column by column, and
``reshard_rows`` re-splits a tensor's rows for a new world. The
geometry is integers only, so it agrees with the JAX functions exactly.

Padding elements are zeros by contract: they quantize to zeros, never
raise an int8 block's absmax, and carry a zero error-feedback residual.

The JAX module's ``fsdp_spec``/``fsdp_sharding``/``fsdp_shard`` build
``NamedSharding`` trees for GSPMD; their torch analog comes with the
device mesh of ROADMAP A14.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def shard_cols(size: int, world: int) -> int:
    """Per-rank shard length of a flattened tensor of ``size`` elements:
    ``ceil(size / world)``."""
    return -(-int(size) // int(world))


def pad_to(flat: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad a 1-D tensor to a multiple of ``n``."""
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat


def host_shard(x: torch.Tensor, n: int, r: int) -> torch.Tensor:
    """Shard ``r`` of ``n`` of tensor ``x``; a 0-d tensor is replicated."""
    if x.dim() == 0:
        return x
    return host_shard_rows(x, n)[r]


def host_shard_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """All ``n`` shards of ``x`` stacked rank-major, ``[n, cols]`` (a 0-d
    tensor broadcast to ``[n]``)."""
    if x.dim() == 0:
        return x.expand(n)
    return pad_to(x.reshape(-1), n).view(n, shard_cols(x.numel(), n))


def dyn_shard(x: torch.Tensor, n: int, idx: int) -> torch.Tensor:
    """This rank's shard of ``x`` (the JAX function's traced
    ``dynamic_index_in_dim`` is a plain index here)."""
    return host_shard_rows(x.reshape(-1), n)[int(idx)]


def host_unshard(rows: torch.Tensor, shape: Sequence[int],
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Invert :func:`host_shard_rows`: ``[n, cols]`` rows → the tensor of
    ``shape`` (the zero-pad tail dropped)."""
    shape = tuple(shape)
    if not shape:
        out = rows.reshape(-1)[0]
    else:
        out = rows.reshape(-1)[:math.prod(shape)].view(shape)
    return out.to(dtype) if dtype is not None else out


def reshard_rows(rows, size: int, new_world: int,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Re-split one tensor's shard rows at a new world size, every value
    bit for bit: concatenate the old shards, then pad with zeros or drop
    only zero-pad tail for the new split. ``size`` is the unpadded
    element count; entries past it are padding."""
    rows = torch.as_tensor(rows)
    per = shard_cols(size, new_world)
    flat = rows.reshape(-1)
    need = new_world * per
    if flat.numel() < need:
        flat = torch.nn.functional.pad(flat, (0, need - flat.numel()))
    else:
        flat = flat[:need]
    out = flat.reshape(new_world, per)
    return out.to(dtype) if dtype is not None else out
