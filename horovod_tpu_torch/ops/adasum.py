"""Adasum: scale-invariant gradient combination, on ``torch.distributed``.

The counterpart of ``horovod_tpu/ops/adasum.py`` (the reference's
``horovod/common/ops/adasum/adasum.h``). Two gradients combine as

    adasum(a, b) = (1 − a·b / (2‖a‖²)) · a + (1 − a·b / (2‖b‖²)) · b

which removes each vector's projection onto the other before summing:
orthogonal gradients add, parallel ones average, and the result does not
change when either input is rescaled.

- :func:`adasum_pair` runs kernel B4 on the card (the dots pass, then
  the apply pass, ``ops/cuda_kernels.py``); CPU tensors take the plain
  versions. :func:`_tree_combine` pairs a stack in a fixed order, odd
  counts carried up a level.
- :func:`adasum_allreduce` over the whole world is vector-halving
  distance-doubling (VHDD, :func:`_vhdd_allreduce`), in fp32 with the
  input dtype restored at the end. A process set gathers its members'
  tensors and runs the tree; non-members get their input back. A world
  of one returns the input.
- :func:`vhdd_wire_bytes` and the host oracles
  (:func:`adasum_pair_host`, :func:`adasum_vhdd_host`,
  :func:`adasum_tree_host`) are numpy copies of the JAX package's.

The hierarchical variant and the int8/bf16 VHDD wires belong to the
hierarchical route (ROADMAP A3/A5): ``hierarchical=True`` raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import cuda_kernels
from ._collectives import gather_into


def adasum_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Adasum combine of two same-shaped tensors in a's dtype (fp32
    accumulation): kernel B4 for CUDA tensors, its plain version for
    CPU ones."""
    return cuda_kernels.adasum_pair(a, b)


def _pair_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The combine on fp32 operands in plain PyTorch: the oracle the
    kernels are held against."""
    return cuda_kernels.adasum_pair_plain(a.to(torch.float32),
                                          b.to(torch.float32))


def _tree_combine(stack: Sequence[torch.Tensor]) -> torch.Tensor:
    """Pairwise-tree Adasum over a sequence: adjacent pairs at each
    level, an odd last element carried up, the same order on every
    rank."""
    vals = list(stack)
    while len(vals) > 1:
        nxt = [adasum_pair(vals[i], vals[i + 1])
               for i in range(0, len(vals) - 1, 2)]
        if len(vals) % 2:
            nxt.append(vals[-1])
        vals = nxt
    return vals[0]


def _exchange(send: Optional[torch.Tensor], recv: Optional[torch.Tensor],
              peer: int) -> None:
    """Send ``send`` to and/or receive ``recv`` from ``peer`` as one
    batched point-to-point call."""
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send, peer))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv, peer))
    for work in dist.batch_isend_irecv(ops):
        work.wait()


def adasum_allreduce(tensor: torch.Tensor, process_set=None,
                     hierarchical: bool = False) -> torch.Tensor:
    """Adasum across the world (VHDD) or across ``process_set`` (an
    allgather over the set, then the tree). Every rank of the world, or
    of the set, calls it with a tensor of the same shape and dtype."""
    if hierarchical:
        raise NotImplementedError(
            "hierarchical Adasum needs the hierarchical route, not ported "
            "yet (ROADMAP A3/A5)"
        )
    n, r = dist.get_world_size(), dist.get_rank()
    if process_set is not None and process_set.process_set_id != 0 and (
        process_set.size != n
    ):
        if not process_set.included(r):
            return tensor
        x = tensor.contiguous()
        gathered = torch.empty((process_set.size,) + tuple(x.shape),
                               dtype=x.dtype, device=x.device)
        gather_into(gathered, x, group=process_set.group)
        return _tree_combine(list(gathered.unbind(0)))
    if n == 1:
        return tensor
    return _vhdd_allreduce(tensor, n, r)


def _block_rows(n: int, p: int, d: int) -> np.ndarray:
    """The 0/1 matrix whose row r selects the ranks of r's 2d-block
    (blocks of 2d among the first p ranks; each rank past p alone)."""
    bmat = np.zeros((n, n), np.float32)
    for g in range(p // (2 * d)):
        bmat[g * 2 * d:(g + 1) * 2 * d, g * 2 * d:(g + 1) * 2 * d] = 1.0
    for i in range(p, n):
        bmat[i, i] = 1.0
    return bmat


_SWAP = [0, 2, 1]  # [dot, ‖a‖², ‖b‖²] <-> [dot, ‖b‖², ‖a‖²]


def _vhdd_allreduce(tensor: torch.Tensor, n: int, r: int) -> torch.Tensor:
    """Vector-halving distance-doubling Adasum over the world (the
    reference's adasum.h FusedAllreduce; ``_vhdd_allreduce`` of the JAX
    package, its fp32 wire).

    Ranks ``[p, n)`` past the largest power of two ``p`` first fold
    their vector into rank ``r − p`` and sit out. Stage k pairs rank r
    with ``r ^ 2^k``: the pair swap halves of their current piece, each
    keeps one half and receives the partner's matching half. The three
    dots of the kept and received halves (kernel B4's dots pass) are in
    the a/b roles of the pair (a = the bit-clear side's vector); they
    are completed over the 2^(k+1)-rank block that jointly holds both
    vectors by an allgather of every rank's ``[3]`` and a fixed 0/1 row
    of block membership, on the device, with no host sync and no new
    process group. B4's apply pass combines the halves. A
    distance-halving exchange reassembles the vector, and ranks past p
    get it back from their partner."""
    p = 1 << (n.bit_length() - 1)
    excess = n - p
    shape, dtype, dev = tensor.shape, tensor.dtype, tensor.device
    x = tensor.detach().to(torch.float32).reshape(-1)
    payload = x.numel()
    pad = (-payload) % p  # every halving stage splits evenly
    x = torch.cat([x, x.new_zeros(pad)]) if pad else x.clone()

    if excess:
        if r >= p:
            _exchange(x, None, r - p)
        elif r < excess:
            recv = torch.empty_like(x)
            _exchange(None, recv, r + p)
            x = cuda_kernels.adasum_pair(x, recv)

    stages = p.bit_length() - 1
    piece = x
    for k in range(stages):
        d = 1 << k
        gathered = torch.empty((n, 3), dtype=torch.float32, device=dev)
        if r >= p:  # sitting out: a singleton block of zeros
            gather_into(gathered, torch.zeros(3, device=dev))
            continue
        h = piece.numel() // 2
        bit = bool(r & d)
        keep, send = (piece[h:], piece[:h]) if bit else (piece[:h],
                                                         piece[h:])
        recv = torch.empty_like(keep)
        _exchange(send, recv, r ^ d)
        local = cuda_kernels.adasum_dots(keep, recv)
        gather_into(gathered, local[_SWAP] if bit else local)
        row = torch.from_numpy(_block_rows(n, p, d)[r]).to(dev)
        tot = row @ gathered  # [a·b, ‖a‖², ‖b‖²] over the block
        piece = cuda_kernels.adasum_apply(keep, recv,
                                          tot[_SWAP] if bit else tot)

    if r < p:
        for k in reversed(range(stages)):
            d = 1 << k
            recv = torch.empty_like(piece)
            _exchange(piece, recv, r ^ d)
            piece = torch.cat([recv, piece] if r & d else [piece, recv])

    if excess:
        if r < excess:
            _exchange(piece, None, r + p)
        elif r >= p:
            piece = torch.empty_like(x)
            _exchange(None, piece, r - p)
    return piece[:payload].reshape(shape).to(dtype)


def vhdd_wire_bytes(n: int, payload_bytes: int) -> int:
    """Modeled per-rank wire bytes of one VHDD Adasum (both sweeps and
    the non-power-of-two pre/post hops), as the JAX package models it."""
    p = 1 << (n.bit_length() - 1)
    halving = sum(payload_bytes >> (k + 1) for k in range(p.bit_length() - 1))
    pre_post = 2 * payload_bytes if n != p else 0
    return 2 * halving + pre_post


# ---- host oracles (numpy, fp64 accumulation), copies of the JAX
# package's: the numerics the distributed paths are held against


def adasum_pair_host(a, b):
    """Adasum combine of two host arrays (numpy in, numpy out, a's
    dtype)."""
    af = np.asarray(a, dtype=np.float64)
    bf = np.asarray(b, dtype=np.float64)
    dot = float((af * bf).sum())
    asq = float((af * af).sum())
    bsq = float((bf * bf).sum())
    acoef = 1.0 - (dot / (2.0 * asq) if asq > 0 else 0.0)
    bcoef = 1.0 - (dot / (2.0 * bsq) if bsq > 0 else 0.0)
    return (acoef * af + bcoef * bf).astype(np.asarray(a).dtype)


def adasum_vhdd_host(stack):
    """The VHDD combination order on the host: ranks p+i pre-reduce into
    i, then an adjacent-pair binary tree over the power of two."""
    vals = [np.asarray(stack[i]) for i in range(len(stack))]
    n = len(vals)
    p = 1 << (n.bit_length() - 1)
    for i in range(n - p):
        vals[i] = adasum_pair_host(vals[i], vals[p + i])
    vals = vals[:p]
    while len(vals) > 1:
        vals = [adasum_pair_host(vals[i], vals[i + 1])
                for i in range(0, len(vals), 2)]
    return vals[0]


def adasum_tree_host(stack):
    """Pairwise-tree Adasum over ``stack[k, ...]``, the order of
    :func:`_tree_combine`."""
    stack = np.asarray(stack)
    vals = [stack[i] for i in range(stack.shape[0])]
    while len(vals) > 1:
        nxt = [adasum_pair_host(vals[i], vals[i + 1])
               for i in range(0, len(vals) - 1, 2)]
        if len(vals) % 2 == 1:
            nxt.append(vals[-1])
        vals = nxt
    return vals[0]
