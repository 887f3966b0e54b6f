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
- ``hierarchical=True`` is the reference's hierarchical Adasum (Sum
  within the node, Adasum across nodes; ``horovod_tpu/ops/adasum.py``
  ``_hier_adasum``) on the groups ``hvd.init()`` built: an intra
  reduce-scatter leaves each rank 1/L of its node's sum, VHDD runs over
  the inter group on those shards with every combine's three dots
  completed by an allreduce over the intra group (so the coefficients
  are the full vectors'), and an intra allgather reassembles the
  result. ``inter_wire`` (fp32, bf16 or int8) carries the VHDD's
  half-exchanges of both sweeps; int8 quantizes them on kernel B3, and
  a rank consumes its own dequantized piece wherever a peer consumes
  the received one, so every replica stays bitwise equal. Process sets
  raise, as in the reference.
- :func:`adasum_allreduce_groups` and :func:`adasum_sync_shard` are
  local SGD's merge (``horovod_tpu/ops/adasum.py:373,474``): the value
  is each slice's parameter delta, replicated within the slice (or, for
  the shard form, this rank's intra-position chunk of it). Each rank
  takes its chunk with no collective; on the int8 wire with error
  feedback the chunk plus its carried residual is pre-quantized on B3
  (keyed by the intra position for the replicated form, so a slice's
  replicas quantize alike) and the carry becomes what the wire could
  not send; VHDD runs over this rank's inter group with every combine's
  dots completed over its intra group, as ``_hier_adasum`` does; an
  intra allgather reassembles the merged value and the residual. Both
  take ``stages``, the ``(intra, inter)`` rank lists, and make their
  process groups through ``traced.prepare_groups``'s cache.
- :func:`vhdd_wire_bytes` and the host oracles
  (:func:`adasum_pair_host`, :func:`adasum_vhdd_host`,
  :func:`adasum_tree_host`) are numpy copies of the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..common import basics
from . import cuda_kernels, traced
from ._collectives import exchange, gather_into, scatter_reduce_into

# the stream tag of the error-feedback pre-quantization's rounding (the
# VHDD's half-exchanges take 100 + k and 200 + k)
_PREQUANT = 300


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


def adasum_allreduce(tensor: torch.Tensor, process_set=None,
                     hierarchical: bool = False, inter_wire: str = "fp32",
                     seed: int = 0) -> torch.Tensor:
    """Adasum across the world (VHDD) or across ``process_set`` (an
    allgather over the set, then the tree); with ``hierarchical=True``,
    Sum within each node and VHDD Adasum across nodes, ``inter_wire``
    on the inter hop and ``seed`` keying its int8 rounding. Every rank
    of the world, or of the set, calls it with a tensor of the same
    shape and dtype."""
    if hierarchical:
        if process_set is not None:
            raise NotImplementedError(
                "hierarchical Adasum composes with the whole two-level "
                "world only, not with a process set"
            )
        return _hier_adasum(tensor, inter_wire, seed)
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


def _hier_adasum(tensor: torch.Tensor, inter_wire: str,
                 seed: int) -> torch.Tensor:
    """Intra Sum by reduce-scatter, VHDD Adasum across the inter group
    on the 1/L shards (dots completed over the intra group), intra
    allgather; L ranks a node as the topology gives them."""
    if inter_wire not in ("fp32", "bf16", "int8"):
        raise ValueError(f"unknown inter_wire {inter_wire!r}")
    st = basics._require_init()
    topo = st.topology
    if topo.size == 1:
        return tensor
    L, H = topo.local_size, topo.cross_size
    shape, dtype = tensor.shape, tensor.dtype
    x = tensor.detach().to(torch.float32).reshape(-1)
    m = x.numel()
    x = torch.nn.functional.pad(x, (0, (-m) % L))
    shard = x
    if L > 1:
        shard = x.new_empty(x.numel() // L)
        scatter_reduce_into(shard, x, st.intra_group)
    if H > 1:
        shard = _vhdd_allreduce(
            shard, H, topo.cross_rank, group=st.inter_group,
            ranks=[h * L + topo.local_rank for h in range(H)],
            dot_group=st.intra_group if L > 1 else None, wire=inter_wire,
            seed=seed, lane=topo.local_rank)
    out = shard
    if L > 1:
        out = shard.new_empty(shard.numel() * L)
        gather_into(out, shard, st.intra_group)
    return out[:m].reshape(shape).to(dtype)


def _check_sync(stages, inter_wire: str, return_residual: bool) -> None:
    if stages is None:
        raise ValueError("stages is required (topology.hierarchy_stages)")
    if inter_wire not in ("fp32", "bf16", "int8"):
        raise ValueError(f"unknown inter_wire {inter_wire!r}")
    if return_residual and inter_wire != "int8":
        raise ValueError(
            "return_residual needs inter_wire='int8' (exact wires "
            "transmit everything; there is no residual to carry)")


def _intra_gather(piece: torch.Tensor, group, L: int) -> torch.Tensor:
    out = piece.new_empty(piece.numel() * L)
    gather_into(out, piece.contiguous(), group)
    return out


def adasum_allreduce_groups(tensor: torch.Tensor, stages,
                            inter_wire: str = "fp32", seed: int = 0,
                            residual: Optional[torch.Tensor] = None,
                            return_residual: bool = False):
    """Hierarchical Adasum of the slices' values on the two-level split
    ``stages`` (rank ``h·L + i`` is slice h, intra position i): every
    rank passes its slice's value, the same on the slice's L ranks (the
    local phase keeps it so). Each rank takes its intra-position chunk,
    the H slice values combine by VHDD over the inter groups with the
    dots completed over the intra groups, and an intra allgather
    reassembles the result, the same bits on every rank of the world.

    With ``inter_wire="int8"`` and ``return_residual=True`` the carry
    ``residual`` joins the chunk before B3's pre-quantization, and the
    new residual (``x_eff − dequant(quant(x_eff))``, allgathered over the
    intra group, so a slice's ranks hold the same carry) comes back
    beside the result."""
    _check_sync(stages, inter_wire, return_residual)
    shape, dtype = tensor.shape, tensor.dtype
    flat = tensor.detach().reshape(-1)
    res = None if residual is None else residual.detach().reshape(-1)
    merged, new_res = merge_groups(
        lambda lo, hi, out: out.copy_(flat[lo:hi]), flat.numel(),
        flat.device, stages, inter_wire, seed,
        None if res is None else lambda lo, hi, out: out.copy_(res[lo:hi]),
        return_residual)
    out = merged.reshape(shape).to(dtype)
    return (out, new_res.reshape(shape).to(dtype)) if return_residual \
        else out


def merge_groups(fill, m: int, device, stages, inter_wire: str, seed: int,
                 fill_residual=None, return_residual: bool = False):
    """:func:`adasum_allreduce_groups` on a vector of ``m`` elements that
    need not exist whole: ``fill(lo, hi, out)`` writes elements ``[lo,
    hi)`` into the fp32 tensor ``out``, and only this rank's chunk is
    asked for (``local_sgd.sync_tree`` builds the deltas of a model that
    way, chunk-sized). Returns the merged fp32 vector and, with
    ``return_residual``, the new fp32 residual."""
    _check_sync(stages, inter_wire, return_residual)
    intra, inter = stages
    group, pos, L = traced._mine(intra)
    H = len(inter[0])
    p = 1 << (H.bit_length() - 1)
    # every rank's chunk splits at every halving; its tail past m is 0
    chunk = (m + (-m) % (L * p)) // L
    lo, hi = min(pos * chunk, m), min((pos + 1) * chunk, m)

    def take(f):
        buf = torch.zeros(chunk, dtype=torch.float32, device=device)
        if hi > lo:
            f(lo, hi, buf[:hi - lo])
        return buf

    piece = take(fill)
    r_piece = None if fill_residual is None else take(fill_residual)
    # the intra position keys the pre-quantization: a slice's replicas
    # hold the same chunk and must quantize it alike
    out = adasum_sync_shard(piece, stages, inter_wire, seed, r_piece,
                            return_residual, key_index=pos)
    del piece, r_piece
    new_res = None
    if return_residual:
        out, res_piece = out
        new_res = _intra_gather(res_piece, group, L)[:m]
        del res_piece
    return _intra_gather(out, group, L)[:m], new_res


def adasum_sync_shard(shard: torch.Tensor, stages, inter_wire: str = "int8",
                      seed: int = 0, residual: Optional[torch.Tensor] = None,
                      return_residual: bool = False,
                      key_index: Optional[int] = None):
    """Merge one intra-position chunk across slices: ``shard`` is this
    rank's ``[cols]`` chunk of its slice's value, which the slice's L
    ranks hold jointly; the merged chunk comes back in the same
    geometry (and with ``return_residual`` the new carry beside it).
    ``key_index`` keys the pre-quantization's rounding (default: the
    global rank)."""
    _check_sync(stages, inter_wire, return_residual)
    intra, inter = stages
    intra_group, pos, L = traced._mine(intra)
    inter_group, h, H = traced._mine(inter)
    me = dist.get_rank()
    c = shard.numel()
    x = shard.detach().to(torch.float32).reshape(-1)
    new_res = None
    if inter_wire == "int8" and (residual is not None or return_residual):
        if residual is not None:
            x = x + residual.detach().to(torch.float32).reshape(-1)
        key = me if key_index is None else int(key_index)
        block = min(512, max(c, 1))
        q, s = cuda_kernels.int8_block_quantize(
            x, block, seed=seed, stream=(_PREQUANT << 20) | key)
        q_x = cuda_kernels.int8_block_dequantize(q, s, block)
        del q, s
        if return_residual:
            new_res = (x - q_x).to(shard.dtype)
        x = q_x
    if H > 1:
        x = _vhdd_allreduce(
            x, H, h, group=inter_group,
            ranks=next(g for g in inter if me in g),
            dot_group=intra_group if L > 1 else None, wire=inter_wire,
            seed=seed, lane=pos)
    out = x.to(shard.dtype).reshape(shard.shape)
    if not return_residual:
        return out
    return out, (torch.zeros_like(shard) if new_res is None
                 else new_res.reshape(shard.shape))


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


def _wire_exchange(send: Optional[torch.Tensor], peer: Optional[int],
                   group, wire: str, seed: int = 0, stream: int = 0,
                   like: Optional[torch.Tensor] = None):
    """One VHDD half-exchange at ``wire``: returns ``(recv, self_wire)``,
    ``self_wire`` being what the peer reconstructs from ``send``, which
    an owner that keeps the piece must consume instead of ``send`` so a
    lossy wire cannot fork the replicas. A rank with no partner this
    round passes ``send=None`` and takes part in the exchange idle."""
    if send is None:
        empty = like.new_empty(0)
        for dtype in {"int8": (torch.int8, torch.float32),
                      "bf16": (torch.bfloat16,)}.get(wire, (torch.float32,)):
            exchange(None, None, None, group, like=empty.to(dtype))
        return None, None
    if wire == "int8":
        block = min(512, max(send.numel(), 1))
        q, s = cuda_kernels.int8_block_quantize(send, block, seed=seed,
                                                stream=stream)
        rq, rs = torch.empty_like(q), torch.empty_like(s)
        exchange(q, rq, peer, group)
        exchange(s, rs, peer, group)
        return (cuda_kernels.int8_block_dequantize(rq, rs, block),
                cuda_kernels.int8_block_dequantize(q, s, block))
    w = send.to(torch.bfloat16) if wire == "bf16" else send
    recv = torch.empty_like(w)
    exchange(w, recv, peer, group)
    return recv.to(torch.float32), w.to(torch.float32)


def _combine(a: torch.Tensor, b: torch.Tensor, dot_group) -> torch.Tensor:
    """The Adasum combine of ``a`` and ``b`` on kernel B4, the dots
    completed over ``dot_group`` when the vectors are shards of it."""
    dots = cuda_kernels.adasum_dots(a, b)
    if dot_group is not None:
        dist.all_reduce(dots, group=dot_group)
    return cuda_kernels.adasum_apply(a, b, dots)


def _vhdd_allreduce(tensor: torch.Tensor, n: int, r: int, group=None,
                    ranks: Optional[Sequence[int]] = None, dot_group=None,
                    wire: str = "fp32", seed: int = 0,
                    lane: int = 0) -> torch.Tensor:
    """Vector-halving distance-doubling Adasum over ``group`` (the
    world by default) of ``n`` ranks, this one at position ``r``,
    ``ranks`` the members' global ranks (the reference's adasum.h
    FusedAllreduce; ``_vhdd_allreduce`` of the JAX package).

    Ranks ``[p, n)`` past the largest power of two ``p`` first fold
    their vector into rank ``r − p`` and sit out. Stage k pairs rank r
    with ``r ^ 2^k``: the pair swap halves of their current piece, each
    keeps one half and receives the partner's matching half. The three
    dots of the kept and received halves (kernel B4's dots pass) are in
    the a/b roles of the pair (a = the bit-clear side's vector); they
    are completed over the 2^(k+1)-rank block that jointly holds both
    vectors by an allgather of every rank's ``[3]`` and a fixed 0/1 row
    of block membership, on the device, with no host sync and no new
    process group; with ``dot_group`` (the hierarchical extension: the
    vectors are 1/L shards) an allreduce over that group completes them
    further. B4's apply pass combines the halves. A distance-halving
    exchange reassembles the vector, and ranks past p get it back from
    their partner. ``wire`` carries both sweeps' half-exchanges (the
    pre/post hops stay fp32); the int8 rounding is keyed by ``seed``,
    the stage, ``lane`` (the rank's intra position) and, on the way up,
    the class of ranks that hold the same piece. Every rank of the group
    takes part in every exchange (``_collectives.exchange``)."""
    ranks = list(range(n)) if ranks is None else list(ranks)
    p = 1 << (n.bit_length() - 1)
    excess = n - p
    shape, dtype, dev = tensor.shape, tensor.dtype, tensor.device
    x = tensor.detach().to(torch.float32).reshape(-1)
    payload = x.numel()
    pad = (-payload) % p  # every halving stage splits evenly
    x = torch.cat([x, x.new_zeros(pad)]) if pad else x.clone()

    def stream(tag: int, key: int) -> int:
        return (tag << 20) | (lane << 10) | key

    if excess:
        if r >= p:
            exchange(x, None, ranks[r - p], group)
        elif r < excess:
            recv = torch.empty_like(x)
            exchange(None, recv, ranks[r + p], group)
            x = _combine(x, recv, dot_group)
        else:
            exchange(None, None, None, group, like=x)

    stages = p.bit_length() - 1
    piece = x
    for k in range(stages):
        d = 1 << k
        gathered = torch.empty((n, 3), dtype=torch.float32, device=dev)
        if r >= p:  # sitting out: idle, a singleton block of zeros
            _wire_exchange(None, None, group, wire, like=x)
            gather_into(gathered, torch.zeros(3, device=dev), group)
            continue
        h = piece.numel() // 2
        bit = bool(r & d)
        keep, send = (piece[h:], piece[:h]) if bit else (piece[:h],
                                                         piece[h:])
        recv, _ = _wire_exchange(send, ranks[r ^ d], group, wire, seed,
                                 stream(100 + k, r))
        local = cuda_kernels.adasum_dots(keep, recv)
        gather_into(gathered, local[_SWAP] if bit else local, group)
        row = torch.from_numpy(_block_rows(n, p, d)[r]).to(dev)
        tot = row @ gathered  # [a·b, ‖a‖², ‖b‖²] over the block
        if dot_group is not None:
            dist.all_reduce(tot, group=dot_group)
        piece = cuda_kernels.adasum_apply(keep, recv,
                                          tot[_SWAP] if bit else tot)

    for k in reversed(range(stages)):
        d = 1 << k
        if r >= p:
            _wire_exchange(None, None, group, wire, like=x)
            continue
        # ranks equal modulo 2d hold the same piece here: they key its
        # rounding alike, so every receiver of it reconstructs one value
        recv, own = _wire_exchange(piece, ranks[r ^ d], group, wire, seed,
                                   stream(200 + k, r & (2 * d - 1)))
        piece = torch.cat([recv, own] if r & d else [own, recv])

    if excess:
        if r < excess:
            exchange(piece, None, ranks[r + p], group)
        elif r >= p:
            piece = torch.empty_like(x)
            exchange(None, piece, ranks[r - p], group)
        else:
            exchange(None, None, None, group, like=x)
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
