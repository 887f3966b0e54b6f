"""In-step collectives: plain functions on tensors that ``torch.compile``
traces.

The counterpart of ``horovod_tpu/ops/traced.py``, whose functions run
inside ``jit``/``shard_map``. Here each rank is its own process, and
every function is a plain function of tensors that returns tensors, with
no handles and no fusion manager. Eagerly each collective is a
``torch.distributed`` call on a fresh output; under
``torch.compile(fullgraph=True)`` it is the functional collective of
``torch.distributed._functional_collectives``, a node of the graph. The
int8 quantizers (kernels B2 and B3 on the card) run as the custom
operators of ``cuda_kernels`` in a compiled region, so a compiled call
launches the hand-written kernels and advances their counters, and
through the same kernels' wrappers eagerly.

- The exact collectives (:func:`allreduce`, :func:`grouped_allreduce`,
  :func:`allgather`, :func:`broadcast`, :func:`alltoall`,
  :func:`reducescatter`) take the JAX function's keywords: ``op`` (Sum,
  Average, Min, Max, Product; Adasum runs ``ops/adasum.py`` on B4,
  eagerly: its pairwise exchanges are not functional collectives, so a
  compiled region breaks its graph there), pre/postscale, a
  ``process_set`` (members reduce in the set's group and outsiders get
  their input back; allgather and reducescatter mask the world, so that
  outsiders receive what the JAX function gives them), the join
  ``mask`` (a ``[world]`` bool: masked-out ranks add zeros and Average
  divides by the live count) and ``groups=`` (rank lists of one size
  that partition the world: each reduces among its own).
- An Average by a static count is one multiply by ``postscale / n``, as
  XLA rewrites the JAX function's division and as the fusion manager
  computes it, so the two routes agree bit for bit.
- The quantized wires (:func:`quantized_allreduce`,
  :func:`quantized_reducescatter`, :func:`quantized_allgather`) run the
  two-stage recipe of ``ops/int8_wire.py``, with the JAX residual
  contract. Stochastic rounding draws Philox keyed by (seed, stream),
  the stream naming the rank and the stage, so ranks and stages are
  decorrelated; it cannot match ``jax.random``'s bits.
- The expert wire's alltoalls of a ``[n, slots, d]`` dispatch buffer:
  :func:`quantized_alltoall` (block-scaled int8 by B3, pad slots exact
  zeros) and :func:`hierarchical_alltoall` (an inter hop and an intra
  hop, each at its own wire).
- The two-level recipes (:func:`hierarchical_allreduce_groups`,
  :func:`hierarchical_reducescatter`, :func:`hierarchical_allgather`)
  take ``stages``, the ``(intra, inter)`` rank lists of
  ``common/topology.hierarchy_stages``, and reuse the groups that
  ``hvd.init()`` made for them; :func:`hierarchical_allreduce` and
  :func:`hierarchical_quantized_allreduce` run over the 2-D device mesh
  ``("inter", "intra")`` of :func:`hierarchical_mesh`.

Process groups are made eagerly, in the same order on every rank, and
cached for the life of the ``hvd.init()`` (:func:`prepare_groups` makes
them ahead of a compiled region); a compiled region that needs a group
not made yet raises and names it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.utils import _pytree as pytree

from ..common import basics
from ..common import topology as topo_mod
from ..common.process_sets import ProcessSet
from . import int8_wire
from ._collectives import gather_into, scatter_reduce_into
from .reduction_ops import Adasum, Average, Max, Min, Product, Sum, resolve_op

INTER_AXIS, INTRA_AXIS = "inter", "intra"
_FUNCOL_OPS = {Min: "min", Max: "max", Product: "product"}
# Philox streams of this module's quantizers: 8 a rank, one a purpose
_STAGE1, _STAGE2, _REDUCESCATTER, _ALLGATHER, _ALLTOALL = range(5)


def rank() -> int:
    """This process's rank in the world."""
    return dist.get_rank()


def size() -> int:
    """The world's size."""
    return dist.get_world_size()


def _stream(purpose: int) -> int:
    return 8 * dist.get_rank() + purpose


# --------------------------------------------------- the collectives


# Eagerly each collective is a ``torch.distributed`` call on a fresh
# output (the fusion manager's calls, ``ops/_collectives.py``): on NCCL
# the current stream waits on NCCL's, and gloo takes CUDA tensors there
# (its functional all_gather kills the process, PERF.md §7). In a
# compiled region it is the functional collective, which the graph holds
# and waits on.
_DIST_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
             "max": dist.ReduceOp.MAX, "product": dist.ReduceOp.PRODUCT}


def _size(group) -> int:
    return dist.get_world_size(group)


def _all_reduce(x, op: str, group):
    if torch.compiler.is_compiling():
        return funcol.all_reduce(x, op, group)
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_DIST_OPS[op], group=group)
    return out


def _all_gather(x, group):
    """Every rank's ``x`` concatenated along dim 0."""
    x = x.contiguous()
    if torch.compiler.is_compiling():
        return funcol.all_gather_tensor(x, 0, group)
    out = x.new_empty((_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    gather_into(out, x, group)
    return out


def _reduce_scatter(x, dim: int, group):
    """The Sum of every rank's ``x``, this rank's slice along ``dim``."""
    if torch.compiler.is_compiling():
        return funcol.reduce_scatter_tensor(x.contiguous(), "sum", dim,
                                            group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // _size(group),) + tuple(x.shape[1:]))
    scatter_reduce_into(out, x, group)
    return out.movedim(0, dim)


def _all_to_all(x, group):
    """Equal dim-0 blocks to and from every rank."""
    x = x.contiguous()
    if torch.compiler.is_compiling():
        return funcol.all_to_all_single(x, None, None, group)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _broadcast(x, root: int, root_in_group: int, group):
    """``root``'s ``x`` (``root`` a global rank, ``root_in_group`` its
    position in ``group``) on every rank of ``group``."""
    if torch.compiler.is_compiling():
        return funcol.broadcast(x.contiguous(), root_in_group, group)
    out = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(out, src=root, group=group)
    return out


# ----------------------------------------------------------- the groups


def _key(groups) -> Tuple[Tuple[int, ...], ...]:
    return tuple(tuple(int(r) for r in g) for g in groups)


def _make(key, st) -> Tuple[object, int, int]:
    world, me = dist.get_world_size(), dist.get_rank()
    sizes = {len(g) for g in key}
    if len(sizes) != 1 or sorted(r for g in key for r in g) != list(
            range(world)):
        raise ValueError(
            f"groups must partition the world of {world} ranks into "
            f"lists of one size, got {key}")
    mine = next(g for g in key if me in g)
    topo = st.topology
    intra, inter = topo_mod.stage_ranks(topo.size, topo.local_size)
    if st.intra_group is not None and key == _key(intra):
        group = st.intra_group
    elif st.inter_group is not None and key == _key(inter):
        group = st.inter_group
    elif len(key) == 1:
        group = dist.group.WORLD
    else:
        group = None
        for g in key:  # collective: every rank makes every group
            made = dist.new_group(list(g))
            if me in g:
                group = made
    return group, mine.index(me), len(mine)


def _mine(groups) -> Tuple[object, int, int]:
    """(this rank's group among ``groups``, its position there, the
    group's size), made on first use and cached."""
    key = _key(groups)
    st = basics._require_init()
    hit = st.traced_groups.get(key)
    if hit is None:
        if torch.compiler.is_compiling():
            raise RuntimeError(
                f"the process group of groups={key} does not exist yet and "
                "a compiled region cannot make one; call "
                "traced.prepare_groups(...) before compiling")
        hit = st.traced_groups[key] = _make(key, st)
    return hit


def prepare_groups(*group_lists) -> None:
    """Make the process groups of each ``groups=`` rank-list partition
    (and of each ``stages`` pair) now, eagerly and in the same order on
    every rank, so that a compiled region finds them."""
    for groups in group_lists:
        if groups and isinstance(groups[0][0], (list, tuple)):  # stages
            for part in groups:
                _mine(part)
        else:
            _mine(groups)


class _Set:
    """A proper process set as the collectives see it."""

    def __init__(self, ps: ProcessSet):
        self.group = ps.group
        self.ranks = list(ps.ranks)
        self.size = ps.size
        self.member = dist.get_rank() in ps.ranks
        self.pos = self.ranks.index(dist.get_rank()) if self.member else 0


def _set_info(ps: Optional[ProcessSet]) -> Optional[_Set]:
    """None for the global set or one covering the whole world."""
    if ps is None or ps.process_set_id == 0 or (
            ps.size == dist.get_world_size()):
        return None
    return _Set(ps)


def _scale_static(out: torch.Tensor, n: int, op, postscale: float):
    """Average's division by the static count ``n`` and the postscale,
    as one multiply by ``postscale / n`` (fusion's ``_scale_out``)."""
    post = postscale / n if op == Average else postscale
    if post == 1.0:
        return out
    if out.is_floating_point():
        return out * post
    return torch.trunc(out.double() * post).to(out.dtype)


# ------------------------------------------------ the exact collectives


def allreduce(tensor: torch.Tensor, average: Optional[bool] = None, op=None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set: Optional[ProcessSet] = None, mask=None,
              groups=None) -> torch.Tensor:
    """Allreduce across the world (``traced.py:116``). With a process
    set, members reduce among themselves and outsiders get their input
    back. ``mask`` (Sum/Average) is the join mask, a ``[world]`` bool
    list or tensor: a masked-out rank adds zeros, Average divides by the
    live count, and every rank gets the live reduction; it composes with
    a process set by intersection. ``groups`` (Sum/Average, neither a
    set nor a mask) reduces within each group, Average dividing by the
    group's size."""
    op = resolve_op(op, average)
    if mask is not None and op not in (Average, Sum):
        raise ValueError("allreduce(mask=) supports op=Sum/Average only")
    if groups is not None:
        if op not in (Average, Sum):
            raise ValueError(
                "allreduce(groups=) supports op=Sum/Average only")
        if mask is not None or _set_info(process_set) is not None:
            raise NotImplementedError(
                "allreduce(groups=) composes with neither process sets "
                "nor join masks")
        group, _, n = _mine(groups)
        if prescale_factor != 1.0:
            tensor = tensor * prescale_factor
        out = _all_reduce(tensor, "sum", group)
        return _scale_static(out, n, op, postscale_factor)
    info = _set_info(process_set)
    if info is not None and not info.member:
        return tensor
    raw = tensor
    if prescale_factor != 1.0:
        tensor = tensor * prescale_factor
    if op == Adasum:
        from .adasum import adasum_allreduce

        out = adasum_allreduce(tensor, process_set=process_set)
        out = out * postscale_factor if postscale_factor != 1.0 else (
            out.clone() if out is raw else out)
        return out
    group = dist.group.WORLD if info is None else info.group
    n = dist.get_world_size() if info is None else info.size
    if op in _FUNCOL_OPS:
        out = _all_reduce(tensor, _FUNCOL_OPS[op], group)
        return _scale_static(out, n, Sum, postscale_factor)
    if op not in (Average, Sum):
        raise ValueError(f"unsupported reduce op {op}")
    if mask is None:
        out = _all_reduce(tensor, "sum", group)
        return _scale_static(out, n, op, postscale_factor)
    live = torch.as_tensor(mask, dtype=torch.bool, device=tensor.device)
    mine = live[dist.get_rank()]
    contrib = torch.where(mine, tensor, torch.zeros_like(tensor))
    out = _all_reduce(contrib, "sum", group)
    if op == Average:
        members = live if info is None else live[info.ranks]
        out = out / members.sum().clamp_min(1).to(out.dtype)
    if postscale_factor != 1.0:
        out = out * postscale_factor
    return out


def finite_scalar(x: torch.Tensor) -> torch.Tensor:
    """``all(isfinite(x))`` as one device bool; True for a non-floating
    payload. On already-reduced values it needs no collective: every
    rank holds the same values and computes the same bit."""
    if not x.is_floating_point():
        return torch.ones((), dtype=torch.bool, device=x.device)
    return torch.isfinite(x).all()


def tree_finite(tree) -> torch.Tensor:
    """:func:`finite_scalar` of every floating leaf, AND'd (True for a
    tree without one)."""
    flags = [finite_scalar(leaf) for leaf in pytree.tree_leaves(tree)
             if torch.is_tensor(leaf) and leaf.is_floating_point()]
    if not flags:
        return torch.ones((), dtype=torch.bool)
    out = flags[0]
    for f in flags[1:]:
        out = torch.logical_and(out, f)
    return out


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      average: Optional[bool] = None, op=None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      process_set: Optional[ProcessSet] = None
                      ) -> List[torch.Tensor]:
    """Reduce a list of tensors as one operation (``traced.py:320``): one
    collective a dtype over the members' concatenation (Sum, Average,
    Min, Max; Adasum tensor by tensor)."""
    op = resolve_op(op, average)
    if op == Adasum:
        return [allreduce(t, op=Adasum, prescale_factor=prescale_factor,
                          postscale_factor=postscale_factor,
                          process_set=process_set) for t in tensors]
    if op not in (Average, Sum, Min, Max):
        raise ValueError(f"unsupported grouped reduce op {op}")
    info = _set_info(process_set)
    tensors = list(tensors)
    if info is not None and not info.member:
        return tensors
    group = dist.group.WORLD if info is None else info.group
    n = dist.get_world_size() if info is None else info.size
    name = _FUNCOL_OPS.get(op, "sum")
    outs: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        if prescale_factor != 1.0:
            flat = flat * prescale_factor
        red = _all_reduce(flat, name, group)
        red = _scale_static(red, n, op if op == Average else Sum,
                            postscale_factor)
        off = 0
        for i in idx:
            k = tensors[i].numel()
            outs[i] = red[off:off + k].view(tensors[i].shape)
            off += k
    return outs


def allgather(tensor: torch.Tensor,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0 (equal shapes,
    ``traced.py:389``). With a process set, every rank, member or not,
    gets the members' tensors in set order (a masked world sum)."""
    info = _set_info(process_set)
    if info is None:
        return _all_gather(tensor, dist.group.WORLD)
    zero = torch.zeros_like(tensor)
    parts = [tensor if info.member and j == info.pos else zero
             for j in range(info.size)]
    return _all_reduce(torch.cat(parts), "sum", dist.group.WORLD)


def broadcast(tensor: torch.Tensor, root_rank: int,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Every rank gets ``root_rank``'s tensor (``traced.py:409``); with a
    process set, members get it and outsiders keep their input."""
    info = _set_info(process_set)
    if info is None:
        return _broadcast(tensor, root_rank, root_rank, dist.group.WORLD)
    if not info.member:
        return tensor
    return _broadcast(tensor, root_rank, info.ranks.index(root_rank),
                      info.group)


def alltoall(tensor: torch.Tensor,
             process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Scatter equal dim-0 blocks to the ranks and gather theirs
    (``traced.py:430``); with a process set, among the members, and
    outsiders get their input back."""
    info = _set_info(process_set)
    k = dist.get_world_size() if info is None else info.size
    if tensor.shape[0] % k:
        raise ValueError(
            f"alltoall over {k} ranks needs dim0 divisible by {k}, got "
            f"{tensor.shape[0]}")
    if info is not None and not info.member:
        return tensor
    group = dist.group.WORLD if info is None else info.group
    return _all_to_all(tensor, group)


def reducescatter(tensor: torch.Tensor, op=None,
                  prescale_factor: float = 1.0,
                  postscale_factor: float = 1.0,
                  process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Reduce (Sum/Average) then scatter dim-0 shards
    (``traced.py:474``). With a process set the world sums the members'
    tensors and each rank takes its set position's shard (an outsider
    the first shard, which means nothing, as in the JAX function)."""
    op = resolve_op(op, None)
    if op not in (Average, Sum):
        raise ValueError("reducescatter supports op=Sum/Average only")
    info = _set_info(process_set)
    if prescale_factor != 1.0:
        tensor = tensor * prescale_factor
    if info is None:
        n = dist.get_world_size()
        out = _reduce_scatter(tensor, 0, dist.group.WORLD)
    else:
        n = info.size
        if tensor.shape[0] % n:
            raise ValueError(
                f"reducescatter over a {n}-rank process set needs dim0 "
                f"divisible by {n}, got {tensor.shape[0]}")
        contrib = tensor if info.member else torch.zeros_like(tensor)
        total = _all_reduce(contrib, "sum", dist.group.WORLD)
        d = tensor.shape[0] // n
        out = total[info.pos * d:(info.pos + 1) * d]
    return _scale_static(out, n, op, postscale_factor)


# -------------------------------------------------- the quantized wires


def _exchange(group):
    """The int8 recipe's exchange over ``group`` (the fusion manager's
    too): values and scales, row r to rank r."""
    def exchange(q, scales):
        return (_all_to_all(q, group),
                _all_to_all(scales, group))
    return exchange


def _gather(group, n):
    def gather(q2, s2):
        return (_all_gather(q2, group).view(n, -1),
                _all_gather(s2, group).view(n, -1))
    return gather


def _kernels() -> int8_wire.Kernels:
    """The quantizers: the custom operators inside a compiled region, so
    that the graph holds the kernels; their wrappers eagerly (the same
    kernels: the operators call them), as a process's first call of a
    custom operator imports the compiler stack, seconds of host time."""
    if torch.compiler.is_compiling():
        return int8_wire.COMPILABLE
    return int8_wire.EAGER


def _stochastic_round_rows(x2d: torch.Tensor, seed: int = 0,
                           stream: int = 0):
    """One absmax scale a row, stochastic rounding (B2 a row): int8
    ``[rows, cols]`` and fp32 scales ``[rows, 1]``."""
    return int8_wire._quantize(x2d, None, seed, stream, _kernels())


def _stochastic_round_blocks(x2d: torch.Tensor, block: int, seed: int = 0,
                             stream: int = 0):
    """One absmax scale a ``block`` elements within each row (B3):
    int8 ``[rows, cols]`` and fp32 scales ``[rows, nb]``; the tail block
    is padded for the absmax only, so padding sets no scale."""
    return _kernels().block(x2d, block, seed, stream)


def _block_dequant(q: torch.Tensor, scales: torch.Tensor,
                   block: Optional[int]) -> torch.Tensor:
    """int8 rows times their block (or row) scales, fp32."""
    return int8_wire.dequantize(q, scales, block)


def _quantized_allreduce(tensor, op, group, n, idx, seed, return_residual,
                         prescale_factor, block_size):
    shape, dtype = tensor.shape, tensor.dtype
    flat = tensor.reshape(-1).to(torch.float32)
    m = flat.numel()
    chunk = -(-m // n)
    chunks = torch.nn.functional.pad(flat, (0, chunk * n - m)).view(n, chunk)
    block = int(block_size) if block_size else None
    st = int8_wire.quantized_sum(
        chunks, block, seed, (_stream(_STAGE1), _stream(_STAGE2)),
        _exchange(group), _gather(group, n), _kernels(),
        prescale=prescale_factor, divisor=n if op == Average else None)
    out = int8_wire.unpack(st.all_q, st.all_s, block, m).reshape(shape).to(
        dtype)
    if not return_residual:
        return out
    if prescale_factor == 0.0:
        # nothing was sent, so no correction can surface: a zero carry
        return out, torch.zeros(shape, dtype=dtype, device=tensor.device)
    res = int8_wire.residual(
        chunks, st, block, idx, m, e2_mul=n if op == Average else None,
        e2_div=prescale_factor if prescale_factor != 1.0 else None)
    return out, res.reshape(shape).to(dtype)


def quantized_allreduce(tensor: torch.Tensor, op=None, seed: int = 0,
                        return_residual: bool = False,
                        prescale_factor: float = 1.0,
                        block_size: Optional[int] = None, groups=None):
    """Allreduce moving int8 (``traced.py:573``): the two-stage recipe
    of ``ops/int8_wire.py`` over the world, Sum or Average. With
    ``block_size`` None, the per-row wire: one scale a peer's chunk
    (B2 a row), and B2 again on the reduced shard; with a block size,
    block scales in both stages (B3). The prescale is folded into the
    wire scales.

    ``return_residual=True`` also returns the error-feedback carry in
    input units: this rank's stage-1 error, plus on the chunk it owns
    the stage-2 error (×n under Average, ÷ the prescale); zero when the
    prescale is 0. ``groups`` runs the grouped recipe
    (:func:`_quantized_sum_groups`) within each group, with the prescale
    multiplied in and the carry divided by it."""
    op = resolve_op(op, None)
    if op not in (Average, Sum):
        raise ValueError("quantized_allreduce supports Sum/Average only")
    if groups is None:
        return _quantized_allreduce(
            tensor, op, dist.group.WORLD, dist.get_world_size(),
            dist.get_rank(), seed, return_residual, prescale_factor,
            block_size)
    _, pos, gn = _mine(groups)
    shape, dtype = tensor.shape, tensor.dtype
    flat = tensor.reshape(-1).to(torch.float32)
    if prescale_factor != 1.0:
        flat = flat * prescale_factor
    block = int(block_size) if block_size else max(-(-flat.numel() // gn),
                                                   1)
    out, res = _quantized_sum_groups(flat, groups, gn, block, seed, pos,
                                     return_residual)
    if op == Average:
        out = out / gn
    out = out.reshape(shape).to(dtype)
    if not return_residual:
        return out
    if prescale_factor == 0.0:
        return out, torch.zeros(shape, dtype=dtype, device=tensor.device)
    if prescale_factor != 1.0:
        res = res / prescale_factor
    return out, res.reshape(shape).to(dtype)


def quantized_reducescatter(panes: torch.Tensor, op=None, seed: int = 0,
                            block_size: Optional[int] = None,
                            return_residual: bool = False, groups=None):
    """One-stage quantized reduce-scatter of ``[n, cols]`` panes, row j
    bound for rank j (``traced.py:755``): block-quantize, exchange int8
    and scales, dequantize and sum in fp32 into this rank's ``[cols]``
    shard. One quantum of error an element; ``return_residual`` gives
    ``panes − dequant(quant(panes))`` in input units."""
    op = resolve_op(op, None)
    if op not in (Average, Sum):
        raise ValueError("quantized_reducescatter supports Sum/Average only")
    group, _, n = ((dist.group.WORLD, 0, dist.get_world_size())
                   if groups is None else _mine(groups))
    if panes.dim() != 2 or panes.shape[0] != n:
        raise ValueError(
            f"panes must be [world={n}, cols], got {tuple(panes.shape)}")
    cols = panes.shape[1]
    x = panes.to(torch.float32)
    block = int(block_size) if block_size else max(cols, 1)
    q, scales = _stochastic_round_blocks(x, block, seed,
                                         _stream(_REDUCESCATTER))
    recv_q, recv_s = _exchange(group)(q, scales)
    shard = int8_wire.dequantize(recv_q, recv_s, block).sum(0)
    if op == Average:
        shard = shard / n
    if not return_residual:
        return shard
    return shard, x - int8_wire.dequantize(q, scales, block)


def quantized_allgather(shard: torch.Tensor, seed: int = 0,
                        block_size: Optional[int] = None,
                        return_residual: bool = False, groups=None):
    """Quantized allgather of every rank's ``[cols]`` shard
    (``traced.py:817``): block-scaled int8 on the wire, and every rank,
    the owner too, takes the dequantized value, so the replicas stay
    bitwise equal. Returns ``[n, cols]`` fp32; ``return_residual`` also
    ``shard − dequant(quant(shard))``."""
    group, _, n = ((dist.group.WORLD, 0, dist.get_world_size())
                   if groups is None else _mine(groups))
    x = shard.reshape(1, -1).to(torch.float32)
    block = int(block_size) if block_size else max(x.shape[1], 1)
    q, s = _stochastic_round_blocks(x, block, seed, _stream(_ALLGATHER))
    all_q, all_s = _gather(group, n)(q[0], s[0])
    out = int8_wire.dequantize(all_q, all_s, block)
    if not return_residual:
        return out
    return out, (x - int8_wire.dequantize(q, s, block))[0]


def _check_dispatch(tensor: torch.Tensor, n: int) -> None:
    if tensor.dim() != 3 or tensor.shape[0] != n:
        raise ValueError(
            f"dispatch buffer must be [n={n}, slots, d], got "
            f"{tuple(tensor.shape)}")


def quantized_alltoall_in(tensor: torch.Tensor, group, n: int,
                          seed: int = 0,
                          block_size: Optional[int] = None) -> torch.Tensor:
    """:func:`quantized_alltoall` within ``group`` (``n`` members), a
    process group the caller made: the expert wire's form on a mesh
    axis."""
    _check_dispatch(tensor, n)
    _, slots, d = tensor.shape
    x = tensor.reshape(n * slots, d).to(torch.float32)
    # clamp to the row width: a block wider than d would zero-pad every
    # row up to it and the int8 wire would move more bytes than fp32
    block = max(min(int(block_size), d) if block_size else d, 1)
    q, scales = _stochastic_round_blocks(x, block, seed, _stream(_ALLTOALL))
    if n > 1:
        q, scales = _all_to_all(q, group), _all_to_all(scales, group)
    return int8_wire.dequantize(q, scales, block).reshape(n, slots, d)


def quantized_alltoall(tensor: torch.Tensor, seed: int = 0,
                       block_size: Optional[int] = None,
                       groups=None) -> torch.Tensor:
    """Block-scaled int8 alltoall of a ``[n, slots, d]`` dispatch buffer,
    row j bound for rank j (``traced.py:859``; the MoE expert-dispatch
    layout of ``parallel/moe.py``): each (destination, slot) row is
    quantized by B3 with one absmax scale per ``block_size`` elements of
    ``d`` (clamped to ``d``; default ``d``) and stochastic rounding, int8
    and scales are exchanged, and the receiver dequantizes to fp32.

    Pad exclusion by construction: empty slots are all-zero rows, and
    zeros quantize to zeros without raising a block's absmax, so a pad
    slot sets no scale and arrives as exact zeros. ``groups`` (rank
    lists partitioning the world) restricts the exchange to this rank's
    group; ``n`` is then its size. Returns fp32 ``[n, slots, d]``."""
    group, _, n = ((dist.group.WORLD, 0, dist.get_world_size())
                   if groups is None else _mine(groups))
    return quantized_alltoall_in(tensor, group, n, seed, block_size)


def hierarchical_alltoall_in(tensor: torch.Tensor, intra, inter,
                             intra_wire: str = "fp32",
                             inter_wire: str = "fp32", seed: int = 0,
                             block_size: Optional[int] = None
                             ) -> torch.Tensor:
    """:func:`hierarchical_alltoall` over process groups the caller
    made: ``intra`` and ``inter`` are ``(group, position, size)`` of
    this rank's intra and inter groups."""
    (gi, _, L), (ge, pos, H) = intra, inter
    n = L * H
    _check_dispatch(tensor, n)
    _, slots, d = tensor.shape
    dtype = tensor.dtype
    exact = not tensor.is_floating_point()
    # destination blocks, slice-major: xr[h] = everything bound for
    # slice h
    xr = tensor.reshape(H, L * slots, d)
    if inter_wire == "int8" and not exact:
        y = quantized_alltoall_in(xr, ge, H, seed, block_size).to(dtype)
    else:
        wire = "fp32" if exact else inter_wire
        y = _all_to_all(_stage_cast(xr, wire), ge).to(dtype) if H > 1 \
            else xr
    if inter_wire in ("bf16", "int8") and not exact:
        # the self-slice block never crossed the inter hop: restore the
        # original so intra-bound tokens stay exact
        y = torch.cat([y[:pos], xr[pos:pos + 1], y[pos + 1:]])
    # y[h_s] = blocks from (h_s, this node-local slot) for every
    # destination; regroup by destination intra position
    y = y.reshape(H, L, slots, d).transpose(0, 1).reshape(L, H * slots, d)
    iw = "fp32" if exact else intra_wire
    z = _all_to_all(_stage_cast(y, iw), gi).to(dtype) if L > 1 else y
    # z[l_s] = blocks from (h_s, l_s): back to flat rank-major order
    return z.reshape(L, H, slots, d).transpose(0, 1).reshape(n, slots, d)


def hierarchical_alltoall(tensor: torch.Tensor, stages=None,
                          intra_wire: str = "fp32",
                          inter_wire: str = "fp32", seed: int = 0,
                          block_size: Optional[int] = None) -> torch.Tensor:
    """Two-level alltoall of a ``[n, slots, d]`` dispatch buffer
    (``traced.py:919``) over ``stages`` (``topology.hierarchy_stages``'
    contiguous-intra rank lists), elementwise equal to the flat alltoall
    on exact wires:

    1. the inter hop: same-position ranks across nodes exchange whole
       per-destination-node sub-buffers at ``inter_wire`` (fp32, bf16,
       or int8 by :func:`quantized_alltoall`); either lossy wire restores
       the self-node block from the original afterwards, so tokens bound
       for intra-node experts never pay the loss;
    2. the intra hop: one alltoall inside each node delivers every block
       to its destination rank at ``intra_wire`` (fp32, bf16).

    Non-float payloads (the MoE expert-index map) ride both hops exact.
    Returns the input dtype."""
    intra, inter, _ = _stages(stages)
    return hierarchical_alltoall_in(tensor, intra, inter, intra_wire,
                                    inter_wire, seed, block_size)


# ----------------------------------------------- the two-level recipes


def _stage_cast(x: torch.Tensor, wire: str) -> torch.Tensor:
    """A buffer on one hop's wire: bf16 halves the bytes; fp32 is the
    payload's own width."""
    return x.to(torch.bfloat16) if wire == "bf16" else x


def _group_pos_table(groups) -> List[int]:
    """Each rank's index within its group, by rank."""
    table = [0] * sum(len(g) for g in groups)
    for g in groups:
        for i, r in enumerate(g):
            table[r] = i
    return table


def _quantized_sum_groups(row: torch.Tensor, groups, n: int, block: int,
                          seed: int, pos: Optional[int] = None,
                          want_residual: bool = False):
    """The two-stage block recipe within each of ``groups`` (``n``
    members each; ``traced.py:1045``), Sum semantics (the caller divides
    for Average). Returns ``(out, residual or None)``: the residual in
    input units, the owned chunk (``pos``, by default this rank's
    position in its group) carrying the stage-2 error unscaled, since the
    caller's division reaches it and a correction alike."""
    group, mypos, _ = _mine(groups)
    pos = mypos if pos is None else pos
    m = row.numel()
    chunk = -(-m // n)
    chunks = torch.nn.functional.pad(row, (0, chunk * n - m)).view(n, chunk)
    st = int8_wire.quantized_sum(
        chunks, block, seed, (_stream(_STAGE1), _stream(_STAGE2)),
        _exchange(group), _gather(group, n), _kernels())
    out = int8_wire.unpack(st.all_q, st.all_s, block, m)
    if not want_residual:
        return out, None
    return out, int8_wire.residual(chunks, st, block, pos, m)


def _stages(stages):
    if stages is None:
        raise ValueError("stages is required (topology.hierarchy_stages)")
    intra_groups, inter_groups = stages
    return _mine(intra_groups), _mine(inter_groups), inter_groups


def hierarchical_allreduce_groups(
        tensor: torch.Tensor, op=None, stages=None, intra_wire: str = "fp32",
        inter_wire: str = "fp32", seed: int = 0,
        block_size: Optional[int] = None, prescale_factor: float = 1.0,
        postscale_factor: float = 1.0, return_residual: bool = False):
    """Two-level allreduce (``traced.py:1103``): a reduce-scatter within
    the node at ``intra_wire`` (fp32, bf16), the 1/L shard reduced
    across nodes at ``inter_wire`` (fp32, bf16, or int8 by
    :func:`_quantized_sum_groups`), an allgather within the node at
    ``intra_wire``. With every hop at fp32 it is the exact sum (bitwise
    the flat route's on integer-valued grids). ``return_residual`` (int8
    inter only) gives the inter hop's carry in input units, gathered over
    the node and divided by L, so the next intra reduce-scatter adds one
    copy of it at the shard's owner."""
    op = resolve_op(op, None)
    if op not in (Average, Sum):
        raise ValueError(
            "hierarchical_allreduce_groups supports Sum/Average only")
    if return_residual and inter_wire != "int8":
        raise ValueError(
            "return_residual needs inter_wire='int8' (exact hops have no "
            "residual to carry)")
    (gi, _, L), (ge, pos, H), inter_groups = _stages(stages)
    shape, dtype = tensor.shape, tensor.dtype
    flat = tensor.reshape(-1)
    if inter_wire == "int8":
        flat = flat.to(torch.float32)
    m = flat.numel()
    flat = torch.nn.functional.pad(flat, (0, (-m) % L))
    if prescale_factor != 1.0:
        flat = flat * prescale_factor
    shard = _reduce_scatter(_stage_cast(flat, intra_wire), 0, gi).to(
        flat.dtype)
    residual = None
    if inter_wire == "int8":
        block = int(block_size) if block_size else max(shard.numel(), 1)
        red, res = _quantized_sum_groups(shard, inter_groups, H, block, seed,
                                         pos, return_residual)
        if res is not None:
            if prescale_factor == 0.0:
                res = torch.zeros_like(res)  # nothing sent: no carry
            elif prescale_factor != 1.0:
                res = res / prescale_factor
            residual = _all_gather(res / L, gi)[:m]
    else:
        red = _all_reduce(_stage_cast(shard, inter_wire), "sum", ge).to(
            shard.dtype)
    out = _all_gather(_stage_cast(red, intra_wire), gi).to(flat.dtype)
    out = _scale_static(out[:m], L * H, op, postscale_factor)
    out = out.reshape(shape).to(dtype)
    if not return_residual:
        return out
    if residual is None:
        return out, torch.zeros(shape, dtype=dtype, device=tensor.device)
    return out, residual.reshape(shape).to(dtype)


def hierarchical_reducescatter(panes: torch.Tensor, op=None, stages=None,
                               intra_wire: str = "fp32",
                               inter_wire: str = "fp32", seed: int = 0,
                               block_size: Optional[int] = None):
    """Two-level reduce-scatter of ``[n, cols]`` panes, row j bound for
    rank j (``traced.py:1216``): a reduce-scatter within the node of the
    rows that share this rank's node-local slot, then one across nodes
    (int8 by :func:`quantized_reducescatter`), into this rank's
    ``[cols]``. Sum/Average."""
    op = resolve_op(op, None)
    if op not in (Average, Sum):
        raise ValueError(
            "hierarchical_reducescatter supports Sum/Average only")
    (gi, _, L), (ge, _, H), inter_groups = _stages(stages)
    n = L * H
    if panes.dim() != 2 or panes.shape[0] != n:
        raise ValueError(
            f"panes must be [world={n}, cols], got {tuple(panes.shape)}")
    cols, dtype = panes.shape[1], panes.dtype
    s1 = _reduce_scatter(_stage_cast(panes.reshape(H, L, cols), intra_wire),
                         1, gi).to(dtype).reshape(H, cols)
    if inter_wire == "int8":
        shard = quantized_reducescatter(
            s1.to(torch.float32), op=Sum, seed=seed, block_size=block_size,
            groups=inter_groups).to(dtype)
    else:
        shard = _reduce_scatter(_stage_cast(s1, inter_wire), 0, ge).to(
            dtype).reshape(cols)
    return _scale_static(shard, n, op, 1.0)


def hierarchical_allgather(shard: torch.Tensor, stages=None,
                           intra_wire: str = "fp32",
                           inter_wire: str = "fp32", seed: int = 0,
                           block_size: Optional[int] = None) -> torch.Tensor:
    """Two-level allgather of every rank's ``[cols]`` shard
    (``traced.py:1274``): across nodes among the ranks of this node-local
    slot (int8 by :func:`quantized_allgather`), then within the node,
    reordered to rank order: ``[n, cols]``."""
    (gi, _, L), (ge, _, H), inter_groups = _stages(stages)
    cols, dtype = shard.shape[0], shard.dtype
    if inter_wire == "int8":
        g1 = quantized_allgather(shard.to(torch.float32), seed=seed,
                                 block_size=block_size,
                                 groups=inter_groups).to(dtype)
    else:
        g1 = _all_gather(_stage_cast(shard, inter_wire), ge).to(dtype).view(
            H, cols)
    g2 = _all_gather(_stage_cast(g1, intra_wire), gi).to(dtype).view(
        L, H, cols)
    return g2.transpose(0, 1).reshape(L * H, cols)


def hierarchical_mesh(local_size: Optional[int] = None):
    """The 2-D device mesh ``("inter", "intra")`` over the world's rank
    grid (``traced.py:1316``): ``local_size`` ranks a node (default: the
    topology's, ``HOROVOD_INTRA_SIZE``), over the groups ``hvd.init()``
    made for that split, or new ones for another."""
    from torch.distributed.device_mesh import DeviceMesh

    st = basics._require_init()
    world = st.topology.size
    local = st.topology.local_size if local_size is None else int(local_size)
    if local < 1 or world % local:
        raise ValueError(f"local_size {local} must divide world {world}")
    intra, inter = topo_mod.stage_ranks(world, local)
    groups = [_mine(inter)[0], _mine(intra)[0]]
    grid = torch.arange(world).view(world // local, local)
    return DeviceMesh.from_group(groups, st.device.type, mesh=grid,
                                 mesh_dim_names=(INTER_AXIS, INTRA_AXIS))


def _two_level_allreduce(tensor, op, mesh, inter_reduce, prescale=1.0,
                         postscale=1.0):
    """Reduce-scatter on ``intra``, ``inter_reduce(shard) -> (reduced,
    carry or None)`` on ``inter``, allgather on ``intra``; a carry is
    divided by L and gathered like the output."""
    gi = mesh.get_group(INTRA_AXIS)
    L, H = mesh.size(1), mesh.size(0)
    shape, dtype = tensor.shape, tensor.dtype
    flat = tensor.reshape(-1)
    m = flat.numel()
    flat = torch.nn.functional.pad(flat, (0, (-m) % L))
    if prescale != 1.0:
        flat = flat * prescale
    shard = _reduce_scatter(flat, 0, gi)
    red, extra = inter_reduce(shard)
    out = _all_gather(red, gi)
    out = _scale_static(out[:m], L * H, op, postscale).reshape(shape).to(
        dtype)
    if extra is None:
        return out, None
    extra = _all_gather(extra / L, gi)
    return out, extra[:m].reshape(shape).to(dtype)


def hierarchical_allreduce(tensor: torch.Tensor, op=None, mesh=None,
                           prescale_factor: float = 1.0,
                           postscale_factor: float = 1.0) -> torch.Tensor:
    """Two-level allreduce over a :func:`hierarchical_mesh` (the default
    one when ``mesh`` is None; ``traced.py:1342``): reduce-scatter within
    the node, allreduce of the 1/L shards across nodes, allgather within
    the node. Sum/Average."""
    op = resolve_op(op, None)
    if op not in (Average, Sum):
        raise ValueError("hierarchical_allreduce supports Sum/Average only")
    mesh = hierarchical_mesh() if mesh is None else mesh
    ge = mesh.get_group(INTER_AXIS)
    out, _ = _two_level_allreduce(
        tensor, op, mesh, lambda s: (_all_reduce(s, "sum", ge), None),
        prescale_factor, postscale_factor)
    return out


def hierarchical_quantized_allreduce(tensor: torch.Tensor, op=None,
                                     mesh=None, seed: int = 0,
                                     return_residual: bool = False):
    """:func:`hierarchical_allreduce` with the inter hop on
    :func:`quantized_allreduce`'s per-row int8 wire
    (``traced.py:1413``); the intra hops stay exact. ``return_residual``
    gives the inter carry in input units, divided by L and gathered over
    the node."""
    op = resolve_op(op, None)
    if op not in (Average, Sum):
        raise ValueError(
            "hierarchical_quantized_allreduce supports Sum/Average only")
    mesh = hierarchical_mesh() if mesh is None else mesh
    ge, H = mesh.get_group(INTER_AXIS), mesh.size(0)
    pos = mesh.get_local_rank(INTER_AXIS)

    def inter(shard):
        got = _quantized_allreduce(shard, Sum, ge, H, pos, seed,
                                   return_residual, 1.0, None)
        return got if return_residual else (got, None)

    out, residual = _two_level_allreduce(tensor, op, mesh, inter)
    return (out, residual) if return_residual else out
