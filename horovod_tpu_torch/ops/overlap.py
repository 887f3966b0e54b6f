"""Bucketed gradient exchange: one collective a bucket, issued while
backprop runs on.

The counterpart of ``horovod_tpu/ops/overlap.py`` (its
``bucketed_allreduce``/``overlap_boundary`` half). A single exchange over
the whole gradient waits for the last gradient, so nothing overlaps it;
cut into buckets in reverse registration order (the order backprop
produces them, the DDP heuristic), the first bucket's collective can run
while earlier layers are still differentiating:

- :func:`build_bucket_schedule` partitions the leaves into at most N
  size-balanced, dtype-homogeneous buckets in reverse order (the
  closest-boundary rule), merges a bucket under ``min_bucket_bytes``
  forward and an under-floor tail backward; it gives the JAX function's
  buckets and bytes for the same shapes and dtypes. :func:`schedule_for`
  caches schedules with hit and miss counters (the retrace tripwire:
  a loop that rebuilds its schedule shows up as misses), and each
  lookup publishes the ``overlap.*`` gauges (``common/metrics.py``).
- :func:`bucketed_allreduce` concatenates each bucket's members, runs
  ONE collective of ``ops/traced.py`` on it and splits the result back:
  the exact allreduce for fp32/fp16/bf16 (process sets, the join mask,
  pre/postscale and ``groups=`` compose), ``quantized_allreduce`` for an
  int8 compression, with a rounding seed decorrelated per bucket and the
  error-feedback residuals sliced per bucket, and the two-level
  ``hierarchical_allreduce_groups`` when ``hier_stages`` resolves (int8
  on the inter hop only; ``Compression.hier_int8`` adds bf16 intra).
  With Sum on fp32 it is bitwise the per-tensor allreduce: a sum over a
  concatenation is the same sum element by element. Adasum, Min, Max
  and Product raise: they do not commute with the concatenation.
- :func:`overlap_boundary` is identity on the forward; on the backward
  each bucket's gradients come out already reduced. It is one
  ``torch.autograd.Function`` a bucket, so that a bucket's collective
  runs when its last member's gradient arrives (one Function over every
  parameter would run its backward only once backprop had ended).
  Eagerly the reduced gradient is consumed at once, by the accumulation
  into ``.grad``, so the boundary has the JAX semantics but the
  exchange waits in line on the card; ``DistributedOptimizer``'s
  ``overlap_buckets`` (``optimizer.py``) issues each bucket on a side
  stream and waits at ``step()``.

Not here yet: the schedule's sidecar on disk (ROADMAP A16), the wire
tuner (A12) and the sharded bucket legs (A10).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from ..common import basics
from ..common import metrics
from ..common import topology as topo_mod
from ..common.config import TrainConfig
from ..common.process_sets import ProcessSet
from . import traced
from .compression import Compression, Compressor
from .reduction_ops import Average, Sum, resolve_op


class BucketSchedule(NamedTuple):
    """A partition of the gradient leaves into buckets, each a tuple of
    leaf indices, in EMISSION order: bucket 0's members come first in
    backprop (reverse leaf order), so its collective goes first.
    ``passthrough`` are leaves without a gradient (None), which no
    collective carries."""

    buckets: Tuple[Tuple[int, ...], ...]
    bucket_bytes: Tuple[int, ...]
    total_bytes: int
    passthrough: Tuple[int, ...] = ()

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)


def _nbytes(leaf: torch.Tensor) -> int:
    return math.prod(leaf.shape) * leaf.element_size()


def _leaf_key(leaf) -> Tuple:
    if leaf is None:
        return (None,)
    return (tuple(leaf.shape), str(leaf.dtype))


_CACHE: dict = {}
_CACHE_CAP = 256
_STATS = {"hits": 0, "misses": 0}


def schedule_cache_stats() -> dict:
    return dict(_STATS, size=len(_CACHE))


def reset_schedule_cache() -> None:
    _CACHE.clear()
    _STATS["hits"] = 0
    _STATS["misses"] = 0


def build_bucket_schedule(leaves: Sequence[Optional[torch.Tensor]],
                          n_buckets: int,
                          min_bucket_bytes: int = 0) -> BucketSchedule:
    """Partition ``leaves`` into at most ``n_buckets`` size-balanced
    buckets in reverse order (``overlap.py:158``). A bucket closes before
    a leaf whose midpoint crosses the next ideal boundary ``(k+1) ·
    total / N``, and at every dtype change (a concatenation has one
    dtype). Buckets under ``min_bucket_bytes`` absorb the next bucket of
    their dtype; an under-floor tail merges backward."""
    if n_buckets < 1:
        raise ValueError(f"n_buckets must be >= 1, got {n_buckets}")
    passthrough = tuple(i for i, leaf in enumerate(leaves) if leaf is None)
    order = [i for i in reversed(range(len(leaves))) if leaves[i] is not None]
    if not order:
        return BucketSchedule((), (), 0, passthrough)
    nbytes = {i: _nbytes(leaves[i]) for i in order}
    total = sum(nbytes.values())
    target = total / n_buckets
    buckets, cur = [], []
    cum, cur_bytes, closed = 0, 0, 0
    cur_dtype = None
    for i in order:
        d = leaves[i].dtype
        if cur and (cur_dtype != d or (
                closed < n_buckets - 1
                and cum + nbytes[i] / 2 >= (closed + 1) * target)):
            buckets.append((tuple(cur), cur_bytes))
            closed += 1
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes[i]
        cum += nbytes[i]
        cur_dtype = d
    if cur:
        buckets.append((tuple(cur), cur_bytes))
    if min_bucket_bytes > 0:
        dtype = lambda b: leaves[b[0][0]].dtype  # noqa: E731
        merged = []
        for b in buckets:
            if merged and merged[-1][1] < min_bucket_bytes and (
                    dtype(merged[-1]) == dtype(b)):
                merged[-1] = (merged[-1][0] + b[0], merged[-1][1] + b[1])
            else:
                merged.append(b)
        if len(merged) > 1 and merged[-1][1] < min_bucket_bytes and (
                dtype(merged[-2]) == dtype(merged[-1])):
            (pi, pb), (ti, tb) = merged[-2:]
            merged[-2:] = [(pi + ti, pb + tb)]
        buckets = merged
    return BucketSchedule(tuple(i for i, _ in buckets),
                          tuple(b for _, b in buckets), total, passthrough)


def schedule_for(leaves: Sequence[Optional[torch.Tensor]], treedef: Any,
                 n_buckets: int, min_bucket_bytes: int = 0) -> BucketSchedule:
    """:func:`build_bucket_schedule`, cached by the tree's structure, the
    leaves' shapes and dtypes and the knobs, counting hits and misses."""
    key = (str(treedef), tuple(_leaf_key(leaf) for leaf in leaves),
           int(n_buckets), int(min_bucket_bytes))
    sched = _CACHE.get(key)
    if sched is not None:
        _STATS["hits"] += 1
        return sched
    _STATS["misses"] += 1
    sched = build_bucket_schedule(leaves, n_buckets, min_bucket_bytes)
    if len(_CACHE) >= _CACHE_CAP:
        _CACHE.pop(next(iter(_CACHE)))
    _CACHE[key] = sched
    return sched


def _config() -> TrainConfig:
    st = basics.state()
    return st.config if st.initialized else TrainConfig.from_env()


def default_buckets() -> int:
    """``HOROVOD_OVERLAP_BUCKETS`` when ``HOROVOD_OVERLAP`` is on, else 0
    (the fused path)."""
    cfg = _config()
    return cfg.overlap_buckets if cfg.overlap else 0


def default_min_bytes() -> int:
    """``HOROVOD_OVERLAP_MIN_BYTES``."""
    return _config().overlap_min_bytes


def _auto_stages(hier_stages, world: int):
    """``"auto"``: the ``HOROVOD_HIERARCHICAL`` decision for ``world``;
    an explicit ``(intra, inter)`` pair as it is; None: flat."""
    if hier_stages == "auto":
        return topo_mod.hierarchy_stages(world=world)
    return hier_stages


def _publish(schedule: BucketSchedule) -> None:
    metrics.publish_overlap(schedule.n_buckets, schedule.bucket_bytes,
                            schedule.total_bytes)


class Wire(NamedTuple):
    """How each bucket is exchanged: the reduction's op and scales, the
    compression, and where it routes (a process set, the join mask,
    ``groups=``, or the two-level ``stages``)."""

    op: Any
    compression: Any
    prescale: float
    postscale: float
    process_set: Optional[ProcessSet]
    mask: Any
    groups: Any
    stages: Any

    @property
    def quantized(self) -> bool:
        return getattr(self.compression, "quantized_wire", False)

    @property
    def block(self) -> Optional[int]:
        return getattr(self.compression, "block_size", None)

    @property
    def hier_intra(self) -> str:
        # hier_int8's placement: bf16 on the intra hops under int8 inter;
        # int8 and int8_block keep the intra hops exact
        return ("bf16" if getattr(self.compression, "wire_format", None)
                == "int8_hier" else "fp32")


def make_wire(op, compression: Compressor = Compression.none,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set: Optional[ProcessSet] = None, mask=None,
              groups=None, hier_stages="auto",
              residuals: bool = False) -> Wire:
    """Check the knobs of a bucketed exchange and resolve its route
    (``overlap.py:399-496``)."""
    if op not in (Sum, Average):
        raise ValueError(
            "bucketed_allreduce supports op=Sum/Average only (Adasum and "
            "min/max/product do not commute with bucket concatenation); "
            "use the fused path for other ops")
    pset = process_set is not None and process_set.process_set_id != 0
    quantized = getattr(compression, "quantized_wire", False)
    if groups is not None and (mask is not None or pset):
        raise NotImplementedError(
            "bucketed_allreduce(groups=) composes with neither process "
            "sets nor join masks")
    if quantized and pset:
        raise NotImplementedError(
            "the quantized bucketed wire over a process set is not "
            "supported; use fp32/bf16 compression or the global set")
    if quantized and mask is not None:
        raise NotImplementedError(
            "the join mask over the quantized bucketed wire is not "
            "supported; use fp32/bf16 compression under join")
    if residuals and not quantized:
        raise ValueError(
            "error feedback requires a quantized-wire compression "
            "(Compression.int8); lossless and fp16 wires have no residual")
    stages = None
    if groups is None and not pset and mask is None:
        world = dist.get_world_size()
        stages = _auto_stages(hier_stages, world)
        if stages is None and hier_stages == "auto" and getattr(
                compression, "wire_format", None) == "int8_hier":
            # hier_int8 is an explicit request: any split that resolves
            stages = topo_mod.hierarchy_stages(world=world, mode="on")
    return Wire(op, compression, float(prescale_factor),
                float(postscale_factor), process_set, mask, groups, stages)


def exchange_bucket(wire: Wire, flat: torch.Tensor, seed: int,
                    residual: Optional[torch.Tensor] = None):
    """One bucket's collective on its flat buffer: ``(reduced,
    new_residual or None)``; ``residual`` (quantized wires) joins the
    signal and the call returns the new carry."""
    if wire.quantized:
        want = residual is not None
        x = flat + residual.to(flat.dtype) if want else flat
        if wire.stages is not None:
            got = traced.hierarchical_allreduce_groups(
                x, op=wire.op, stages=wire.stages,
                intra_wire=wire.hier_intra, inter_wire="int8", seed=seed,
                block_size=wire.block, prescale_factor=wire.prescale,
                return_residual=want)
        else:
            got = traced.quantized_allreduce(
                x, op=wire.op, seed=seed, return_residual=want,
                prescale_factor=wire.prescale, block_size=wire.block,
                groups=wire.groups)
        out, new_r = got if want else (got, None)
        if wire.postscale != 1.0:
            out = out * wire.postscale
        return out, new_r
    sent, ctx = wire.compression.compress(flat)
    if wire.stages is not None:
        red = traced.hierarchical_allreduce_groups(
            sent, op=wire.op, stages=wire.stages,
            prescale_factor=wire.prescale, postscale_factor=wire.postscale)
    else:
        red = traced.allreduce(
            sent, op=wire.op, prescale_factor=wire.prescale,
            postscale_factor=wire.postscale, process_set=wire.process_set,
            mask=wire.mask, groups=wire.groups)
    return wire.compression.decompress(red, ctx), None


def _concat(parts):
    parts = [p.reshape(-1) for p in parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _split(flat, like):
    out, off = [], 0
    for t in like:
        k = t.numel()
        out.append(flat[off:off + k].view(t.shape))
        off += k
    return out


def _flatten(tree):
    return pytree.tree_flatten(tree, is_leaf=lambda x: x is None)


def bucketed_allreduce(grads, op=None, average: Optional[bool] = None,
                       n_buckets: Optional[int] = None,
                       compression: Compressor = Compression.none,
                       prescale_factor: float = 1.0,
                       postscale_factor: float = 1.0,
                       process_set: Optional[ProcessSet] = None,
                       seed: int = 0, residuals=None, mask=None,
                       min_bucket_bytes: Optional[int] = None,
                       schedule: Optional[BucketSchedule] = None,
                       return_finite: bool = False, hier_stages="auto",
                       groups=None):
    """Allreduce a gradient tree as one collective a bucket
    (``overlap.py:331``; module docstring). ``residuals`` (a tree like
    ``grads``, quantized wires): each bucket's carry joins its signal and
    the new carry is sliced back to the leaves, returned after the
    reduced tree. ``return_finite`` appends one device bool, the AND of
    each bucket's ``all(isfinite)`` over its reduced values. None leaves
    pass through. Inside a compiled region the schedule is built at
    trace time, outside the cache and the gauges."""
    op = resolve_op(op, average)
    wire = make_wire(op, compression, prescale_factor, postscale_factor,
                     process_set, mask, groups, hier_stages,
                     residuals is not None)
    if n_buckets is None:
        n_buckets = default_buckets() or 1
    if min_bucket_bytes is None:
        min_bucket_bytes = default_min_bytes()
    leaves, treedef = _flatten(grads)
    if schedule is None:
        if torch.compiler.is_compiling():
            schedule = build_bucket_schedule(leaves, n_buckets,
                                             min_bucket_bytes)
        else:
            schedule = schedule_for(leaves, treedef, n_buckets,
                                    min_bucket_bytes)
    if not torch.compiler.is_compiling():
        _publish(schedule)
    r_leaves = None
    if residuals is not None:
        r_leaves, r_def = _flatten(residuals)
        if r_def != treedef:
            raise ValueError("residuals must have the gradients' structure")
    out = list(leaves)
    res_out = list(r_leaves) if r_leaves is not None else None
    finite = None
    for b, idxs in enumerate(schedule.buckets):
        members = [leaves[i] for i in idxs]
        flat = _concat(members)
        r_flat = (_concat([r_leaves[i].to(flat.dtype) for i in idxs])
                  if r_leaves is not None else None)
        red, new_r = exchange_bucket(wire, flat, seed * schedule.n_buckets
                                     + b, r_flat)
        if return_finite:
            ok = traced.finite_scalar(red)
            finite = ok if finite is None else torch.logical_and(finite, ok)
        for i, piece in zip(idxs, _split(red, members)):
            out[i] = piece
        if new_r is not None:
            for i, piece in zip(idxs, _split(new_r, members)):
                res_out[i] = piece.to(r_leaves[i].dtype)
    reduced = pytree.tree_unflatten(out, treedef)
    if return_finite and finite is None:
        finite = torch.ones((), dtype=torch.bool)
    if residuals is None:
        return (reduced, finite) if return_finite else reduced
    new_res = pytree.tree_unflatten(res_out, treedef)
    return (reduced, new_res, finite) if return_finite else (reduced,
                                                               new_res)


class _Boundary(torch.autograd.Function):
    """One bucket of :func:`overlap_boundary`: identity forward; the
    backward reduces the bucket's gradients as one collective (a member
    without a gradient sends zeros)."""

    @staticmethod
    def forward(ctx, wire, seed, *members):
        ctx.wire, ctx.seed = wire, seed
        ctx.shapes = [m.shape for m in members]
        return tuple(m.view_as(m) for m in members)

    @staticmethod
    def backward(ctx, *grads):
        flat = _concat(grads)
        red, _ = exchange_bucket(ctx.wire, flat, ctx.seed)
        return (None, None) + tuple(_split(red, grads))


def overlap_boundary(tree, op=Average, average: Optional[bool] = None,
                     n_buckets: Optional[int] = None,
                     compression: Compressor = Compression.none,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0,
                     process_set: Optional[ProcessSet] = None,
                     seed: int = 0, mask=None,
                     min_bucket_bytes: Optional[int] = None,
                     hier_stages="auto"):
    """The in-backprop boundary (``overlap.py:1063``): returns ``tree``'s
    tensors unchanged on the forward; gradients that flow back through
    them come out reduced, bucket by bucket, one
    ``torch.autograd.Function`` a bucket of the schedule. Pass the
    parameters through it and use what it returns::

        params = hvd.overlap_boundary(dict(model.named_parameters()),
                                      n_buckets=4)
        loss = loss_fn(torch.func.functional_call(model, params, batch))
    """
    op = resolve_op(op, average)
    wire = make_wire(op, compression, prescale_factor, postscale_factor,
                     process_set, mask, None, hier_stages)
    if n_buckets is None:
        n_buckets = default_buckets() or 1
    if min_bucket_bytes is None:
        min_bucket_bytes = default_min_bytes()
    leaves, treedef = _flatten(tree)
    schedule = schedule_for(leaves, treedef, n_buckets, min_bucket_bytes)
    _publish(schedule)
    out = list(leaves)
    for b, idxs in enumerate(schedule.buckets):
        got = _Boundary.apply(wire, seed * schedule.n_buckets + b,
                              *[leaves[i] for i in idxs])
        for i, t in zip(idxs, got):
            out[i] = t
    return pytree.tree_unflatten(out, treedef)
