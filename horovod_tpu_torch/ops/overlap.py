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

- :func:`bucketed_reduce_scatter` and :func:`bucketed_shard_all_gather`
  are ZeRO's legs (``overlap.py:691-1062``): each bucket's members are
  flattened, zero-padded and cut into ``[n, cols]`` panes
  (``parallel/fsdp.py``), concatenated column-wise, and ONE
  reduce-scatter (or all-gather) a bucket moves them, so this rank's
  output slice of a bucket IS the members' shard slices. A 0-d tensor is
  allreduced whole. Each leg rides fp32, a bf16 cast or the block-scaled
  int8 wire (``traced.quantized_reducescatter``/``_allgather``, B3),
  with error-feedback residuals, ``groups=`` and, when ``hier_stages``
  resolves, the two-level ``traced.hierarchical_reducescatter``/
  ``_allgather`` (int8 on the inter hop only); a leg with residuals
  always rides the flat wire. A matched pair shares one cached
  schedule. :func:`leg_stats` counts their collectives.

- ``wire="auto"`` (``overlap.py:623-690``) resolves a leg's wire a
  bucket through :func:`resolve_wire`: under
  ``HOROVOD_FUSION_WIRE_MIN_BYTES`` fp32; above it the shared
  :func:`wire_tuner`'s goodput argmax where it holds measurements for
  the bucket's key, else int8 for 4-byte payloads. Nothing in the port
  feeds the shared tuner yet (nor in the JAX package), so without
  measurements in ``HOROVOD_TUNER_CACHE`` this is a fixed prior, int8
  above the floor, not a tuned choice. The tuner starts from the
  world's agreed state (``autotune.adopt``), so every rank resolves the
  same wires. The bucket count has its own tuner,
  :func:`~..common.autotune.OverlapTuner`, which
  ``DistributedOptimizer(overlap_buckets="auto")`` drives.

With ``HOROVOD_EXE_CACHE`` set, :func:`schedule_for` persists each
partition it builds in the cache's ``overlap_schedule`` sidecar
(``common/exe_cache.py``, the JAX package's ``overlap.py:104-157``), and
a fresh process (a restarted worker) replays a recorded partition
verbatim instead of re-deriving it, so a change of the balancing rule
does not move a persisted schedule (``schedule_cache_stats()
["disk_hits"]``).
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
from ..parallel.fsdp import pad_to
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
_STATS = {"hits": 0, "misses": 0, "disk_hits": 0}

# the HOROVOD_EXE_CACHE sidecar holding the partitions built (module
# docstring)
_SIDECAR = "overlap_schedule"


def schedule_cache_stats() -> dict:
    return dict(_STATS, size=len(_CACHE))


def reset_schedule_cache() -> None:
    _CACHE.clear()
    for k in _STATS:
        _STATS[k] = 0


def _sidecar_key(key: tuple) -> str:
    import hashlib

    return hashlib.sha256(repr(key).encode()).hexdigest()[:24]


def _schedule_from_record(rec) -> Optional[BucketSchedule]:
    """A sidecar record as a schedule; None when malformed (a corrupt
    record reads as a rebuild)."""
    try:
        return BucketSchedule(
            buckets=tuple(tuple(int(i) for i in b) for b in rec["buckets"]),
            bucket_bytes=tuple(int(b) for b in rec["bucket_bytes"]),
            total_bytes=int(rec["total_bytes"]),
            passthrough=tuple(int(i) for i in rec.get("passthrough", ())),
        )
    except (KeyError, TypeError, ValueError):
        return None


def _schedule_record(key: tuple, sched: BucketSchedule) -> dict:
    """The sidecar's record, the JAX package's fields."""
    return {
        "buckets": [list(b) for b in sched.buckets],
        "bucket_bytes": list(sched.bucket_bytes),
        "total_bytes": int(sched.total_bytes),
        "passthrough": list(sched.passthrough),
        "n_leaves": sum(len(b) for b in sched.buckets)
        + len(sched.passthrough),
        "n_buckets": int(key[2]),
        "min_bucket_bytes": int(key[3]),
    }


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
    leaves' shapes and dtypes and the knobs, counting hits and misses;
    with ``HOROVOD_EXE_CACHE`` set, a miss first replays the sidecar's
    record (``disk_hits``) and a build is persisted there."""
    from ..common import exe_cache

    key = (str(treedef), tuple(_leaf_key(leaf) for leaf in leaves),
           int(n_buckets), int(min_bucket_bytes))
    sched = _CACHE.get(key)
    if sched is not None:
        _STATS["hits"] += 1
        return sched
    _STATS["misses"] += 1
    disk = exe_cache.cache_dir()
    if disk:
        rec = exe_cache.load_json(_SIDECAR).get(_sidecar_key(key))
        sched = None if rec is None else _schedule_from_record(rec)
        if sched is not None:
            _STATS["disk_hits"] += 1
    if sched is None:
        sched = build_bucket_schedule(leaves, n_buckets, min_bucket_bytes)
        if disk:
            exe_cache.persist_json(
                _SIDECAR, {_sidecar_key(key): _schedule_record(key, sched)})
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


# ------------------------------------------- the sharded (ZeRO) legs

_LEGS = {"reduce_scatter": 0, "all_gather": 0}


def leg_stats() -> dict:
    """Collectives the sharded legs issued (one a bucket, one a leaf on
    a per-leaf fallback), since the last :func:`reset_leg_stats`."""
    return dict(_LEGS)


def reset_leg_stats() -> None:
    for k in _LEGS:
        _LEGS[k] = 0


def wire_tuner():
    """The process-wide WireTuner ``wire='auto'`` buckets consult
    (``autotune.shared_wire_tuner``). A step harness that feeds its
    ``record`` must record readings agreed over the leg's group, under
    ``autotune.group_key`` (``common/autotune.py``'s last section); none
    does yet."""
    from ..common.autotune import shared_wire_tuner

    return shared_wire_tuner()


def resolve_wire(wire, bucket_bytes: int = 0, itemsize: int = 4, key=None,
                 hop=None) -> str:
    """A bucket's wire format, fp32, bf16 or int8 (``overlap.py:641``).
    Explicit formats pass through (int8 never rides the intra hop);
    ``auto``: fp32 under the tuner's floor, else the tuner's goodput
    argmax where it has measured this bucket's key, else int8 for 4-byte
    payloads. ``hop`` (``"intra"``/``"inter"``) splits the key per hop;
    the intra menu is fp32 and bf16."""
    if wire in (None, "fp32"):
        return "fp32"
    if wire in ("bf16", "int8"):
        if hop == "intra" and wire == "int8":
            return "fp32"
        return wire
    if wire == "auto":
        tuner = wire_tuner()
        if int(bucket_bytes) < tuner.min_int8_bytes:
            return "fp32"
        candidates = (("fp32", "bf16") if hop == "intra"
                      else tuner.CANDIDATES)
        key = key if key is not None else ("bucket", int(bucket_bytes))
        if hop is not None:
            key = tuple(key) + (hop,)
        if any(tuner.goodput(key, c) > 0 for c in candidates):
            return tuner.choose(key, int(bucket_bytes), itemsize=itemsize,
                                candidates=candidates)
        if "int8" in candidates and itemsize >= 4:
            return "int8"
        return "fp32"
    raise ValueError(f"unknown wire format {wire!r}")


def _leaf_panes(leaf: torch.Tensor, n: int) -> torch.Tensor:
    """One tensor's rank-major panes: flatten, zero-pad, ``[n, cols]``."""
    return pad_to(leaf.reshape(-1), n).view(n, -(-leaf.numel() // n))


def _leg_route(groups, hier_stages, residuals):
    """(process group, its size, the two-level stages or None) of a
    sharded leg: ``groups`` keeps each collective within its group and
    has no inter hop; a leg with residuals rides the flat wire, whose
    quantization its carry is defined against."""
    if groups is not None:
        group, _, n = traced._mine(groups)
        return group, n, None
    n = dist.get_world_size()
    stages = None if residuals is not None else _auto_stages(hier_stages, n)
    return dist.group.WORLD, n, stages


def _bucket_schedule(leaves, treedef, n_buckets, min_bucket_bytes):
    if n_buckets is None:
        n_buckets = default_buckets() or 1
    if min_bucket_bytes is None:
        min_bucket_bytes = default_min_bytes()
    return schedule_for(leaves, treedef, n_buckets, min_bucket_bytes)


def _rs_bucket(members, residuals, n: int, group, stages, bw: str, op,
               seed: int, block: Optional[int], groups=None):
    """One bucket of the reduce-scatter leg: the members' ``[n, cols]``
    panes concatenated column-wise (plus their residuals', in input
    units), one collective, and this rank's ``[cols]`` slice of each
    member; returns ``(shards, new residuals or None)``, the residuals in
    the members' geometry."""
    buf = torch.cat([_leaf_panes(m, n) for m in members], dim=1)
    if residuals is not None:
        buf = buf + torch.cat([_leaf_panes(r.to(buf.dtype), n)
                               for r in residuals], dim=1)
    new_r = None
    if stages is not None:
        red = traced.hierarchical_reducescatter(
            buf, op=op, stages=stages,
            intra_wire="bf16" if bw == "bf16" else "fp32", inter_wire=bw,
            seed=seed, block_size=block)
    elif bw == "int8":
        got = traced.quantized_reducescatter(
            buf, op=Sum, seed=seed, block_size=block,
            return_residual=residuals is not None, groups=groups)
        red, new_r = got if residuals is not None else (got, None)
        red = traced._scale_static(red, n, op, 1.0)
    else:
        sent = buf.to(torch.bfloat16) if bw == "bf16" else buf
        red = traced._reduce_scatter(sent, 0, group).reshape(-1).to(
            buf.dtype)
        red = traced._scale_static(red, n, op, 1.0)
        if residuals is not None:
            # the exact wire sends everything; bf16 carries its cast
            new_r = (buf - sent.to(buf.dtype) if bw == "bf16"
                     else torch.zeros_like(buf))
    _LEGS["reduce_scatter"] += 1
    shards, res_out, off = [], [], 0
    for i, m in enumerate(members):
        c = -(-m.numel() // n)
        shards.append(red[off:off + c].to(m.dtype))
        if new_r is not None:
            res_out.append(new_r[:, off:off + c].reshape(-1)[
                :m.numel()].view(m.shape).to(residuals[i].dtype))
        off += c
    return shards, (res_out if new_r is not None else None)


def _ag_bucket(shards, residuals, like, n: int, group, stages, bw: str,
               seed: int, block: Optional[int], groups=None):
    """One bucket of the all-gather leg: the members' shards
    concatenated (plus their residuals), one collective, and each
    member's full tensor (``like``'s shape, the shard's dtype); returns
    ``(full tensors, new residuals or None)``, the residuals in shard
    geometry."""
    buf = _concat(shards)
    if residuals is not None:
        buf = buf + _concat([r.to(buf.dtype) for r in residuals])
    new_r = None
    if stages is not None:
        full = traced.hierarchical_allgather(
            buf, stages=stages,
            intra_wire="bf16" if bw == "bf16" else "fp32", inter_wire=bw,
            seed=seed, block_size=block)
    elif bw == "int8":
        got = traced.quantized_allgather(
            buf, seed=seed, block_size=block,
            return_residual=residuals is not None, groups=groups)
        full, new_r = got if residuals is not None else (got, None)
    else:
        sent = buf.to(torch.bfloat16) if bw == "bf16" else buf
        full = traced._all_gather(sent, group).view(n, -1).to(buf.dtype)
        if residuals is not None:
            new_r = (buf - sent.to(buf.dtype) if bw == "bf16"
                     else torch.zeros_like(buf))
    _LEGS["all_gather"] += 1
    out, res_out, off = [], [], 0
    for i, (sh, lk) in enumerate(zip(shards, like)):
        c = sh.shape[0]
        piece = full[:, off:off + c].reshape(-1)[:lk.numel()].view(lk.shape)
        if piece.storage_offset():
            # one rank's slice is a view into the bucket: a tensor of its
            # own, aligned as the model's would be (a kernel may take
            # another path, and round otherwise, on a misaligned base)
            piece = piece.clone()
        out.append(piece.to(sh.dtype))
        if new_r is not None:
            res_out.append(new_r[off:off + c].to(residuals[i].dtype))
        off += c
    return out, (res_out if new_r is not None else None)


def bucketed_reduce_scatter(grads, op=None, average: Optional[bool] = None,
                            n_buckets: Optional[int] = None,
                            wire: str = "fp32",
                            wire_block: Optional[int] = None, seed: int = 0,
                            residuals=None,
                            min_bucket_bytes: Optional[int] = None,
                            schedule: Optional[BucketSchedule] = None,
                            hier_stages="auto", groups=None):
    """Reduce-scatter a gradient tree as one collective a bucket
    (``overlap.py:698``), returning each tensor's SHARD: its ``[cols]``
    slice, ``cols = ceil(size / n)``, of the reduced flat tensor (a 0-d
    tensor reduced whole; None passes through). Elementwise the same
    sums as a per-tensor reduce-scatter, so on the fp32 wire the shards
    are those bits.

    ``groups`` keeps every collective within its group: panes are ``[L,
    cols]``, rank r receives the shard of its position in its group, and
    Average divides by L. ``wire`` bf16 casts the pane buffer; int8
    rides :func:`traced.quantized_reducescatter` with ``wire_block``
    scales and a seed a bucket. ``residuals`` (a tree like ``grads``, in
    input units) joins each pane buffer before the wire; the new carry
    comes back in the tensors' geometry, after the shards (zero on the
    exact wire). ``hier_stages`` (``"auto"``: ``HOROVOD_HIERARCHICAL``)
    routes each bucket through :func:`traced.hierarchical_reducescatter`,
    int8 on the inter hop only."""
    op = resolve_op(op, average)
    if op not in (Sum, Average):
        raise ValueError("bucketed_reduce_scatter supports op=Sum/Average "
                         "only")
    resolve_wire(wire, 0)  # an unknown format raises before any exchange
    group, n, stages = _leg_route(groups, hier_stages, residuals)
    leaves, treedef = _flatten(grads)
    nonscalar = [i for i, g in enumerate(leaves)
                 if g is not None and g.dim() > 0]
    if schedule is None:
        schedule = _bucket_schedule([leaves[i] for i in nonscalar], treedef,
                                    n_buckets, min_bucket_bytes)
    _publish(schedule)
    r_leaves = None
    if residuals is not None:
        r_leaves, r_def = _flatten(residuals)
        if r_def != treedef:
            raise ValueError("residuals must have the gradients' structure")
    out = list(leaves)
    res_out = list(r_leaves) if r_leaves is not None else None
    for i, g in enumerate(leaves):
        if g is not None and g.dim() == 0 and g.is_floating_point():
            out[i] = traced.allreduce(g, op=op, groups=groups)
    for b, idxs in enumerate(schedule.buckets):
        ids = [nonscalar[j] for j in idxs]
        bw = resolve_wire(wire, schedule.bucket_bytes[b],
                          leaves[ids[0]].element_size())
        got, new_r = _rs_bucket(
            [leaves[i] for i in ids],
            None if r_leaves is None else [r_leaves[i] for i in ids],
            n, group, stages, bw, op, seed * schedule.n_buckets + b,
            wire_block, groups)
        for k, i in enumerate(ids):
            out[i] = got[k]
            if new_r is not None:
                res_out[i] = new_r[k]
    shards = pytree.tree_unflatten(out, treedef)
    if residuals is None:
        return shards
    return shards, pytree.tree_unflatten(res_out, treedef)


def bucketed_shard_all_gather(shards, like,
                              n_buckets: Optional[int] = None,
                              wire: str = "fp32",
                              wire_block: Optional[int] = None,
                              seed: int = 0, residuals=None,
                              min_bucket_bytes: Optional[int] = None,
                              schedule: Optional[BucketSchedule] = None,
                              hier_stages="auto", groups=None):
    """The dual of :func:`bucketed_reduce_scatter` (``overlap.py:891``):
    each tensor's ``[cols]`` shard → the full tensor of ``like``'s shape
    (only shapes and dtypes are read from ``like``), one all-gather a
    bucket. The schedule is keyed on ``like``'s full geometry, so a
    matched pair of legs shares one cached schedule. ``residuals`` (a
    tree in SHARD geometry) joins each bucket's shards before a lossy
    wire and the new carry comes back after the full tree. A bucket whose
    shards have more than one dtype gathers them one by one, exactly.
    The int8 wire hands every rank, the owner too, the dequantized
    values, so the replicas stay bitwise equal."""
    resolve_wire(wire, 0)
    group, n, stages = _leg_route(groups, hier_stages, residuals)
    s_leaves, s_def = _flatten(shards)
    l_leaves, l_def = _flatten(like)
    if l_def != s_def:
        raise ValueError("like must have the shards' structure")
    nonscalar = [i for i, leaf in enumerate(l_leaves)
                 if leaf is not None and leaf.dim() > 0
                 and s_leaves[i] is not None]
    if schedule is None:
        schedule = _bucket_schedule([l_leaves[i] for i in nonscalar], s_def,
                                    n_buckets, min_bucket_bytes)
    r_leaves = None
    if residuals is not None:
        r_leaves, r_def = _flatten(residuals)
        if r_def != s_def:
            raise ValueError("residuals must have the shards' structure")
    out = list(s_leaves)
    res_out = list(r_leaves) if r_leaves is not None else None
    for b, idxs in enumerate(schedule.buckets):
        ids = [nonscalar[j] for j in idxs]
        if len({s_leaves[i].dtype for i in ids}) > 1:
            for i in ids:
                full = traced._all_gather(s_leaves[i], group)
                out[i] = full[:l_leaves[i].numel()].view(l_leaves[i].shape)
                _LEGS["all_gather"] += 1
            continue
        bw = resolve_wire(wire, schedule.bucket_bytes[b],
                          l_leaves[ids[0]].element_size())
        got, new_r = _ag_bucket(
            [s_leaves[i] for i in ids],
            None if r_leaves is None else [r_leaves[i] for i in ids],
            [l_leaves[i] for i in ids], n, group, stages, bw,
            seed * schedule.n_buckets + b, wire_block, groups)
        for k, i in enumerate(ids):
            out[i] = got[k]
            if new_r is not None:
                res_out[i] = new_r[k]
    gathered = pytree.tree_unflatten(out, s_def)
    if residuals is None:
        return gathered
    return gathered, pytree.tree_unflatten(res_out, s_def)
