"""ZeRO: a data-parallel optimizer whose optimizer state, gradients and
parameters are sharded over the world.

The counterpart of ``horovod_tpu/sharded_optimizer.py``
(``ShardedDistributedOptimizer``, stages 1–3), in PyTorch's idiom: it
wraps a ``torch.optim`` optimizer built over the model's parameters, as
``DistributedOptimizer`` does, and rebuilds it over this rank's flat
shards (``type(inner)(shards, **options)``, the options of its one
param group). Every tensor that is not 0-d is flattened,
zero-padded to a multiple of the world size and cut rank-major
(``parallel/fsdp.py``); rank r owns slice r, ``cols = ceil(size / n)``;
a 0-d tensor is replicated and allreduced whole.

- ``zero_stage=1``: ``loss.backward(); opt.step()``. ``step()``
  reduce-scatters the gradients through the bucketed leg
  (``ops/overlap.py``, one collective a bucket; ``overlap_buckets=0``
  on the fp32 wire: one a tensor), steps the inner optimizer on this
  rank's shards (cut from the parameters at each step, so a parameter
  loaded or broadcast after construction is what is stepped), and
  all-gathers back into the model's parameters. Optimizer state is 1/N
  a rank.
- ``zero_stage=2``: the same ``backward()``/``step()`` contract, with
  the gradients sharded too: a ``register_post_accumulate_grad_hook``
  a parameter counts each bucket's arrivals, and the bucket's
  reduce-scatter is issued the moment its last gradient arrives (on a
  side stream on the card), after which its members' ``.grad`` are
  freed (``record_stream``). At ``step()`` only the shard buffers are
  left, no full-gradient tree.
- ``zero_stage=3``: between steps the wrapper holds only the flat
  shards; the model's parameters keep their shapes but no storage.
  ``loss, grads = opt.value_and_grad(fn, model)(*args)`` gathers each
  bucket through one ``torch.autograd.Function`` (forward: the
  all-gather leg; backward: the reduce-scatter leg, so the gradients
  land in shard geometry), runs ``fn`` on the model reparametrized with
  the gathered tensors, held over backward so that a remat recompute
  reads them too, and returns the loss and the shard gradients;
  ``step()`` then updates the shards with no collective.
  ``gather_params(model)`` gathers for evaluation and
  ``unshard_params()`` writes the full parameters back into the model
  (export); the next ``value_and_grad`` frees them again.

The fp32 wire gathers the new shards, which gives the bits of the JAX
package's ``p + u``. On bf16 and int8 (``wire=``) the gathered quantity
is the update: a bf16 parameter would lose its precision, and an int8
quantum scaled to the parameter is far larger than one scaled to the
update. ``torch.optim`` steps in place, so the update is taken as the
new shard minus the old, ``fl(fl(p + u) − p)``: it differs from the JAX
package's ``u`` by the rounding of ``p + u`` (at most half an ulp of the
parameter; the subtraction is exact where ``p + u`` and ``p`` are within
a factor 2). Every rank, the owner too, adds the dequantized update to
its parameters, and the owner's shard is reset to that value, so the
replicas stay bitwise equal (``traced.quantized_allgather``'s contract).

Options (the JAX constructor's): ``op``/``average`` (Sum or Average),
``zero_stage`` (None: ``HOROVOD_ZERO_STAGE``), ``wire`` (None:
``HOROVOD_ZERO_WIRE``, never ``HOROVOD_FUSION_WIRE``; ``auto`` raises
naming ROADMAP A12), ``wire_block`` (None: ``HOROVOD_FUSION_WIRE_BLOCK``),
``error_feedback`` (stages 1–2, ``wire="int8"``: ``rs`` residuals in
full-gradient geometry, ``ag`` residuals in shard geometry, a wire seed
a step; padding holds a zero residual), ``overlap_buckets``/
``overlap_min_bytes`` (None: ``HOROVOD_OVERLAP*``; stage 3 floors at 1),
``hierarchical`` (None: ``HOROVOD_HIERARCHICAL``; each bucket takes an
intra reduce-scatter, the inter hop on the 1/L panes and an intra
all-gather, int8 on the inter hop only; a leg with residuals stays
flat; False pins the flat wire), ``grad_guard``/``guard_max_skips``
(None: ``HOROVOD_GUARD*``: one scalar all-reduce a step agrees the skip,
since a NaN lands in one rank's shard only; a skipped step leaves the
parameters, the inner state and the residuals bitwise as they were).

Local SGD (``local_sgd_steps=K > 1``, None: ``HOROVOD_LOCAL_SGD_STEPS``;
``horovod_tpu/sharded_optimizer.py:349-379,442-456,996-1110``), stages 1–2
only (stage 3 shards the parameters over the world, so a slice could not
hold its own model): the split is ``local_sgd.resolve_stages(size,
local_sgd_intra)`` and the shard width is the slice's L ranks, rank r
holding chunk ``r % L``, so each slice's ranks hold one copy of its
moments. Every leg, the 0-d allreduce and the guard's agreement run
within the intra group. ``sync_round()`` merges each slice's delta since
the last round across slices: the intra-position chunk of the
parameters minus the anchor chunk (a 0-d parameter rides at position 0
only), through ``local_sgd.adasum_sync_shard`` on
``local_sgd_inter_wire``, then the new anchor chunks are allgathered
within the slice into the parameters. The ``"local"`` state family holds
the anchor chunks, the int8 wire's residual, the round count and the
width L.

A parameter with no gradient in a step is sent as zeros (the buckets'
shapes must match across ranks), sends no residual and keeps its
carried one, and its shard's ``.grad`` stays None, so the inner
optimizer leaves it alone, as ``DistributedOptimizer`` does. The choice
is each rank's own: a parameter used on some ranks and not on others is
outside the contract.

Only elementwise inner optimizers shard correctly. Construction runs
the JAX package's differential probe (``:110-208``) on the inner
optimizer's class and defaults: three steps on a fixed three-leaf tree
(one leaf 128 × 128), once whole and once cut in two shards; a mismatch
raises. ``HOROVOD_SHARDED_OPT_PROBE=0`` skips it.

State: ``state_dict()`` is this rank's shard of the inner state, the
residuals, the wire seed, the guard counters and the ``"local"`` family;
``reshard_state(states, new_world)`` takes every rank's state of one
world to a new world, and ``reshard_params(shards, new_world)`` does the
same for stage 3's ``param_shards()``, through
``parallel.fsdp.reshard_rows`` (every value bit for bit; the ``rs``
residuals keep their total, on rank 0). Where a local-SGD split is on
either side, the rows are re-cut from slice 0's chunks at the new
width, as the JAX package does (the slices' moments diverged; the new
slices start from slice 0's).
"""

from __future__ import annotations

import contextlib
import copy
import inspect
import os
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.nn.utils import stateless
from torch.profiler import record_function

from . import local_sgd
from .common import basics
from .common import guard as _guard
from .ops import overlap, traced
from .ops._collectives import gather_into
from .ops.reduction_ops import Average, Sum, resolve_op
from .parallel import fsdp

_WIRE_FORMATS = ("fp32", "bf16", "int8", "auto")

_NOT_ELEMENTWISE = (
    "ShardedDistributedOptimizer: the inner optimizer is not elementwise "
    "— its update changes when gradients are sharded (differential probe "
    "mismatch). Norm-based steps (gradient clipping by a global norm, "
    "factored second moments, ...) would compute shard-LOCAL statistics "
    "and silently train wrong. Clip the FULL gradients before step() "
    "instead, e.g.:\n"
    "    loss.backward()\n"
    "    torch.nn.utils.clip_grad_norm_(model.parameters(), max_norm)\n"
    "    sharded_opt.step()\n"
    "or set HOROVOD_SHARDED_OPT_PROBE=0 to accept the risk for an "
    "optimizer the probe cannot compare (e.g. stochastic noise)."
)


def _build(cls, params, options: dict):
    """``cls(params, **options)``, with the options its constructor does
    not name (``AdamW``'s defaults carry ``decoupled_weight_decay``)
    written into the param group after."""
    sig = inspect.signature(cls.__init__).parameters
    named = any(p.kind == p.VAR_KEYWORD for p in sig.values())
    opt = cls(params, **{k: v for k, v in options.items()
                         if named or k in sig})
    opt.param_groups[0].update(options)
    return opt


def _probe_nonelementwise(cls, defaults) -> bool:
    """Does the optimizer ``cls(params, **defaults)`` step differently
    when its parameters are sharded? Three steps on a fixed tree, once
    whole and once cut in two flat shards, with gradients whose shard
    norms shift every step (a global-norm clip at any common threshold
    fires); the 128 × 128 leaf catches steps that factor 2-D tensors.
    True on a mismatch; False when they match or the optimizer rejects
    the probe's shapes (the docstring's contract then holds)."""
    det = np.linspace(-1.0, 1.0, 128 * 128, dtype=np.float32)
    t = torch.tensor
    params = [t([1.0, -2.0, 3.0, -4.0]), t([0.5, 0.25]),
              torch.from_numpy(det.reshape(128, 128).copy())]
    gm = torch.from_numpy((det + np.float32(0.37)).reshape(128, 128))
    half = torch.cat([torch.full((64, 128), 0.05), torch.full((64, 128),
                                                              6.0)])
    steps = [
        [t([6.0, -8.0, 0.5, 2.0]), t([-3.0, 1.5]), gm * 3.0],
        [t([0.1, 0.2, 9.0, -7.0]), t([4.0, -0.05]), gm * half],
        [t([-5.0, 0.3, 0.4, 6.0]), t([0.2, -8.0]), gm * half.flip(0)],
    ]

    def run(ps, grads_of):
        opt = _build(cls, ps, defaults)
        seen = []
        for step in steps:
            for p, g in zip(ps, grads_of(step)):
                p.grad = g.clone()  # a step may scale it in place
            opt.step()
            seen.append([p.detach().clone() for p in ps])
        return seen

    try:
        whole = run([p.clone() for p in params], lambda s: s)
        halves = [run([p.reshape(2, -1)[r].clone() for p in params],
                      lambda s, r=r: [g.reshape(2, -1)[r] for g in s])
                  for r in range(2)]
    except Exception:
        return False  # shapes the optimizer rejects: the docstring's contract
    for k, full in enumerate(whole):
        for i, a in enumerate(full):
            b = torch.cat([halves[0][k][i], halves[1][k][i]])
            if not torch.allclose(a.reshape(-1), b, rtol=1e-5, atol=1e-6):
                return True
    return False


class _Gather(torch.autograd.Function):
    """Stage 3's boundary for one bucket: the forward all-gathers the
    members' shards into full tensors; the backward reduce-scatters their
    gradients into shard geometry (a member without a gradient sends
    zeros and gets None)."""

    @staticmethod
    def forward(ctx, opt, b, step, *shards):
        ctx.opt, ctx.b, ctx.step = opt, b, step
        ctx.set_materialize_grads(False)
        full, _ = opt._gather_bucket(b, list(shards), step)
        return tuple(full)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None) + tuple(
            ctx.opt._scatter_bucket(ctx.b, list(grads), ctx.step))


class ShardedDistributedOptimizer:
    """``torch.optim`` wrapper with reduce-scatter/all-gather weight
    update and ZeRO stages 1–3 (module docstring)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters=None, op=None,
                 average: Optional[bool] = None,
                 zero_stage: Optional[int] = None,
                 wire: Optional[str] = None,
                 wire_block: Optional[int] = None,
                 error_feedback: bool = False,
                 overlap_buckets: Optional[int] = None,
                 overlap_min_bytes: Optional[int] = None,
                 hierarchical: Optional[bool] = None,
                 grad_guard: Optional[bool] = None,
                 guard_max_skips: Optional[int] = None,
                 local_sgd_steps: Optional[int] = None,
                 local_sgd_inter_wire: str = "int8",
                 local_sgd_intra: Optional[int] = None):
        st = basics._require_init()
        self._op = resolve_op(op, average)
        if self._op not in (Sum, Average):
            raise NotImplementedError(
                "ShardedDistributedOptimizer supports op=Sum/Average "
                "(Adasum's recursive combine needs full gradients)")
        cfg = st.config
        self._stage = int(cfg.zero_stage if zero_stage is None
                          else zero_stage)
        if self._stage not in (1, 2, 3):
            raise ValueError(
                f"zero_stage must be 1, 2 or 3, got {self._stage}")
        wire = cfg.zero_wire if wire is None else wire
        if wire not in _WIRE_FORMATS:
            raise ValueError(
                f"wire must be one of {_WIRE_FORMATS}, got {wire!r}")
        self._wire = overlap.resolve_wire(wire)  # auto: A12
        self._block = int(cfg.fusion_wire_block if wire_block is None
                          else wire_block)
        self._hier = None if hierarchical is False else "auto"
        k = local_sgd.engaged_steps(local_sgd_steps)
        self.local_sgd_steps = max(k, 1)
        self._local_wire = local_sgd_inter_wire
        self._local_intra = local_sgd_intra
        self._local_stages = None
        if k > 1:
            if self._stage >= 3:
                raise NotImplementedError(
                    "local_sgd_steps composes with zero_stage<=2 only: "
                    "stage-3 parameters shard over the WORLD axis, so "
                    "a slice cannot hold its own model during an "
                    "independent local phase — run stage 1/2, or keep "
                    "every-step sync at stage 3")
            self._local_stages = local_sgd.prepare_split(
                basics.size(), local_sgd_intra, local_sgd_inter_wire)
            self._hier = None  # the local phase has no inter hop
        # the intra groups every exchange names under local SGD
        self._local = (None if self._local_stages is None
                       else self._local_stages[0])
        self._ef = bool(error_feedback)
        if self._ef and self._wire != "int8":
            raise ValueError(
                "error_feedback requires a quantized wire (wire='int8'); "
                "fp32/bf16 residuals drain to the exact cast error and buy "
                "nothing")
        if self._ef and self._stage >= 3:
            raise ValueError(
                "error_feedback composes with zero_stage<=2 only: the "
                "stage-3 gather/scatter boundary is stateless and cannot "
                "thread residual carries; run stage 3 with wire='fp32'/"
                "'bf16' or plain int8")
        buckets = (overlap.default_buckets() if overlap_buckets is None
                   else int(overlap_buckets))
        if buckets < 0:
            raise ValueError(f"overlap_buckets must be >= 0, got {buckets}")
        if self._stage >= 3:
            buckets = max(buckets, 1)  # the schedule is the gather plan
        min_bytes = (overlap.default_min_bytes() if overlap_min_bytes is None
                     else int(overlap_min_bytes))
        self._guard = (_guard.default_enabled() if grad_guard is None
                       else bool(grad_guard))
        self._max_skips = (_guard.default_max_skips() if guard_max_skips
                           is None else int(guard_max_skips))
        if len(optimizer.param_groups) != 1:
            raise ValueError(
                "ShardedDistributedOptimizer takes an optimizer with one "
                f"param group, got {len(optimizer.param_groups)}")
        if os.environ.get("HOROVOD_SHARDED_OPT_PROBE", "1").strip().lower(
        ) not in ("0", "false") and _probe_nonelementwise(
                type(optimizer), optimizer.defaults):
            raise ValueError(_NOT_ELEMENTWISE)

        group = optimizer.param_groups[0]
        self._params: List[torch.nn.Parameter] = [
            p for p in group["params"] if p.requires_grad]
        names = dict((id(p), n) for n, p in named_parameters or ())
        self._names = [names.get(id(p), f"param.{i}")
                       for i, p in enumerate(self._params)]
        self._index = {id(p): i for i, p in enumerate(self._params)}
        self._n, self._r = basics.size(), basics.rank()
        # the shard geometry: the world, or the slice under local SGD
        self._w, self._pos = self._n, self._r
        if self._local is not None:
            _, self._pos, self._w = traced._mine(self._local)
        w, pos = self._w, self._pos
        with torch.no_grad():
            self._shards = [
                (p.detach().clone() if p.dim() == 0
                 else fsdp.host_shard(p.detach(), w, pos).clone()
                 ).requires_grad_(True)
                for p in self._params]
        self._inner = _build(type(optimizer), self._shards, {
            k: v for k, v in group.items() if k != "params"})

        self._scalars = [i for i, p in enumerate(self._params)
                         if p.dim() == 0]
        self._nonscalar = [i for i, p in enumerate(self._params)
                           if p.dim() > 0]
        leaves = [self._params[i] for i in self._nonscalar]
        if buckets == 0 and self._wire == "fp32":
            self._schedule = _per_tensor_schedule(leaves)  # as JAX: per leaf
        else:
            self._schedule = overlap.schedule_for(
                leaves, f"ShardedDistributedOptimizer[{len(leaves)}]",
                max(buckets, 1), min_bytes)
        overlap._publish(self._schedule)
        self._members = [[self._nonscalar[j] for j in idxs]
                         for idxs in self._schedule.buckets]
        self._bucket_of = {i: b for b, ids in enumerate(self._members)
                           for i in ids}
        # every leg of this optimizer takes one route: residuals pin flat
        self._group, _, self._stages = overlap._leg_route(
            self._local, self._hier, True if self._ef else None)
        dev = self._params[0].device if self._params else torch.device("cpu")
        self._device = dev
        self._stream = torch.cuda.Stream(dev) if (
            dev.type == "cuda" and self._stage == 2) else None

        self._wire_step = 0  # the wire's seed, advanced every step
        self._skips = self._streak = self._updates = 0
        self._rs_res: Dict[int, torch.Tensor] = {}
        self._ag_res: Dict[int, torch.Tensor] = {}
        if self._ef:
            self._rs_res = {i: torch.zeros_like(p)
                            for i, p in enumerate(self._params)}
            self._ag_res = {i: torch.zeros_like(s)
                            for i, s in enumerate(self._shards)}
        # local SGD's round state: the anchor chunks (the parameters at
        # the last round, in shard geometry), the int8 wire's residual,
        # the round count (the round's seed)
        self._anchor: List[torch.Tensor] = []
        self._local_res: Optional[List[torch.Tensor]] = None
        self._round = 0
        if self._local is not None:
            self._anchor = [s.detach().clone() for s in self._shards]
            if self._local_wire == "int8":
                self._local_res = [torch.zeros_like(a) for a in self._anchor]
        self._arrived = [set() for _ in self._members]
        self._flight: Dict[int, tuple] = {}
        self._pending_rs: Dict[int, torch.Tensor] = {}
        self._seen: set = set()
        self._hooks = []
        if self._stage == 2:
            self._hooks = [p.register_post_accumulate_grad_hook(self._hook)
                           for p in self._params]
        if self._stage == 3:
            for p in self._params:
                _free(p)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._inner, name)

    @property
    def schedule(self) -> overlap.BucketSchedule:
        """The bucket schedule of both legs, over the parameters that
        are not 0-d, in parameter order."""
        return self._schedule

    # ------------------------------------------------ the exchange legs

    def _seed(self, b: int, step: Optional[int] = None) -> int:
        step = self._wire_step if step is None else step
        return step * self._schedule.n_buckets + b

    def _rs(self, grads, residuals, seed: int):
        return overlap._rs_bucket(
            grads, residuals, self._w, self._group, self._stages,
            self._wire, self._op, seed, self._block, self._local)

    def _ag(self, b: int, shards, residuals, seed: int):
        return overlap._ag_bucket(
            shards, residuals, [self._params[i] for i in self._members[b]],
            self._w, self._group, self._stages, self._wire, seed,
            self._block, self._local)

    def _gather_bucket(self, b: int, shards, step: int):
        with torch.no_grad(), record_function(f"hvd.zero.gather{b}"):
            return self._ag(b, shards, None, self._seed(b, step))

    def _scatter_bucket(self, b: int, grads, step: int):
        """Stage 3's backward: the bucket's gradients to shard geometry,
        None for a member without a gradient."""
        ids = self._members[b]
        sent = [g if g is not None else torch.zeros(
            self._params[i].shape, dtype=self._params[i].dtype,
            device=self._device) for i, g in zip(ids, grads)]
        with torch.no_grad(), record_function(f"hvd.zero.scatter{b}"):
            got, _ = self._rs(sent, None, self._seed(b, step))
        return [s if g is not None else None for s, g in zip(got, grads)]

    def _hook(self, p: torch.nn.Parameter) -> None:
        key = id(p)
        if key in self._seen:
            raise RuntimeError(
                f"gradient of {self._names[self._index[key]]} produced "
                "again before step(): call step() after every backward "
                "pass")
        self._seen.add(key)
        i = self._index[key]
        b = self._bucket_of.get(i)
        if b is None:
            return  # 0-d: allreduced whole at step()
        self._arrived[b].add(i)
        if len(self._arrived[b]) == len(self._members[b]):
            self._dispatch(b)

    def _dispatch(self, b: int) -> None:
        """Issue bucket ``b``'s reduce-scatter of the step's gradients
        (zeros, and no residual, for a member without one); at stage 2
        the members' gradients are freed once the collective has them."""
        ids = self._members[b]
        members = [self._params[i] for i in ids]
        took = [p.grad is not None for p in members]
        side = self._stream
        if side is not None:
            side.wait_stream(torch.cuda.current_stream(side.device))
        with record_function(f"hvd.zero.rs{b}"), torch.no_grad(), (
                torch.cuda.stream(side) if side is not None
                else contextlib.nullcontext()):
            grads = [p.grad if t else torch.zeros_like(p)
                     for p, t in zip(members, took)]
            res = None
            if self._ef:
                res = [self._rs_res[i] if t else torch.zeros_like(p)
                       for i, p, t in zip(ids, members, took)]
            got, new_r = self._rs(grads, res, self._seed(b))
            del grads
            if self._stage == 2:
                for p, t in zip(members, took):
                    if t:
                        if side is not None:
                            p.grad.record_stream(side)
                        p.grad = None
        self._flight[b] = (took, got, new_r)

    def _reduce(self) -> None:
        """Stages 1–2: issue what is still open, wait, and hand each
        shard its reduced gradient (None where the parameter had none)."""
        for b in range(len(self._members)):
            if b not in self._flight:
                self._dispatch(b)
        if self._stream is not None:
            torch.cuda.current_stream(self._stream.device).wait_stream(
                self._stream)
        flight, self._flight = self._flight, {}
        self._arrived = [set() for _ in self._members]
        self._pending_rs = {}
        for b, (took, got, new_r) in flight.items():
            for k, i in enumerate(self._members[b]):
                self._shards[i].grad = got[k] if took[k] else None
                if took[k] and new_r is not None:
                    self._pending_rs[i] = new_r[k]
        for i in self._scalars:
            g = self._params[i].grad
            self._shards[i].grad = None if g is None else g.detach().clone()

    def _finite(self) -> bool:
        """One scalar all-reduce agrees the skip: the shards differ by
        rank, and a NaN lands in one rank's only. Under local SGD the
        slice agrees alone: a slice skips its own step."""
        flags = [traced.finite_scalar(s.grad) for s in self._shards
                 if s.grad is not None]
        ok = (torch.stack(flags).all() if flags
              else torch.ones((), dtype=torch.bool, device=self._device))
        bad = (~ok).to(torch.float32).reshape(1)
        return float(traced.allreduce(bad, op=Sum,
                                      groups=self._local)[0]) == 0.0

    def _gather_into_params(self, old) -> None:
        """Stages 1–2: all-gather the new shards (fp32) or the update,
        new minus old (bf16, int8), into the model's parameters."""
        n, r = self._w, self._pos
        for b, ids in enumerate(self._members):
            stepped = [self._shards[i].grad is not None for i in ids]
            if self._wire == "fp32":
                sent, res = [self._shards[i].detach() for i in ids], None
            else:
                sent = [self._shards[i].detach() - old[i] if s
                        else torch.zeros_like(old[i])
                        for i, s in zip(ids, stepped)]
                res = ([self._ag_res[i] if s else torch.zeros_like(old[i])
                        for i, s in zip(ids, stepped)] if self._ef else None)
            with record_function(f"hvd.zero.ag{b}"):
                full, new_r = self._ag(b, sent, res, self._seed(b))
            for k, i in enumerate(ids):
                p = self._params[i]
                if self._wire == "fp32":
                    p.copy_(full[k])
                    continue
                if not stepped[k]:
                    continue
                p.add_(full[k])
                self._shards[i].copy_(old[i].add_(
                    fsdp.dyn_shard(full[k], n, r)))
                if new_r is not None:
                    self._ag_res[i] = new_r[k]
        for i in self._scalars:
            self._params[i].copy_(self._shards[i].detach())

    # ------------------------------------------------------------ step

    def step(self, closure=None):
        """Reduce-scatter (stages 1–2), step the inner optimizer on the
        shards unless the grad guard trips, and all-gather back into the
        parameters (stages 1–2). Returns the closure's loss, if any."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._seen.clear()
        with torch.no_grad():
            if self._stage < 3:
                for i in self._nonscalar:  # the masters are the params
                    self._shards[i].copy_(fsdp.dyn_shard(
                        self._params[i].detach(), self._w, self._pos))
                self._reduce()
            for i in self._scalars:
                g = self._shards[i].grad
                if g is not None:
                    self._shards[i].grad = traced.allreduce(
                        g, op=self._op, groups=self._local)
            finite = self._finite() if self._guard else True
            self._updates += 1
            if finite:
                old = None
                if self._stage < 3 and self._wire != "fp32":
                    old = {i: s.detach().clone()
                           for i, s in enumerate(self._shards)}
                self._inner.step()
                if self._stage < 3:
                    self._gather_into_params(old)
                self._rs_res.update(self._pending_rs)
                self._streak = 0
            else:
                self._skips += 1
                self._streak += 1
                _guard.record_skip(self._streak, self._updates,
                                   self._max_skips)
            self._pending_rs = {}
            self._wire_step += 1  # rounding stays decorrelated over skips
            if self._stage < 3:  # the shards' gradients are the wrapper's
                for s in self._shards:
                    s.grad = None
        return loss

    def zero_grad(self, set_to_none: bool = True) -> None:
        if self._stage < 3:
            for p in self._params:
                if set_to_none:
                    p.grad = None
                elif p.grad is not None:
                    p.grad.detach_().zero_()
        self._inner.zero_grad(set_to_none=set_to_none)

    def remove_hooks(self) -> None:
        """Detach stage 2's gradient hooks from the parameters."""
        for h in self._hooks:
            h.remove()
        self._hooks = []

    # ---------------------------------------------- the stage-3 boundary

    def _module_names(self, module) -> Dict[str, int]:
        return {name: self._index[id(p)] for name, p in
                module.named_parameters(remove_duplicate=False)
                if id(p) in self._index}

    def _gathered(self, differentiable: bool, step: int) -> list:
        """Every parameter's full tensor from the shards (stage 3): one
        gather a bucket, through :class:`_Gather` when
        ``differentiable``."""
        full: list = [None] * len(self._params)
        for i in self._scalars:
            full[i] = self._shards[i] if differentiable else (
                self._shards[i].detach())
        for b, ids in enumerate(self._members):
            shards = [self._shards[i] for i in ids]
            if differentiable:
                got = _Gather.apply(self, b, step, *shards)
            else:
                got, _ = self._gather_bucket(b, [s.detach() for s in shards],
                                             step)
            for i, t in zip(ids, got):
                full[i] = t
        return full

    def value_and_grad(self, fn, module: torch.nn.Module):
        """``vg = opt.value_and_grad(fn, model)``; ``loss, grads =
        vg(*args)`` runs ``loss = fn(*args)`` and its backward. At stage
        3 ``model`` is reparametrized with the gathered parameters over
        the forward and the backward, and ``grads`` maps each parameter's
        name to its shard's reduced gradient; at stages 1–2 the
        gradients are reduced by ``step()`` and ``grads`` is None."""

        def vg(*args, **kwargs):
            if self._stage < 3:
                loss = fn(*args, **kwargs)
                loss.backward()
                return loss.detach(), None
            for p in self._params:
                _free(p)  # after unshard_params()
            full = self._gathered(True, self._wire_step)
            through = {name: full[i]
                       for name, i in self._module_names(module).items()}
            with stateless._reparametrize_module(module, through):
                loss = fn(*args, **kwargs)
                loss.backward()
            return loss.detach(), {self._names[i]: s.grad
                                   for i, s in enumerate(self._shards)}

        return vg

    def gather_params(self, module: Optional[torch.nn.Module] = None):
        """The full parameters, by ``module``'s names (else the
        optimizer's), for evaluation: gathered from the shards at stage
        3 (no gradient boundary), the parameters themselves at 1–2."""
        if self._stage < 3:
            full = [p.detach() for p in self._params]
        else:
            full = self._gathered(False, self._wire_step)
        if module is None:
            return dict(zip(self._names, full))
        return {name: full[i]
                for name, i in self._module_names(module).items()}

    def unshard_params(self) -> None:
        """Write the full parameters back into the model (stage 3; a
        no-op at 1–2), e.g. to export its ``state_dict()``. The next
        ``value_and_grad`` frees them again."""
        if self._stage < 3:
            return
        full = self._gathered(False, self._wire_step)
        with torch.no_grad():
            for p, f in zip(self._params, full):
                p.untyped_storage().resize_(p.numel() * p.element_size())
                p.copy_(f)

    def param_shards(self) -> List[torch.Tensor]:
        """This rank's flat parameter shards (stage 3's storage)."""
        return [s.detach().clone() for s in self._shards]

    def load_param_shards(self, shards) -> None:
        """Load this rank's parameter shards (stage 3), e.g. one entry of
        :meth:`reshard_params`."""
        if self._stage < 3:
            raise ValueError(
                "the parameters are full at zero_stage 1-2: load the "
                "model's state_dict instead")
        with torch.no_grad():
            for s, t in zip(self._shards, shards):
                if tuple(t.shape) != tuple(s.shape):
                    raise ValueError(
                        f"shard of shape {tuple(t.shape)} where this "
                        f"world's layout has {tuple(s.shape)}: "
                        "reshard_params() first")
                s.copy_(t)

    # ------------------------------------------------ the local-SGD round

    def sync_round(self) -> None:
        """Local SGD's sync round (K > 1; every rank calls it after a
        ``step()``): this rank's intra-position chunk of each slice's
        delta since the last round (the parameters' chunk minus the
        anchor chunk, in fp32; a 0-d parameter at position 0 only, so
        that each scalar enters the dots once) merges across slices
        through ``local_sgd.adasum_sync_shard``, the new anchor chunks
        (anchor plus merge) are allgathered within the slice into the
        parameters, and the residual and round roll on. Computed into
        fresh tensors and committed only at its end, so a failed attempt
        changes nothing."""
        if self._local_stages is None:
            raise ValueError("sync_round requires local_sgd_steps > 1")
        L, pos = self._w, self._pos
        with torch.no_grad():
            segs, a_segs = [], []
            for p, a in zip(self._params, self._anchor):
                if p.dim() == 0:
                    d = (p.detach() - a).to(torch.float32).reshape(1)
                    segs.append(d if pos == 0 else torch.zeros_like(d))
                    a_segs.append(a.to(torch.float32).reshape(1))
                else:
                    a_segs.append(a.to(torch.float32))
                    segs.append(fsdp.dyn_shard(p.detach(), L, pos).to(
                        torch.float32) - a_segs[-1])
            flat, a_flat = torch.cat(segs), torch.cat(a_segs)
            r_flat = None
            if self._local_res is not None:
                r_flat = torch.cat([
                    r.to(torch.float32).reshape(-1) if p.dim() or pos == 0
                    else torch.zeros(1, device=r.device)
                    for p, r in zip(self._params, self._local_res)])
            want = self._local_wire == "int8"
            got = local_sgd.adasum_sync_shard(
                flat, self._local_stages, self._local_wire, seed=self._round,
                residual=r_flat, return_residual=want)
            merged, new_r = got if want else (got, None)
            new_a_flat = a_flat + merged
            gathered = new_a_flat.new_empty((L, new_a_flat.numel()))
            gather_into(gathered, new_a_flat, self._group)
            new_p, new_a, new_res, off = [], [], [], 0
            for p, a in zip(self._params, self._anchor):
                cols = a.numel()
                seg = gathered[:, off:off + cols]
                if p.dim() == 0:
                    val = seg[0, 0]  # position 0 holds the scalar
                    new_p.append(val.to(p.dtype))
                    new_a.append(val.to(a.dtype))
                else:
                    new_p.append(seg.reshape(-1)[:p.numel()].view(
                        p.shape).to(p.dtype))
                    new_a.append(new_a_flat[off:off + cols].to(a.dtype))
                if new_r is not None:
                    new_res.append(new_r[off:off + cols].reshape(
                        a.shape).to(a.dtype))
                off += cols
            for p, v in zip(self._params, new_p):
                p.copy_(v)
        self._anchor = new_a
        if new_r is not None:
            self._local_res = new_res
        self._round += 1

    @property
    def local_stages(self):
        """Local SGD's ``(intra, inter)`` split (None at K = 1)."""
        return self._local_stages

    @property
    def local_payload_bytes(self) -> int:
        """The fp32 bytes of one round's deltas (``maybe_sync``'s
        ``payload_bytes``)."""
        return 4 * sum(p.numel() for p in self._params)

    # ----------------------------------------------------------- state

    def _wants_wire_rows(self) -> bool:
        """A quantized wire keeps its seed (and, with error feedback, the
        residuals) in the state; stage 3's exchange is in the boundary,
        whose state is none."""
        return self._stage <= 2 and (self._ef or self._wire == "int8")

    def _local_family(self, anchor, residual, rnd: int, width: int) -> dict:
        fam = {"anchor": dict(enumerate(anchor)), "round": int(rnd),
               "intra": int(width)}
        if self._local_wire == "int8":
            fam["residual"] = dict(enumerate(residual))
        return fam

    def state_dict(self) -> dict:
        """A copy of this rank's state: ``state`` (the inner optimizer's over the
        shards), ``world`` and ``rank``, ``guard`` (skips, streak, step)
        with the guard on, ``wire`` (the seed step; with error feedback
        ``rs`` and ``ag``, by parameter index) on a quantized wire, and
        under local SGD ``local`` (the anchor chunks, the residual, the
        round and the width L)."""
        sd = {"state": copy.deepcopy(self._inner.state_dict()),
              "world": self._n, "rank": self._r}
        if self._guard:
            sd["guard"] = {"skips": self._skips, "streak": self._streak,
                           "step": self._updates}
        if self._wants_wire_rows():
            sd["wire"] = {"step": self._wire_step}
            if self._ef:
                sd["wire"]["rs"] = {i: r.clone()
                                    for i, r in self._rs_res.items()}
                sd["wire"]["ag"] = {i: r.clone()
                                    for i, r in self._ag_res.items()}
        if self._local is not None:
            sd["local"] = self._local_family(
                [a.clone() for a in self._anchor],
                [r.clone() for r in self._local_res or ()],
                self._round, self._w)
        return sd

    def load_state_dict(self, sd: dict) -> None:
        if sd.get("world", self._n) != self._n:
            raise ValueError(
                f"world changed between the state ({sd['world']}) and this "
                f"optimizer ({self._n}): call reshard_state(states, "
                f"{self._n}) first, which carries the moments over")
        guard, wire, local = sd.get("guard"), sd.get("wire"), sd.get("local")
        if self._guard != (guard is not None):
            raise ValueError(
                "the state's guard counters do not match grad_guard="
                f"{self._guard}: migrate it once with reshard_state()")
        if self._wants_wire_rows() != (wire is not None) or (
                wire is not None and self._ef != ("rs" in wire)):
            raise ValueError(
                "the state's wire rows do not match this optimizer's wire "
                "and error_feedback: migrate it once with reshard_state()")
        if self._local is not None and local is None:
            raise ValueError(
                "local_sgd_steps > 1 but the optimizer state has no "
                '"local" layout family (anchor/residual/round rows): it '
                "was created without local-SGD mode. Migrate it once with "
                "reshard_state(states, world), which seeds the anchor "
                "from this optimizer's parameters")
        if self._local is None and local is not None:
            raise ValueError(
                'the optimizer state carries a "local" layout family '
                "but local_sgd_steps <= 1: it was checkpointed by a "
                "local-SGD run. Re-enable local_sgd_steps, or downgrade "
                "the state once with reshard_state(states, world), which "
                "strips the family and re-cuts the moments to the flat "
                "world split")
        if local is not None and int(local["intra"]) != self._w:
            raise ValueError(
                f"the state's shards are cut {local['intra']} ways and "
                f"this optimizer's slice has {self._w} ranks: "
                "reshard_state() first")
        self._inner.load_state_dict(sd["state"])
        if guard is not None:
            self._skips, self._streak, self._updates = (
                int(guard["skips"]), int(guard["streak"]),
                int(guard["step"]))
        if wire is not None:
            self._wire_step = int(wire["step"])
            if self._ef:
                dev = self._device
                self._rs_res = {int(i): r.to(dev)
                                for i, r in wire["rs"].items()}
                self._ag_res = {int(i): r.to(dev)
                                for i, r in wire["ag"].items()}
        if local is not None:
            n = len(self._params)
            self._anchor = [local["anchor"][i].to(self._device)
                            for i in range(n)]
            if self._local_res is not None:
                self._local_res = [local["residual"][i].to(self._device)
                                   for i in range(n)]
            self._round = int(local["round"])

    def _width(self, world: int) -> int:
        """How many ways the shards split in a world of ``world`` ranks:
        the world, or the slice's L under local SGD."""
        if self._local is None:
            return int(world)
        return len(local_sgd.resolve_stages(
            world, intra=self._local_intra)[0][0])

    @staticmethod
    def _recut(rows, size: int, new_world: int, old_width: int,
               new_width: int) -> List[torch.Tensor]:
        """One tensor's shard rows (every rank's, in rank order) re-split
        for ``new_world``: flat to flat, every rank's rows
        (``fsdp.reshard_rows``); with a local-SGD split on either side,
        slice 0's rows (the first ``old_width``) re-cut at the new width
        and tiled over the new slices (rank r takes chunk ``r %
        new_width``). Every value bit for bit; only padding moves."""
        if old_width == rows.shape[0] and new_width == new_world:
            new = fsdp.reshard_rows(rows, size, new_world)
            return [new[r].clone() for r in range(new_world)]
        new = fsdp.reshard_rows(rows[:old_width], size, new_width)
        return [new[r % new_width].clone() for r in range(new_world)]

    def reshard_state(self, states, new_world: int) -> List[dict]:
        """Every rank's :meth:`state_dict` of one world (in rank order)
        → one state a rank of ``new_world``, the moments carried bit for
        bit (the padding re-cut), replicated entries (step counts, 0-d
        parameters' state) from rank 0. The guard counters, the wire rows
        and the ``"local"`` family follow this optimizer's flags:
        carried, made when newly on (zeros; the anchor from this
        optimizer's parameters), dropped when off. ``ag`` residuals
        re-split like the moments; ``rs`` residuals are each rank's
        full-geometry error, and the wire only consumes their sum, so
        rank 0 takes the old ranks' sum (slice 0's under local SGD) and
        the rest zeros. With a local-SGD split on either side the rows
        are re-cut from slice 0's (:meth:`_recut`)."""
        if new_world < 1:
            raise ValueError(f"new_world must be >= 1, got {new_world}")
        states = list(states)
        old = states[0]["state"]
        old_local = states[0].get("local")
        old_width = (int(old_local["intra"]) if old_local is not None
                     else len(states))
        new_width = self._width(new_world)
        sizes = [p.numel() for p in self._params]
        scalar = set(self._scalars)
        per_rank = [dict() for _ in range(new_world)]
        for idx, entry in old["state"].items():
            for key, v in entry.items():
                if torch.is_tensor(v) and v.dim() >= 1 and idx not in scalar:
                    rows = torch.stack([st["state"]["state"][idx][key].cpu()
                                        for st in states])
                    vals = self._recut(rows, sizes[idx], new_world,
                                       old_width, new_width)
                else:
                    vals = [v.clone() if torch.is_tensor(v) else v
                            for _ in range(new_world)]
                for r in range(new_world):
                    per_rank[r].setdefault(idx, {})[key] = vals[r]
        out = []
        for r in range(new_world):
            sd = {"state": {"state": per_rank[r],
                            "param_groups": old["param_groups"]},
                  "world": new_world, "rank": r}
            if self._guard:
                g = states[0].get("guard") or {"skips": 0, "streak": 0,
                                               "step": 0}
                sd["guard"] = dict(g)
            out.append(sd)
        if self._wants_wire_rows():
            wires = self._reshard_wire(states, new_world, sizes, old_width,
                                       new_width)
            for sd, w in zip(out, wires):
                sd["wire"] = w
        if self._local is not None:
            fams = self._reshard_local(states, new_world, sizes, old_width,
                                       new_width)
            for sd, fam in zip(out, fams):
                sd["local"] = fam
        return out

    def _reshard_local(self, states, new_world: int, sizes, old_width: int,
                       new_width: int) -> List[dict]:
        """The ``"local"`` family for ``new_world``: the anchor (the same
        on every slice after a round) and the residual (slice 0's,
        adopted by every new slice) re-cut at the new width, the round
        carried; newly on, the anchor is this optimizer's parameters and
        the residual zeros."""
        old = states[0].get("local")
        rnd = 0 if old is None else int(old["round"])
        by_rank = [([], []) for _ in range(new_world)]
        for i, p in enumerate(self._params):
            if old is None:
                anchor = [fsdp.host_shard(p.detach().cpu(), new_width,
                                          r % new_width).clone()
                          for r in range(new_world)]
                res = [torch.zeros_like(a) for a in anchor]
            elif p.dim() == 0:
                anchor = [old["anchor"][i].cpu().clone()] * new_world
                res = [old["residual"][i].cpu().clone()
                       if "residual" in old else torch.zeros_like(
                           anchor[0])] * new_world
            else:
                anchor = self._recut(
                    torch.stack([st["local"]["anchor"][i].cpu()
                                 for st in states]),
                    sizes[i], new_world, old_width, new_width)
                res = (self._recut(
                    torch.stack([st["local"]["residual"][i].cpu()
                                 for st in states]),
                    sizes[i], new_world, old_width, new_width)
                    if "residual" in old else
                    [torch.zeros_like(a) for a in anchor])
            for r in range(new_world):
                by_rank[r][0].append(anchor[r])
                by_rank[r][1].append(res[r])
        return [self._local_family(a, rr, rnd, new_width)
                for a, rr in by_rank]

    def _reshard_wire(self, states, new_world: int, sizes, old_width: int,
                      new_width: int) -> List[dict]:
        old = states[0].get("wire")
        step = int(old["step"]) if old is not None else 0
        out = [{"step": step} for _ in range(new_world)]
        if not self._ef:
            return out
        # a local-SGD slice's rs carry is defined against its own sum:
        # only slice 0's rows are summed
        n_sum = (len(states) if old_width == len(states) else old_width)
        for i, p in enumerate(self._params):
            if old is None or "rs" not in old:  # newly on: zero carries
                rs = [torch.zeros(p.shape, dtype=p.dtype)
                      for _ in range(new_world)]
                cols = () if p.dim() == 0 else (
                    fsdp.shard_cols(sizes[i], new_width),)
                ag = [torch.zeros(cols, dtype=p.dtype)
                      for _ in range(new_world)]
            elif p.dim() == 0:
                rs = [old["rs"][i].cpu().clone() for _ in range(new_world)]
                ag = [old["ag"][i].cpu().clone() for _ in range(new_world)]
            else:
                total = states[0]["wire"]["rs"][i].cpu().clone()
                for st in states[1:n_sum]:  # in rank order, as a row sum
                    total += st["wire"]["rs"][i].cpu()
                rs = [total] + [torch.zeros_like(total)
                                for _ in range(new_world - 1)]
                ag = self._recut(
                    torch.stack([st["wire"]["ag"][i].cpu() for st in states]),
                    sizes[i], new_world, old_width, new_width)
            for r in range(new_world):
                out[r].setdefault("rs", {})[i] = rs[r]
                out[r].setdefault("ag", {})[i] = ag[r]
        return out

    def reshard_params(self, shards_by_rank, new_world: int
                       ) -> List[List[torch.Tensor]]:
        """Every rank's :meth:`param_shards` of one world (in rank order)
        → one list a rank of ``new_world``, every value bit for bit (only
        the zero-pad tail is re-cut)."""
        if new_world < 1:
            raise ValueError(f"new_world must be >= 1, got {new_world}")
        out = [[] for _ in range(new_world)]
        for i, p in enumerate(self._params):
            if p.dim() == 0:
                vals = [shards_by_rank[0][i].cpu().clone()] * new_world
            else:
                rows = torch.stack([s[i].cpu() for s in shards_by_rank])
                new = fsdp.reshard_rows(rows, p.numel(), new_world)
                vals = [new[r].clone() for r in range(new_world)]
            for r in range(new_world):
                out[r].append(vals[r])
        return out


def _per_tensor_schedule(leaves) -> overlap.BucketSchedule:
    """One bucket a tensor, in reverse order (the JAX optimizer's
    per-leaf collectives at ``overlap_buckets=0`` on the fp32 wire)."""
    order = list(reversed(range(len(leaves))))
    nbytes = tuple(overlap._nbytes(leaves[i]) for i in order)
    return overlap.BucketSchedule(tuple((i,) for i in order), nbytes,
                                  sum(nbytes))


def _free(p: torch.Tensor) -> None:
    """Let go of a parameter's storage and keep its shape (stage 3)."""
    storage = p.untyped_storage()
    if not storage.nbytes():
        return
    if (p.storage_offset() or storage.nbytes() != p.numel()
            * p.element_size() or not storage.resizable()):
        p.data = p.data.clone()  # a view, or memory the tensor borrows
    p.untyped_storage().resize_(0)
