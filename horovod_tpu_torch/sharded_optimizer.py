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
``local_sgd_*`` raise naming ROADMAP A11.

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
residuals, the wire seed and the guard counters; ``reshard_state(states,
new_world)`` takes every rank's state of one world to a new world, and
``reshard_params(shards, new_world)`` does the same for stage 3's
``param_shards()``, through ``parallel.fsdp.reshard_rows`` (every value
bit for bit; the ``rs`` residuals keep their total, on rank 0).
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

from .common import basics
from .common import guard as _guard
from .ops import overlap, traced
from .ops.reduction_ops import Average, Sum, resolve_op
from .optimizer import _check_unported
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
                 local_sgd_inter_wire: Optional[str] = None,
                 local_sgd_intra: Optional[int] = None):
        st = basics._require_init()
        _check_unported(local_sgd_steps, local_sgd_inter_wire,
                        local_sgd_intra)
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
        n, r = self._n, self._r
        with torch.no_grad():
            self._shards = [
                (p.detach().clone() if p.dim() == 0
                 else fsdp.host_shard(p.detach(), n, r).clone()
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
            None, self._hier, True if self._ef else None)
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
            grads, residuals, self._n, self._group, self._stages,
            self._wire, self._op, seed, self._block)

    def _ag(self, b: int, shards, residuals, seed: int):
        return overlap._ag_bucket(
            shards, residuals, [self._params[i] for i in self._members[b]],
            self._n, self._group, self._stages, self._wire, seed,
            self._block)

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
        rank, and a NaN lands in one rank's only."""
        flags = [traced.finite_scalar(s.grad) for s in self._shards
                 if s.grad is not None]
        ok = (torch.stack(flags).all() if flags
              else torch.ones((), dtype=torch.bool, device=self._device))
        bad = (~ok).to(torch.float32).reshape(1)
        return float(traced.allreduce(bad, op=Sum)[0]) == 0.0

    def _gather_into_params(self, old) -> None:
        """Stages 1–2: all-gather the new shards (fp32) or the update,
        new minus old (bf16, int8), into the model's parameters."""
        n, r = self._n, self._r
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
                        self._params[i].detach(), self._n, self._r))
                self._reduce()
            for i in self._scalars:
                g = self._shards[i].grad
                if g is not None:
                    self._shards[i].grad = traced.allreduce(g, op=self._op)
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

    # ----------------------------------------------------------- state

    def _wants_wire_rows(self) -> bool:
        """A quantized wire keeps its seed (and, with error feedback, the
        residuals) in the state; stage 3's exchange is in the boundary,
        whose state is none."""
        return self._stage <= 2 and (self._ef or self._wire == "int8")

    def state_dict(self) -> dict:
        """A copy of this rank's state: ``state`` (the inner optimizer's over the
        shards), ``world`` and ``rank``, ``guard`` (skips, streak, step)
        with the guard on, and ``wire`` (the seed step; with error
        feedback ``rs`` and ``ag``, by parameter index) on a quantized
        wire."""
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
        return sd

    def load_state_dict(self, sd: dict) -> None:
        if sd.get("world", self._n) != self._n:
            raise ValueError(
                f"world changed between the state ({sd['world']}) and this "
                f"optimizer ({self._n}): call reshard_state(states, "
                f"{self._n}) first, which carries the moments over")
        guard, wire = sd.get("guard"), sd.get("wire")
        if self._guard != (guard is not None):
            raise ValueError(
                "the state's guard counters do not match grad_guard="
                f"{self._guard}: migrate it once with reshard_state()")
        if self._wants_wire_rows() != (wire is not None) or (
                wire is not None and self._ef != ("rs" in wire)):
            raise ValueError(
                "the state's wire rows do not match this optimizer's wire "
                "and error_feedback: migrate it once with reshard_state()")
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

    def reshard_state(self, states, new_world: int) -> List[dict]:
        """Every rank's :meth:`state_dict` of one world (in rank order)
        → one state a rank of ``new_world``, the moments carried bit for
        bit (``fsdp.reshard_rows``; the padding re-cut), replicated
        entries (step counts, 0-d parameters' state) from rank 0. The
        guard counters and the wire rows follow this optimizer's flags:
        carried, made as zeros when newly on, dropped when off. ``ag``
        residuals re-split like the moments; ``rs`` residuals are each
        rank's full-geometry error, and the wire only consumes their sum,
        so rank 0 takes the old ranks' sum and the rest zeros."""
        if new_world < 1:
            raise ValueError(f"new_world must be >= 1, got {new_world}")
        states = list(states)
        old = states[0]["state"]
        sizes = [p.numel() for p in self._params]
        scalar = set(self._scalars)
        per_rank = [dict() for _ in range(new_world)]
        for idx, entry in old["state"].items():
            for key, v in entry.items():
                if torch.is_tensor(v) and v.dim() >= 1 and idx not in scalar:
                    rows = torch.stack([st["state"]["state"][idx][key].cpu()
                                        for st in states])
                    new = fsdp.reshard_rows(rows, sizes[idx], new_world)
                    vals = [new[r].clone() for r in range(new_world)]
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
            wires = self._reshard_wire(states, new_world, sizes)
            for sd, w in zip(out, wires):
                sd["wire"] = w
        return out

    def _reshard_wire(self, states, new_world: int, sizes) -> List[dict]:
        old = states[0].get("wire")
        step = int(old["step"]) if old is not None else 0
        out = [{"step": step} for _ in range(new_world)]
        if not self._ef:
            return out
        for i, p in enumerate(self._params):
            if old is None or "rs" not in old:  # newly on: zero carries
                rs = [torch.zeros(p.shape, dtype=p.dtype)
                      for _ in range(new_world)]
                cols = () if p.dim() == 0 else (
                    fsdp.shard_cols(sizes[i], new_world),)
                ag = [torch.zeros(cols, dtype=p.dtype)
                      for _ in range(new_world)]
            elif p.dim() == 0:
                rs = [old["rs"][i].cpu().clone() for _ in range(new_world)]
                ag = [old["ag"][i].cpu().clone() for _ in range(new_world)]
            else:
                total = states[0]["wire"]["rs"][i].cpu().clone()
                for st in states[1:]:  # in rank order, as a row sum
                    total += st["wire"]["rs"][i].cpu()
                rs = [total] + [torch.zeros_like(total)
                                for _ in range(new_world - 1)]
                rows = torch.stack([st["wire"]["ag"][i].cpu()
                                    for st in states])
                new = fsdp.reshard_rows(rows, sizes[i], new_world)
                ag = [new[r].clone() for r in range(new_world)]
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
