"""Data-parallel training: ``DistributedOptimizer`` and the broadcast
helpers.

``DistributedOptimizer`` wraps a ``torch.optim`` optimizer in the
reference's torch design (``horovod/torch/optimizer.py``; the JAX
package's ``optimizer.py`` is its oracle):

- a ``register_post_accumulate_grad_hook`` on every parameter enqueues
  the parameter's gradient into the fusion manager the moment backward
  has accumulated it, so fused allreduces are in flight while backward
  runs on through earlier layers;
- ``step()`` waits on the handles, writes the reduced gradients back
  and steps the inner optimizer;
- ``backward_passes_per_step=k`` accumulates k backward passes locally
  and reduces their sum once (the reference's default). The contract is
  the reference's: call ``step()`` after every backward pass. The window
  is counted once, by ``step()`` calls. On each pass but the window's
  last the hook moves the gradient into a buffer of the wrapper, so
  ``zero_grad()`` between passes (``set_to_none`` or not) loses
  nothing, and ``step()`` returns None without stepping. On the last
  pass the hook adds the buffer and enqueues; at the window's end
  ``step()`` also enqueues, in parameter order, every buffer whose
  parameter had no gradient on that pass, then drops every buffer, so a
  parameter that stops receiving gradients is never reduced with zeros;
- ``op=`` Average, Sum or Adasum (each gradient its own Adasum entry,
  never fused); ``gradient_predivide_factor`` f splits the average as
  ``Sum`` of ``x / (n·f)`` times f; ``compression=`` none, fp16, bf16,
  or the quantized ``int8``/``int8_block``, which send the fused
  gradient buffer over the fusion manager's int8 wire;
- ``error_feedback=True`` (a quantized compression only) keeps one
  residual per parameter: the hook enqueues ``grad + residual`` with
  ``return_residual=True`` and ``synchronize`` stores the new residual,
  so each step's quantization error joins the next step's gradient
  (EF-SGD). On the two-level route the residual is the inter hop's,
  the same on every rank of a node and divided by L, so the next
  step's intra reduce-scatter adds one copy of it at the shard's
  owner (``horovod_tpu/optimizer.py:74-125``). ``state_dict`` carries
  the residuals;
- ``flush()`` reduces and steps a partial window now (a step count
  that k does not divide would otherwise lose the tail window), and
  does nothing when the window is empty;
- ``average`` (True: Average, False: Sum; it conflicts with ``op=``),
  ``prescale_factor``/``postscale_factor`` (the fused batch's
  pre/postscale; the int8 wire folds the prescale into its scales; a
  predivide factor replaces both, as in the reference), ``process_set``
  (the reduction's ranks) and ``average_aggregated_gradients`` (the
  window's sum divided by its passes, k for a whole window);
- ``grad_guard=True`` (None: ``HOROVOD_GUARD``): every floating fused
  batch yields one ``all(isfinite)`` over its reduced values, read once
  a step after the reduction. A tripped flag skips the inner step:
  parameters, optimizer state and the error-feedback residuals of the
  last applied step stay as they were, the window resets, and
  ``common/guard.py`` counts the skip; ``guard_max_skips`` consecutive
  skips (None: ``HOROVOD_GUARD_MAX_SKIPS``) latch an escalation that
  ``hvd.guard_check()`` raises as ``HorovodInternalError``.

- ``overlap_buckets=N`` (None: ``HOROVOD_OVERLAP_BUCKETS`` when
  ``HOROVOD_OVERLAP`` is on, else 0) exchanges the gradients in N
  buckets of ``ops/overlap.py``'s schedule, built once over the
  parameters in reverse registration order (the JAX reverse flatten
  order), ``overlap_min_bytes`` its merge floor. At the window's last
  pass the hooks fill the buckets, and each bucket's collective
  (``overlap.exchange_bucket``: the exact allreduce, the int8 wire with
  a per-bucket seed, or the two-level route) is issued the moment its
  last member's gradient arrives, on a side stream of the card, so
  backward keeps running while it is in flight; ``step()`` waits on
  them. At the window's end a bucket still open goes out with zeros for
  its members that have no gradient in the window, so that every rank's
  buckets keep their shapes; such a member sends no residual, keeps its
  carried one, and its ``.grad`` stays None, so the inner optimizer
  leaves it alone, as the fused path does (a parameter that stops
  receiving gradients is not stepped by momentum or weight decay). The
  choice is each rank's own, as on the fused path: a parameter used on
  some ranks and not on others is outside the contract of both paths
  (the fused path would enqueue mismatched collectives). Error feedback
  is per bucket, and the guard ANDs the buckets' flags. With Sum on fp32 the result is bitwise the fused path's. An
  explicit ``overlap_buckets`` with Adasum, Min, Max or Product raises
  ``ValueError``; the environment's default falls back to the fused
  path.

- ``local_sgd_steps=K`` (None: ``HOROVOD_LOCAL_SGD_STEPS``, with one
  warning) with K > 1 switches to local SGD (``local_sgd.py``,
  ``horovod_tpu/optimizer.py:311-337,606-625``): every exchange of the
  fused and the overlapped path stays within this rank's slice (the
  intra groups of ``local_sgd.resolve_stages(size, local_sgd_intra)``,
  made at construction), Average and the predivide factor count the
  slice's L ranks, and the guard's flag, read on the reduced values,
  is the slice's. ``opt.sync()`` runs the sync round: each slice's delta
  since the last round (``sync_tree``) merges across slices by
  hierarchical Adasum on ``local_sgd_inter_wire`` (int8, bf16 or
  fp32), the parameters land on the anchor plus the merge, and the
  anchor (the parameters at the last round) and the int8 wire's
  residual roll on; both are in ``state_dict`` under ``"local_sgd"``.
  Drive the cadence with ``local_sgd.maybe_sync(opt.sync, step=i,
  k=opt.local_sgd_steps)``. Sum and Average only, no process set. K = 1
  is the plain path.

Every rank must run the same model, so that the hooks enqueue the same
gradients in the same order (the fusion manager issues collectives in
that order).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Set

import torch
import torch.distributed as dist
from torch.profiler import record_function

from . import local_sgd
from .common import basics
from .common import guard as _guard
from .common.process_sets import ProcessSet
from .ops import eager, overlap, traced
from .ops.compression import Compression
from .ops.reduction_ops import Adasum, Average, Sum, resolve_op


class DistributedOptimizer:
    """``torch.optim`` wrapper that averages gradients across ranks."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters=None, compression=Compression.none,
                 backward_passes_per_step: int = 1, op=None,
                 gradient_predivide_factor: float = 1.0,
                 average: Optional[bool] = None,
                 prescale_factor: Optional[float] = None,
                 postscale_factor: Optional[float] = None,
                 process_set: Optional[ProcessSet] = None,
                 average_aggregated_gradients: bool = False,
                 error_feedback: bool = False,
                 overlap_buckets: Optional[int] = None,
                 overlap_min_bytes: Optional[int] = None,
                 grad_guard: Optional[bool] = None,
                 guard_max_skips: Optional[int] = None,
                 local_sgd_steps: Optional[int] = None,
                 local_sgd_inter_wire: str = "int8",
                 local_sgd_intra: Optional[int] = None):
        basics._require_init()
        op = resolve_op(op, average)
        local_k = local_sgd.engaged_steps(local_sgd_steps)
        stages = None
        if local_k > 1:  # horovod_tpu/optimizer.py:311-337's checks
            if op not in (Sum, Average):
                raise ValueError(
                    "local_sgd_steps > 1 requires op=Sum/Average for the "
                    "local phase (Adasum is the ROUND combiner, not the "
                    "per-step gradient op)")
            if process_set is not None and process_set.process_set_id != 0:
                raise NotImplementedError(
                    "local_sgd_steps does not compose with process sets")
            stages = local_sgd.prepare_split(basics.size(), local_sgd_intra,
                                             local_sgd_inter_wire)
        quantized = getattr(compression, "quantized_wire", False)
        buckets = (overlap.default_buckets() if overlap_buckets is None
                   else int(overlap_buckets))
        if buckets < 0:
            raise ValueError(f"overlap_buckets must be >= 0, got {buckets}")
        if buckets and op not in (Sum, Average):
            if overlap_buckets is not None:
                raise ValueError(
                    "overlap_buckets requires op=Sum/Average (Adasum/min/"
                    "max/product do not commute with bucket concatenation)")
            buckets = 0  # HOROVOD_OVERLAP is a fleet default: keep fusion
        if error_feedback and not quantized:
            raise ValueError(
                "error_feedback=True requires a quantized-wire compression "
                "(Compression.int8, int8_block or hier_int8)"
            )
        if op == Adasum and quantized:
            raise ValueError(
                "op=Adasum does not compose with a quantized-wire "
                "compression: the int8 wire reduces by Sum/Average only"
            )
        if gradient_predivide_factor != 1.0 and op != Average:
            raise ValueError(
                "gradient_predivide_factor requires op=Average"
            )
        k = int(backward_passes_per_step)
        if k < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self._opt = optimizer
        self._compression = compression
        self._error_feedback = bool(error_feedback)
        # only hier_int8's residual batch takes the two-level route
        # (``horovod_tpu/optimizer.py:80-90``); int8 and int8_block stay
        # on the flat wire, whose residual holds the whole error
        self._two_level = getattr(compression, "wire_format",
                                  None) == "int8_hier"
        self._residuals: Dict[int, torch.Tensor] = {}
        self._k = k
        self._process_set = process_set
        self._average_window = bool(average_aggregated_gradients)
        # the reference's factors (horovod_tpu/optimizer.py:378-384): the
        # predivide split takes the place of pre/postscale
        pre = 1.0 if prescale_factor is None else float(prescale_factor)
        post = 1.0 if postscale_factor is None else float(postscale_factor)
        if gradient_predivide_factor != 1.0:
            f = float(gradient_predivide_factor)
            n = (basics.size() if process_set is None
                 or process_set.process_set_id == 0 else process_set.size)
            if stages is not None:
                n = len(stages[0][0])
            op, pre, post = Sum, 1.0 / (n * f), f
        self._op, self._pre, self._post = op, pre, post
        self._guard = (_guard.default_enabled() if grad_guard is None
                       else bool(grad_guard))
        self._max_skips = (_guard.default_max_skips() if guard_max_skips
                           is None else int(guard_max_skips))
        self._updates = 0  # window ends, applied or skipped
        self._streak = 0  # consecutive skipped updates
        self._params: List[torch.nn.Parameter] = [
            p for group in optimizer.param_groups for p in group["params"]
            if p.requires_grad
        ]
        names = dict((id(p), n) for n, p in named_parameters or ())
        self._names = {
            id(p): names.get(id(p), f"grad.{i}")
            for i, p in enumerate(self._params)
        }
        # local SGD: the split, the intra groups every exchange names,
        # the inter wire, the anchor and the int8 wire's residual
        self.local_sgd_steps = max(local_k, 1)
        self._stages = stages
        self._local = None if stages is None else stages[0]
        self._local_wire = local_sgd_inter_wire
        self._anchor: List[torch.Tensor] = []
        self._local_res: Optional[List[torch.Tensor]] = None
        if stages is not None:
            self._anchor = [p.detach().clone() for p in self._params]
            if self._local_wire == "int8":
                self._local_res = [torch.zeros_like(p)
                                   for p in self._params]
        self._micro = 0  # step() calls so far in this window
        self._seen: Set[int] = set()  # parameters hooked since step()
        self._accum: Dict[int, torch.Tensor] = {}  # earlier passes' sum
        self._handles: Dict[int, eager.TorchHandle] = {}
        self._overlap = None
        if buckets:
            self._overlap = _Buckets(self, buckets, overlap_min_bytes)
        self._hooks = [p.register_post_accumulate_grad_hook(self._hook)
                       for p in self._params]

    def __getattr__(self, name):
        return getattr(self._opt, name)

    def _hook(self, p: torch.nn.Parameter) -> None:
        key = id(p)
        if key in self._seen:
            raise RuntimeError(
                f"gradient of {self._names[key]} produced again before "
                "step(): call step() after every backward pass"
            )
        self._seen.add(key)
        with torch.no_grad():
            if self._micro < self._k - 1:
                buf = self._accum.get(key)
                if buf is None:
                    self._accum[key] = p.grad.clone()
                else:
                    buf.add_(p.grad)
                p.grad.zero_()
                return
            buf = self._accum.pop(key, None)
            if buf is not None:
                p.grad.add_(buf)
        self._enqueue(p, self._k)

    def _enqueue(self, p: torch.nn.Parameter, passes: int = 1) -> None:
        """Put ``p.grad``, the sum of a window of ``passes`` backward
        passes, in flight (with overlap on, into its bucket)."""
        if self._overlap is not None:
            self._overlap.arrive(p, passes)
            return
        grad = p.grad
        if self._error_feedback:
            res = self._residuals.get(id(p))
            if res is not None:
                grad = grad + res
        pre = self._pre / passes if self._average_window else self._pre
        self._handles[id(p)] = eager._submit(*eager._allreduce_entry(
            grad, self._names[id(p)], self._op, pre, self._post,
            self._process_set, self._compression,
            return_residual=self._error_feedback, guard=self._guard,
            two_level=self._two_level, local=self._local,
        ))

    def synchronize(self) -> bool:
        """Wait for every enqueued gradient and write it back. With
        ``backward_passes_per_step=1``, a gradient that no hook saw (one
        set by hand) is reduced here. Returns False when the grad guard
        found a non-finite reduced value (one host read of the batches'
        flags); the error-feedback residuals then stay those of the last
        applied step."""
        if self._overlap is not None:
            return self._overlap.synchronize(max(self._micro, 1))
        if self._k == 1:
            for p in self._params:
                if p.grad is not None and id(p) not in self._handles:
                    self._enqueue(p)
        handles, self._handles = self._handles, {}
        by_id = {id(p): p for p in self._params}
        residuals, flags = {}, {}
        with torch.no_grad():
            while handles:  # a batch's outputs go with its last handle
                key, handle = handles.popitem()
                out = handle.wait()
                if self._error_feedback:
                    out, residuals[key] = out
                by_id[key].grad.copy_(out)
                flag = handle.finite() if self._guard else None
                if flag is not None:  # one a fused batch
                    flags[id(flag)] = flag
        finite = not flags or bool(torch.stack(list(flags.values())).all())
        if finite:
            self._residuals.update(residuals)
        return finite

    def step(self, closure=None):
        """Count one backward pass. In the middle of a window, return
        None; at its end, reduce the window's gradients and step."""
        self._seen.clear()
        self._micro += 1
        if self._micro < self._k:
            return None
        return self._end_window(closure)

    def flush(self, closure=None):
        """Reduce and step a partial window now, as if it had ended (an
        epoch whose step count k does not divide would otherwise lose
        its last passes); None, and nothing done, when the window is
        empty."""
        if self._micro == 0:
            return None
        self._seen.clear()
        return self._end_window(closure)

    def _end_window(self, closure):
        """Enqueue, in parameter order, the buffers the last pass's
        hooks left, reduce, and step the inner optimizer unless the grad
        guard trips."""
        passes, self._micro = self._micro, 0
        with torch.no_grad():
            for p in self._params:  # the same order on every rank
                buf = self._accum.pop(id(p), None)
                if buf is None:
                    continue
                if p.grad is None:
                    p.grad = buf
                else:
                    p.grad.add_(buf)
                self._enqueue(p, passes)
        finite = (self.synchronize() if self._overlap is None
                  else self._overlap.synchronize(passes))
        self._updates += 1
        if finite:
            self._streak = 0
            return self._opt.step(closure)
        self._streak += 1
        _guard.record_skip(self._streak, self._updates, self._max_skips)
        return None

    def zero_grad(self, set_to_none: bool = True) -> None:
        self._opt.zero_grad(set_to_none=set_to_none)

    @property
    def local_stages(self):
        """Local SGD's ``(intra, inter)`` split (None at K = 1)."""
        return self._stages

    @property
    def local_payload_bytes(self) -> int:
        """The fp32 bytes of one round's deltas (``maybe_sync``'s
        ``payload_bytes``)."""
        return 4 * sum(p.numel() for p in self._params)

    def sync(self) -> None:
        """Local SGD's sync round (K > 1; every rank calls it after a
        ``step()``): the parameters become the anchor plus the Adasum
        merge of the slices' deltas since the last round, the same bits
        on every rank, and the anchor and the residual roll on. The
        round is computed into fresh tensors and committed only at its
        end, so an attempt that fails changes nothing and a retry
        (``local_sgd.run_round``) applies it once."""
        if self._stages is None:
            raise ValueError("sync requires local_sgd_steps > 1")
        with torch.no_grad():
            new_p, new_r = local_sgd.sync_tree(
                self._params, self._anchor, self._local_res,
                stages=self._stages, inter_wire=self._local_wire,
                seed=self._updates,
                return_residual=self._local_wire == "int8")
            for p, v in zip(self._params, new_p):
                p.copy_(v)
        self._anchor = new_p
        if new_r is not None:
            self._local_res = new_r

    def state_dict(self):
        """The inner optimizer's state; with error feedback, also the
        residuals (by the parameter's index) under ``"ef_residuals"``;
        under local SGD the anchor and the inter wire's residual (by
        index) under ``"local_sgd"``."""
        sd = self._opt.state_dict()
        if self._error_feedback:
            index = {id(p): i for i, p in enumerate(self._params)}
            sd["ef_residuals"] = {index[k]: r.clone()
                                  for k, r in self._residuals.items()}
        if self._stages is not None:
            sd["local_sgd"] = {"anchor": {i: a.clone() for i, a in
                                          enumerate(self._anchor)}}
            if self._local_res is not None:
                sd["local_sgd"]["residual"] = {
                    i: r.clone() for i, r in enumerate(self._local_res)}
        return sd

    def load_state_dict(self, state_dict) -> None:
        state_dict = dict(state_dict)
        residuals = state_dict.pop("ef_residuals", None)
        local = state_dict.pop("local_sgd", None)
        if (local is None) != (self._stages is None):
            raise ValueError(
                "the state's \"local_sgd\" entry does not match "
                f"local_sgd_steps={self.local_sgd_steps}: a local-SGD "
                "state carries the anchor, a plain one does not")
        self._opt.load_state_dict(state_dict)
        if local is not None:
            n = len(self._params)
            self._anchor = [local["anchor"][i].to(self._params[i].device)
                            for i in range(n)]
            if self._local_res is not None:
                self._local_res = [
                    local["residual"][i].to(self._params[i].device)
                    for i in range(n)]
        if residuals is not None:
            self._residuals = {
                id(self._params[i]): r.to(self._params[i].device)
                for i, r in residuals.items()
            }

    def residual_norm(self) -> float:
        """L2 norm of every error-feedback residual together (0 without
        error feedback or before the first step)."""
        if not self._residuals:
            return 0.0
        return float(torch.linalg.vector_norm(torch.stack([
            torch.linalg.vector_norm(r.float())
            for r in self._residuals.values()])))

    def remove_hooks(self) -> None:
        """Detach the gradient hooks from the parameters."""
        for h in self._hooks:
            h.remove()
        self._hooks = []


class _Buckets:
    """``DistributedOptimizer``'s bucketed overlap: the schedule over
    its parameters, the buckets' arrivals in the current window, and the
    exchanges in flight."""

    def __init__(self, opt: "DistributedOptimizer", n: int,
                 min_bytes: Optional[int]):
        params = opt._params
        if min_bytes is None:
            min_bytes = overlap.default_min_bytes()
        self.opt = opt
        self.schedule = overlap.schedule_for(
            params, f"DistributedOptimizer[{len(params)}]", n, int(min_bytes))
        overlap._publish(self.schedule)
        self.index = {id(p): i for i, p in enumerate(params)}
        self.bucket_of = {i: b for b, idxs in enumerate(self.schedule.buckets)
                          for i in idxs}
        # checks the route once; the prescale is set at each dispatch
        self.wire = overlap.make_wire(
            opt._op, opt._compression, opt._pre, opt._post,
            opt._process_set, groups=opt._local,
            residuals=opt._error_feedback)
        self.arrived: List[Set[int]] = [set() for _ in self.schedule.buckets]
        self.flight: Dict[int, tuple] = {}  # bucket -> its exchange's outputs
        dev = params[0].device if params else torch.device("cpu")
        # the exchanges run beside backward on the card; on the CPU, in line
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self.dispatched = 0  # bucket collectives issued, all windows

    def arrive(self, p: torch.nn.Parameter, passes: int) -> None:
        i = self.index[id(p)]
        b = self.bucket_of[i]
        self.arrived[b].add(i)
        if len(self.arrived[b]) == len(self.schedule.buckets[b]):
            self.dispatch(b, passes)

    def dispatch(self, b: int, passes: int) -> None:
        """Issue bucket ``b``'s exchange of the window's gradients: an
        arrived member's, one set by hand (one pass a window), else
        zeros."""
        opt = self.opt
        members = [opt._params[i] for i in self.schedule.buckets[b]]
        side = self.stream
        if side is not None:
            side.wait_stream(torch.cuda.current_stream(side.device))
        with record_function(f"hvd.overlap.bucket{b}"), torch.no_grad(), (
                torch.cuda.stream(side) if side is not None
                else contextlib.nullcontext()):
            took = [i in self.arrived[b] or (opt._k == 1
                                             and p.grad is not None)
                    for i, p in zip(self.schedule.buckets[b], members)]
            flat = overlap._concat([p.grad if t else torch.zeros_like(p)
                                    for p, t in zip(members, took)])
            res = None
            if opt._error_feedback:
                carried = [opt._residuals.get(id(p)) if t else None
                           for p, t in zip(members, took)]
                res = overlap._concat([
                    torch.zeros_like(p) if r is None else r
                    for p, r in zip(members, carried)])
            pre = opt._pre / passes if opt._average_window else opt._pre
            wire = self.wire._replace(prescale=pre)
            seed = opt._updates * self.schedule.n_buckets + b
            out, new_r = overlap.exchange_bucket(wire, flat, seed, res)
            finite = traced.finite_scalar(out) if opt._guard else None
        self.flight[b] = ([p for p, t in zip(members, took) if t],
                          members, out, new_r, finite)
        self.dispatched += 1

    def synchronize(self, passes: int) -> bool:
        """Issue what is still open (the window's end, of ``passes``
        backward passes), wait, and write the reduced gradients back;
        False when a bucket's values are not finite (the residuals then
        stay those of the last applied step)."""
        for b in range(self.schedule.n_buckets):
            if b not in self.flight:
                self.dispatch(b, passes)
        if self.stream is not None:
            torch.cuda.current_stream(self.stream.device).wait_stream(
                self.stream)
        flight, self.flight = self.flight, {}
        self.arrived = [set() for _ in self.schedule.buckets]
        flags, residuals = [], {}
        with torch.no_grad():
            for b in sorted(flight):
                took, members, out, new_r, finite = flight[b]
                took = set(map(id, took))
                for p, piece in zip(members, overlap._split(out, members)):
                    if id(p) not in took:
                        continue  # no gradient this window: not stepped
                    if p.grad is None:
                        p.grad = piece.clone()
                    else:
                        p.grad.copy_(piece)
                if new_r is not None:
                    residuals.update(
                        (id(p), r) for p, r in
                        zip(members, overlap._split(new_r, members))
                        if id(p) in took)
                if finite is not None:
                    flags.append(finite)
        finite = not flags or bool(torch.stack(flags).all())
        if finite:
            self.opt._residuals.update(residuals)
        return finite


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Copy root's values into every rank's tensors, in place: a
    ``state_dict()``, ``named_parameters()`` or a list of (name, tensor)
    pairs."""
    items = list(params.items()) if hasattr(params, "items") else list(
        params
    )
    handles = [
        eager.broadcast_async_(p.data if hasattr(p, "data") else p,
                               root_rank, name=f"broadcast.{name}")
        for name, p in items if p is not None
    ]
    for h in handles:
        h.wait()


def broadcast_optimizer_state(optimizer, root_rank: int = 0) -> None:
    """Make every rank's optimizer state root's: the structure and
    scalars go by ``broadcast_object``, each state tensor by an in-place
    broadcast (a rank without the state yet gets tensors of root's shape
    first)."""
    opt = getattr(optimizer, "_opt", optimizer)
    sd = opt.state_dict()
    layout = {
        pid: {k: (("tensor", tuple(v.shape), v.dtype) if torch.is_tensor(v)
                  else ("value", v)) for k, v in st.items()}
        for pid, st in sd["state"].items()
    }
    meta = broadcast_object({"param_groups": sd["param_groups"],
                             "layout": layout}, root_rank)
    params = [p for g in opt.param_groups for p in g["params"]]
    state = {}
    for pid, entries in meta["layout"].items():
        mine = sd["state"].get(pid, {})
        state[pid] = {}
        for k, spec in entries.items():
            if spec[0] == "value":
                state[pid][k] = spec[1]
                continue
            t = mine.get(k)
            if t is None or tuple(t.shape) != spec[1]:
                dev = params[pid].device if spec[1] else torch.device("cpu")
                t = torch.zeros(spec[1], dtype=spec[2], device=dev)
            state[pid][k] = t
    handles = [eager.broadcast_async_(t, root_rank,
                                      name=f"opt.{pid}.{k}")
               for pid, st in state.items() for k, t in st.items()
               if torch.is_tensor(t)]
    for h in handles:
        h.wait()
    opt.load_state_dict({"state": state,
                         "param_groups": meta["param_groups"]})


def broadcast_object(obj, root_rank: int = 0, name: Optional[str] = None):
    """Root's picklable ``obj`` on every rank."""
    basics._require_init()
    box = [obj]
    dist.broadcast_object_list(box, src=root_rank)
    return box[0]


def allgather_object(obj, name: Optional[str] = None) -> list:
    """One picklable object per rank, in rank order."""
    basics._require_init()
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out
