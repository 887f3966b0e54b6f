"""Local SGD: slices train on their own for K steps, then merge their
parameter deltas across slices with hierarchical Adasum.

The counterpart of ``horovod_tpu/local_sgd.py``. On the two-level split
(``(intra, inter)`` rank lists: slice h holds ranks ``h·L … h·L + L − 1``)
every gradient exchange of a local step stays inside the slice (the
intra group), and every K-th step a sync round merges each slice's
delta since the last round across slices (the inter group): VHDD Adasum
on 1/L chunks with each combine's dots completed over the intra group
(``ops/adasum.py``: :func:`adasum_sync_shard`), on the int8 wire (kernel
B3) with error-feedback residuals carried from round to round, or on
bf16 or fp32. The inter bytes drop about K-fold against an exchange
every step.

Three layers, as in the JAX package:

* **Phase routing**: :func:`local_phase` / :func:`active_intra_groups`.
  While a phase is active, the eager fusion manager
  (``ops/fusion.py``) reduces every Sum or Average batch with no join
  mask and no process set within its intra group. The optimizers
  (``DistributedOptimizer``/``ShardedDistributedOptimizer(
  local_sgd_steps=K)``) pass their intra groups to every exchange
  themselves.
* **The round's bodies**: :func:`sync_tree` (replicated parameters) and
  :func:`adasum_sync_shard` (intra-sharded deltas). Both return fresh
  tensors and change nothing: the optimizers' ``sync()`` /
  ``sync_round()`` commit what a round computed only once it is done.
* **The round driver**: :func:`run_round` / :func:`maybe_sync` /
  :func:`rejoin_sync`. An attempt passes the ``local_sgd.sync`` chaos
  site (``testing/chaos.py``); a retryable failure re-runs the round
  whole under a ``RetryPolicy`` (``common/retry.py``), and exhaustion
  defers the round (``local_sgd.rounds_deferred``): the local phase
  extends and training goes on.

Where the port differs from the JAX package: there, one controller runs
the round for every device, so a fault is everyone's. Here every rank is
a process, so an attempt first agrees its outcome over the world: after
the chaos site and before the round's first collective, one allreduce
(MAX) of a failure flag makes one rank's fault every rank's, and all
retry or defer together instead of leaving the others blocked inside the
VHDD. The default policy has no deadline, so that every rank's ladder
has the same number of attempts.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .common import basics
from .common import topology as _topo
from .common.logging import get_logger
from .common.metrics import registry as _metrics
from .common.retry import CircuitOpenError, RetryError, RetryPolicy
from .ops import adasum as _adasum
from .ops import traced
from .testing import chaos as _chaos

_log = get_logger("local_sgd")

#: wire formats the sync round's inter hop accepts
INTER_WIRES = ("fp32", "bf16", "int8")


def default_steps() -> int:
    """``HOROVOD_LOCAL_SGD_STEPS`` as ``hvd.init()`` read it (the
    environment before init): 1 is the every-step path, local SGD
    engages at K > 1."""
    st = basics.state()
    cfg = st.config if st.initialized else None
    if cfg is None:
        from .common.config import TrainConfig

        cfg = TrainConfig.from_env()
    return int(cfg.local_sgd_steps)


_env_warned = [False]


def warn_env_engaged(k: int) -> None:
    """One warning when the environment (not an explicit
    ``local_sgd_steps=``) switches an optimizer to local SGD: a loop
    that never drives the sync round trains diverged slices forever."""
    if _env_warned[0]:
        return
    _env_warned[0] = True
    import warnings

    warnings.warn(
        f"HOROVOD_LOCAL_SGD_STEPS={k} engaged local-SGD mode: gradient "
        "exchange is now INTRA-SLICE ONLY, and parameters only "
        "reconcile across slices when the training loop drives the "
        "sync round (hvd.local_sgd.maybe_sync every step, or "
        "opt.sync/sync_round every K-th). A loop that never syncs "
        "trains silently diverged slices. Pass local_sgd_steps= "
        "explicitly to silence this warning.",
        stacklevel=3,
    )


def resolve_stages(world: int, intra: Optional[int] = None):
    """The ``(intra, inter)`` split a local-SGD job trains over:
    ``topology.hierarchy_stages`` in mode ``on``, or an error when no
    split resolves (with one slice there is nothing to merge across)."""
    stages = _topo.hierarchy_stages(world=world, mode="on", intra=intra)
    if stages is None:
        raise ValueError(
            f"local_sgd_steps > 1 needs a resolvable two-level topology "
            f"(world={world}, intra={intra}): set HOROVOD_INTRA_SIZE "
            "(or pass local_sgd_intra=) on single-slice runtimes, or "
            "run on a multi-slice TPU — with one slice there is no "
            "inter (DCN) axis to reconcile across"
        )
    return stages


def engaged_steps(steps: Optional[int]) -> int:
    """An optimizer's K: ``steps``, or the environment's with one warning
    when that engages local SGD."""
    k = int(steps if steps is not None else default_steps())
    if steps is None and k > 1:
        warn_env_engaged(k)
    return k


def prepare_split(world: int, intra: Optional[int], inter_wire: str):
    """An optimizer's local split: checks the inter wire, resolves the
    stages (:func:`resolve_stages`) and makes their process groups now,
    collectively and in the same order on every rank (never inside a
    round)."""
    if inter_wire not in INTER_WIRES:
        raise ValueError(f"unknown local_sgd_inter_wire {inter_wire!r}")
    stages = resolve_stages(world, intra=intra)
    traced.prepare_groups(stages)
    return stages


# ------------------------------------------------------- phase routing
# The eager fusion manager serves hvd.allreduce calls from anywhere in
# the process, so the phase is a process-wide flag it reads when an
# entry is enqueued (the entry's fusion key carries the groups).

_phase = {"groups": None}


def _as_groups(stages):
    """The intra groups of a ``(intra, inter)`` pair, or of the intra
    rank lists alone."""
    nested = isinstance(stages[0][0], (list, tuple))
    return stages[0] if nested else stages


def set_local_phase(stages) -> None:
    """Route the eager fusion manager's eligible allreduces within their
    intra group until :func:`clear_local_phase`. ``stages`` is the
    ``(intra, inter)`` pair or the intra rank lists. With the world up,
    the groups' process groups are made now: every rank calls this."""
    groups = tuple(tuple(int(r) for r in g) for g in _as_groups(stages))
    if basics.state().initialized:
        traced.prepare_groups(groups)
    _phase["groups"] = groups


def clear_local_phase() -> None:
    _phase["groups"] = None


def active_intra_groups():
    """The intra groups of the active local phase, or None."""
    return _phase["groups"]


@contextlib.contextmanager
def local_phase(stages):
    """Scoped :func:`set_local_phase`::

        with hvd.local_sgd.local_phase(stages):
            hvd.allreduce(grad)   # reduces within the slice
    """
    set_local_phase(stages)
    try:
        yield
    finally:
        clear_local_phase()


def reset() -> None:
    """Drop the phase and the round policy (a restarted world resolves
    its own)."""
    clear_local_phase()
    _round_policy[0] = None


# ----------------------------------------------------- the round bodies


def adasum_sync_shard(shard, stages, inter_wire: str = "int8", seed: int = 0,
                      residual=None, return_residual: bool = False):
    """Merge one intra-position chunk of a slice's delta across slices
    (``ops.adasum.adasum_sync_shard``, keyed by the rank): the merged
    chunk, and with ``return_residual`` (int8) the new carry, for which
    ``quantized + residual' = shard + residual`` up to the rounding of
    the subtraction that makes ``residual'``."""
    return _adasum.adasum_sync_shard(
        shard, stages, inter_wire=inter_wire, seed=seed, residual=residual,
        return_residual=return_residual)


def sync_tree(params: Sequence[torch.Tensor], anchor: Sequence[torch.Tensor],
              residual: Optional[Sequence[torch.Tensor]] = None, stages=None,
              inter_wire: str = "int8", seed: int = 0,
              return_residual: bool = False):
    """The replicated optimizer's round: the deltas ``params − anchor``
    (each taken in the parameter's dtype, then fp32, as the JAX package
    takes them) merge across slices as one concatenated vector through
    :func:`~horovod_tpu_torch.ops.adasum.adasum_allreduce_groups`, and
    the new parameters are ``anchor + merged`` in fp32, cast back.
    Returns ``(new_params, new_residual or None)`` as fresh tensors; the
    caller re-anchors on ``new_params``. Only this rank's chunk of the
    deltas is ever built, and the new values land in the merged buffer
    (for fp32 parameters the new tensors are views of it), so a round
    holds about two model-sized fp32 buffers beyond its inputs."""
    if stages is None:
        raise ValueError("stages is required (resolve_stages)")
    params, anchor = list(params), list(anchor)
    offs = [0]
    for p in params:
        offs.append(offs[-1] + p.numel())

    def fill_with(value):
        def fill(lo, hi, out):
            for i in range(len(params)):
                s, e = max(lo, offs[i]), min(hi, offs[i + 1])
                if s < e:
                    out[s - lo:e - lo].copy_(value(i, s - offs[i],
                                                   e - offs[i]))
        return fill

    def delta(i, s, e):
        p = params[i].detach().reshape(-1)[s:e]
        return p - anchor[i].reshape(-1)[s:e].to(p.dtype)

    fill_r = None
    if residual is not None:
        fill_r = fill_with(lambda i, s, e: residual[i].reshape(-1)[s:e])
    want = return_residual and inter_wire == "int8"
    merged, new_r = _adasum.merge_groups(
        fill_with(delta), offs[-1], params[0].device, stages, inter_wire,
        seed, fill_r, want or fill_r is not None)
    new_p: List[torch.Tensor] = []
    new_res: List[torch.Tensor] = []
    for i, (p, a) in enumerate(zip(params, anchor)):
        d = merged[offs[i]:offs[i + 1]].view(p.shape)
        new_p.append(d.add_(a.to(torch.float32)).to(p.dtype))  # a + d
        if new_r is not None:
            new_res.append(new_r[offs[i]:offs[i + 1]].view(p.shape).to(
                p.dtype))
    return new_p, (new_res if new_r is not None else None)


# ------------------------------------------------------- the round driver

_round_policy = [None]


def _policy() -> RetryPolicy:
    """The process's policy for sync rounds (site ``local_sgd.sync``,
    ``HOROVOD_RETRY_*``), without a deadline: a deadline would let one
    rank's jittered backoff cut its ladder an attempt before another's."""
    if _round_policy[0] is None:
        _round_policy[0] = RetryPolicy.from_env("local_sgd.sync",
                                                deadline_s=0)
    return _round_policy[0]


class PeerRoundFault(ConnectionError):
    """Another rank's attempt at this sync round failed retryably: this
    rank fails the attempt with it, so that the world retries or defers
    the round together."""


def _agree(code: int) -> int:
    """The world's worst attempt outcome (0 ok, 1 retryable failure,
    2 fatal): one allreduce (MAX) of a 4-byte flag."""
    st = basics.state()
    if not st.initialized or dist.get_world_size() == 1:
        return code
    flag = torch.tensor([code], dtype=torch.int32, device=st.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return int(flag[0])


def round_inter_bytes(payload_bytes: int, stages,
                      inter_wire: str = "int8") -> int:
    """Modelled bytes a rank sends over the inter group in one round:
    the VHDD over H slices of the 1/L chunk at the inter wire's width
    (``ops.adasum.vhdd_wire_bytes``), ``payload_bytes`` of fp32."""
    intra_groups, inter_groups = stages
    L = len(intra_groups[0])
    H = len(inter_groups[0])
    elems = -(-int(payload_bytes) // 4)  # fp32 payload elements
    width = {"int8": 1, "bf16": 2}.get(inter_wire, 4)
    shard_wire_bytes = -(-elems // L) * width
    return _adasum.vhdd_wire_bytes(H, shard_wire_bytes)


def due(step: int, k: int) -> bool:
    """True on every K-th step (0-based ``step``; the round runs after
    the step that completes a window)."""
    return int(k) > 1 and (int(step) + 1) % int(k) == 0


def run_round(sync_step, *args, policy: Optional[RetryPolicy] = None,
              payload_bytes: Optional[int] = None, stages=None,
              inter_wire: str = "int8"):
    """Run one sync round, ``sync_step(*args)`` (an optimizer's
    ``sync``/``sync_round``), under the retry ladder. Each attempt passes
    the ``local_sgd.sync`` chaos site, agrees its outcome over the world
    (module docstring), then runs the round. Every rank calls it. A
    retryable failure re-runs the round whole; exhaustion defers it:
    ``(None, False)``, counted in ``local_sgd.rounds_deferred``. Success
    returns ``(result, True)``, counts ``local_sgd.sync_rounds`` and, with
    ``payload_bytes`` and ``stages``, adds :func:`round_inter_bytes` to
    ``local_sgd.inter_bytes``. ``sync_step`` must change nothing until it
    has computed the whole round, so that a failed attempt leaves no
    trace."""
    pol = policy if policy is not None else _policy()

    def _attempt():
        err = None
        try:
            _chaos.inject("local_sgd.sync")
        except Exception as e:  # noqa: BLE001 — classified and agreed
            err = e
        code = 0 if err is None else (1 if pol.is_retryable(err) else 2)
        worst = _agree(code)
        if err is not None:
            raise err
        if worst == 2:
            raise RuntimeError(
                "local_sgd.sync: another rank's attempt failed fatally")
        if worst == 1:
            raise PeerRoundFault(
                "local_sgd.sync: another rank's attempt failed")
        return sync_step(*args)

    try:
        out = pol.call(_attempt)
    except (RetryError, CircuitOpenError) as e:
        _metrics.counter("local_sgd.rounds_deferred")
        _log.warning(
            "local_sgd: sync round deferred (%s) — local phase "
            "extends, training continues on the intra wire", e,
        )
        return None, False
    _metrics.counter("local_sgd.sync_rounds")
    if payload_bytes is not None and stages is not None:
        _metrics.counter(
            "local_sgd.inter_bytes",
            round_inter_bytes(payload_bytes, stages, inter_wire),
        )
    return out, True


def maybe_sync(sync_step, *args, step: int, k: Optional[int] = None,
               policy: Optional[RetryPolicy] = None,
               payload_bytes: Optional[int] = None, stages=None,
               inter_wire: str = "int8"):
    """The cadence a local-SGD loop calls after every optimizer step::

        out, synced = hvd.local_sgd.maybe_sync(
            opt.sync, step=i, k=opt.local_sgd_steps)

    Counts ``local_sgd.local_steps`` every call and runs
    :func:`run_round` on every K-th step. Returns ``(result or None,
    synced)``."""
    if k is None:
        k = default_steps()
    _metrics.counter("local_sgd.local_steps")
    if not due(step, k):
        return None, False
    return run_round(sync_step, *args, policy=policy,
                     payload_bytes=payload_bytes, stages=stages,
                     inter_wire=inter_wire)


def rejoin_sync(sync_step, *args, policy: Optional[RetryPolicy] = None):
    """One immediate round after a membership change, in place of a
    broadcast of root's parameters: a slice restored at the last anchor
    brings a zero delta (Adasum's identity), so the round hands it the
    other slices' merged progress. Retry and defer as
    :func:`run_round`'s."""
    return run_round(sync_step, *args, policy=policy)
