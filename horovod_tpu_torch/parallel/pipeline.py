"""Pipeline parallelism over the pp axis: GPipe and a 1F1B training
schedule with bounded activation memory.

The counterpart of ``horovod_tpu/parallel/pipeline.py``. Stages are
ranks along the pp axis, and activations hop stage → stage with
:func:`~..ops._collectives.permute`. Two schedules:

* :func:`gpipe` — fill/drain forward through the stages, differentiable
  by autograd: each hop is an autograd Function whose backward sends the
  gradient one stage back. Every stage runs every tick (on zeros when
  idle) and every permute output stays in the graph (``torch.where``
  with a tensor condition), so every rank runs every hop's backward in
  the same order. Its backward holds O(n_micro) activations: fine for a
  demo or inference, not the production training path.
* :func:`pipeline_1f1b` — the training schedule, on the same static
  tick tables as the JAX function (:func:`_build_1f1b_schedule`, copied
  and held equal to it by the tests). A stage stashes only its
  microbatch INPUTS (at most ``max_in_flight`` live, in ``max_in_flight
  + 1`` slots) and recomputes its forward under autograd at its
  backward tick, so the activation live-set is O(pp), never O(n_micro).
  Returns ``(loss, grads)`` directly.

Where the JAX schedule runs every stage on every tick (on zeros when
idle) so that collectives stay uniform across the mesh, here a stage
skips the work of an idle tick: every other axis's group (tp, sp, ep,
dp) lies inside one pp coordinate, whose ranks share the schedule. Only
the pp ring crosses stages, and every pp member calls its two shifts on
every tick (a gloo ``all_to_all_single`` moving nothing on a tick where
nothing is due).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..ops._collectives import permute
from .mesh import Axis, world_axis


def _ring(axis: Axis, step: int):
    return [(j + step) % axis.size for j in range(axis.size)]


class _Hop(torch.autograd.Function):
    """One stage → next-stage shift of :func:`gpipe`; the backward sends
    the gradient one stage back."""

    @staticmethod
    def forward(ctx, y, axis):
        ctx.axis = axis
        y = y.contiguous()
        out = torch.empty_like(y)
        permute(y, out, _ring(axis, 1), axis.group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        permute(g, out, _ring(ctx.axis, -1), ctx.axis.group)
        return out, None


def gpipe(stage_fn: Callable, stage_params, x_micro: torch.Tensor,
          axis: Optional[Axis] = None) -> torch.Tensor:
    """Run microbatches through the pipeline along ``axis`` (default the
    world).

    stage_fn(params, x) -> y: this rank's stage (shapes preserved).
    stage_params: this rank's stage parameters. x_micro: [n_micro, ...]
    microbatched input; only stage 0's copy is consumed.

    Returns [n_micro, ...] outputs, valid on the LAST stage (other stages
    return zeros, still in the autograd graph) — reduce over the axis if
    every stage needs them.
    """
    axis = axis or world_axis()
    pp, stage = axis.size, axis.index
    n_micro = x_micro.shape[0]
    total = n_micro + pp - 1  # fill + drain
    first = torch.tensor(stage == 0, device=x_micro.device)
    zeros = torch.zeros_like(x_micro[0])
    act = zeros
    outs = []
    for t in range(total):
        # stage 0 injects microbatch t (zeros once drained); the others
        # take what arrived over the ring
        inject = x_micro[t] if t < n_micro else zeros
        x_in = inject if pp == 1 else torch.where(first, inject, act)
        y = stage_fn(stage_params, x_in)
        if t >= pp - 1:  # microbatch t - (pp-1) completes on the last stage
            outs.append(y)
        if pp > 1 and t < total - 1:
            act = _Hop.apply(y, axis)
    out = torch.stack(outs)
    if pp == 1:
        return out
    last = torch.tensor(stage == pp - 1, device=out.device)
    return torch.where(last, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


# --------------------------------------------------------------- 1F1B


def _default_in_flight(pp: int) -> int:
    """Per-global-stage in-flight bound. 2·pp+1 is the full-throughput
    window of the combined-op model (a backward wave returns after
    ~2·hops ticks), measured to saturate the greedy schedule: stage
    time n+2(pp-1)+O(1) ticks vs ~2n under the classic pp bound —
    e.g. pp=4, n=32: 38 vs 59 ticks. Live inputs stay O(pp) (≤ ~1.5·pp
    per device measured), never O(n_micro)."""
    return 2 * pp + 1


def _build_1f1b_schedule(
    pp: int, n_micro: int, v: int = 1, cap: int = None
):
    """Static 1F1B tick tables (numpy, computed at trace time — pp,
    n_micro, and v are static). Combined-op variant: a DEVICE may do
    one forward AND one backward in the same tick (uniform compute per
    tick; see pipeline_1f1b).

    ``v`` > 1 is the Megatron-style INTERLEAVED schedule: v chunks of
    the layer stack per device, global stage g = c·pp + s living on
    device s = g % pp as chunk c = g // pp — acts still hop one device
    forward (the chunk boundary pp-1 -> 0 rides the same ring wrap),
    cotangents one device back. Measured effect (schedule simulator,
    stage-time = T/v ticks of full-stage work): pp=8, n=64: 78 (v=1)
    -> 75 (v=2) -> 73.5 (v=4) vs ideal 64 — a modest further fill
    reduction on top of the in-flight window (see _default_in_flight),
    bought with v-fold stash memory. The 1-tick-per-hop combined-op
    model cannot reach Megatron's (pp-1)/v fill exactly.

    Greedy under the 1F1B constraints, per global stage g:

    * F(g, m) needs F(g-1, m) from an earlier tick (act over the ring)
      and < cap microbatches in flight on g (the memory bound;
      default _default_in_flight(pp) = 2·pp+1);
    * B(g, m) needs B(g+1, m) from an earlier tick (cotangent over the
      ring), except the LAST global stage, which may do F(m) and B(m)
      in the SAME tick (its dy comes from its own loss, computed
      in-tick).

    Per tick a device picks its ready F and B by Megatron's wave order
    (microbatch group m//pp, then chunk — ascending for F, deepest
    first for B).

    Returns dict of int32 [T, pp] arrays:
      do_f/do_b (op masks), f_idx/b_idx (microbatch indices),
      f_c/b_c (chunk indices), ra_v/ra_s/ra_c (receive-activation
      valid + stash slot + chunk), rc_v/rc_s/rc_c (same, cotangent).
    """
    if n_micro < 1:
        raise ValueError("n_micro must be >= 1")
    if v < 1:
        raise ValueError("virtual_stages must be >= 1")
    if cap is None:
        cap = _default_in_flight(pp)
    N = v * pp  # global stages
    S = cap + 1  # stash slots/chunk; in-flight <= cap consecutive
    t_f = [[None] * n_micro for _ in range(N)]
    t_b = [[None] * n_micro for _ in range(N)]
    next_f = [0] * N
    next_b = [0] * N
    rows = []
    t = 0
    while any(nb < n_micro for nb in next_b):
        row = {
            k: [0] * pp
            for k in ("do_f", "f_idx", "f_c", "do_b", "b_idx", "b_c")
        }
        for s in range(pp):
            f_cands = []
            for c in range(v):
                g = c * pp + s
                m = next_f[g]
                if m >= n_micro:
                    continue
                if next_f[g] - next_b[g] >= cap:
                    continue
                if g > 0 and (
                    t_f[g - 1][m] is None or t_f[g - 1][m] >= t
                ):
                    continue
                f_cands.append(((m // pp, c, m % pp), m, c, g))
            if f_cands:
                _key, m, c, g = min(f_cands)
                row["do_f"][s] = 1
                row["f_idx"][s] = m
                row["f_c"][s] = c
                t_f[g][m] = t
                next_f[g] += 1
            b_cands = []
            for c in range(v):
                g = c * pp + s
                m = next_b[g]
                if m >= next_f[g]:
                    continue
                if g == N - 1:
                    if t_f[g][m] is None or t_f[g][m] > t:
                        continue  # same-tick F -> B allowed
                elif t_b[g + 1][m] is None or t_b[g + 1][m] >= t:
                    continue
                b_cands.append(((m // pp, -c, m % pp), m, c, g))
            if b_cands:
                _key, m, c, g = min(b_cands)
                row["do_b"][s] = 1
                row["b_idx"][s] = m
                row["b_c"][s] = c
                t_b[g][m] = t
                next_b[g] += 1
        rows.append(row)
        t += 1
        if t > 6 * (n_micro * v + N) + 16:
            raise AssertionError("1F1B schedule failed to converge")

    T = len(rows)
    out = {
        k: np.zeros((T, pp), np.int32)
        for k in (
            "do_f", "f_idx", "f_c", "do_b", "b_idx", "b_c",
            "ra_v", "ra_s", "ra_c", "rc_v", "rc_s", "rc_c",
        )
    }
    for t, row in enumerate(rows):
        for k in ("do_f", "f_idx", "f_c", "do_b", "b_idx", "b_c"):
            out[k][t] = row[k]
    # receive gating: what arrived over the ring THIS tick is whatever
    # the neighbor sent LAST tick. Device math: stage g+1 always lives
    # on device (g+1) % pp — one fwd hop — including the chunk-boundary
    # wrap pp-1 -> 0; symmetrically for cotangents.
    for t in range(1, T):
        prev = rows[t - 1]
        for s in range(pp):
            sprev = (s - 1) % pp
            if prev["do_f"][sprev]:
                g = prev["f_c"][sprev] * pp + sprev
                if g + 1 < N:  # the last stage sends nothing onward
                    out["ra_v"][t, s] = 1
                    out["ra_s"][t, s] = prev["f_idx"][sprev] % S
                    out["ra_c"][t, s] = (g + 1) // pp
            snext = (s + 1) % pp
            if prev["do_b"][snext]:
                g = prev["b_c"][snext] * pp + snext
                if g > 0:  # stage 0 sends no cotangent onward
                    out["rc_v"][t, s] = 1
                    out["rc_s"][t, s] = prev["b_idx"][snext] % S
                    out["rc_c"][t, s] = (g - 1) // pp
    return out


def _zeros_like_f32(tree):
    return pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        tree)


def _accumulate(acc, grads):
    leaves, spec = pytree.tree_flatten(acc)
    for a, g in zip(leaves, grads):
        if g is not None:
            a.add_(g.float())
    return pytree.tree_unflatten(leaves, spec)


def pipeline_1f1b(
    stage_fn: Callable,
    loss_fn: Callable,
    stage_params,
    x_micro: torch.Tensor,
    y_micro: torch.Tensor,
    axis: Optional[Axis] = None,
    loss_params=None,
    return_dx: bool = False,
    virtual_stages: int = 1,
    max_in_flight: Optional[int] = None,
    loss_collective_free: bool = False,
    stats: Optional[dict] = None,
):
    """1F1B pipeline TRAINING step along ``axis`` (default the world):
    returns ``(loss, grads)`` directly (``pipeline.py:254``).

    Each stage stashes only its microbatch inputs (at most
    ``max_in_flight`` live at once, default 2·pp+1) and recomputes its
    forward under autograd at its backward tick, so the activation
    live-set is bounded by the pipeline depth. Nothing differentiates
    through the schedule: the returned grads ARE the backward.

    stage_fn(params, x) -> y: this rank's stage; activation shapes are
        preserved across stages. It may hold collectives over the OTHER
        axes (tp, sp): their groups' ranks share this rank's schedule.
    loss_fn(y, target) -> scalar on the last stage's output per
        microbatch; with ``loss_params`` given, ``loss_fn(loss_params,
        y, target)`` — a parameterized tail (e.g. MoE block + final norm
        + head + loss) whose gradients are returned too. Its collectives
        (tp, ep) run among ranks of the last stage.
    stage_params: this rank's stage parameters (a pytree of tensors).
        With ``virtual_stages=v > 1`` every leaf carries a leading [v]
        chunk axis: chunk c on rank s is global stage c·pp + s (the
        Megatron interleaved layout), and the grads keep the [v] axis.
    x_micro, y_micro: [n_micro, ...] microbatched inputs and targets.
    max_in_flight: the per-global-stage microbatch window.
    loss_collective_free: accepted for the JAX signature. The tail runs
        only on the ticks where the final stage finishes a microbatch,
        declared or not (module docstring).
    return_dx: also return d(loss)/d(x_micro), [n_micro, ...], valid on
        stage 0 only (zeros elsewhere).
    stats: a dict that, when given, receives ``ticks`` (the schedule's
        length), ``stash_peak`` (the most stage inputs held at once) and
        ``max_in_flight``.

    Returns (loss, grads[, loss_grads][, dx_micro]) by position: the
    mean microbatch loss, identical on every stage (summed over the
    axis); THIS stage's parameter gradients of that mean loss;
    loss_params' gradients (accumulated on the last stage and summed
    over the axis so every stage holds them); dx when asked for.
    Gradients accumulate in fp32 and return in each parameter's dtype.
    """
    del loss_collective_free
    axis = axis or world_axis()
    pp, stage = axis.size, axis.index
    n_micro = x_micro.shape[0]
    v = int(virtual_stages)
    cap = _default_in_flight(pp) if max_in_flight is None else max_in_flight
    if cap < 1:
        raise ValueError(f"max_in_flight must be >= 1, got {cap}")
    S = cap + 1
    sched = _build_1f1b_schedule(pp, n_micro, v, cap)
    T = sched["do_f"].shape[0]
    N = v * pp
    table = {k: a[:, stage].tolist() for k, a in sched.items()}
    nxt, prv = (stage + 1) % pp, (stage - 1) % pp
    ra_next = sched["ra_v"][:, nxt].tolist()
    rc_prev = sched["rc_v"][:, prv].tolist()
    dtype, dev = x_micro.dtype, x_micro.device
    shape = tuple(x_micro.shape[1:])

    params = pytree.tree_map(lambda p: p.detach(), stage_params)
    chunks = ([params] if v == 1 else
              [pytree.tree_map(lambda p, c=c: p[c], params)
               for c in range(v)])
    gacc = [_zeros_like_f32(c) for c in chunks]
    lparams = (None if loss_params is None else
               pytree.tree_map(lambda p: p.detach(), loss_params))
    lacc = None if lparams is None else _zeros_like_f32(lparams)
    dx = torch.zeros(x_micro.shape, dtype=torch.float32, device=dev) \
        if return_dx else None
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    inbox_a, inbox_c, stash_x, stash_dy = {}, {}, {}, {}
    sent_a = sent_c = None
    peak = 0

    def shift(send, recv_slot, step):
        recv = None if recv_slot is None else torch.empty(
            shape, dtype=dtype, device=dev)
        if pp == 1:
            if recv is not None:
                recv.copy_(send)
        else:
            permute(send, recv, _ring(axis, step), axis.group, like=x_micro)
        return recv

    for t in range(T):
        row = {k: a[t] for k, a in table.items()}
        # the two rings, every tick: what each neighbour sent last tick
        got = shift(sent_a if ra_next[t] else None,
                    (row["ra_c"], row["ra_s"]) if row["ra_v"] else None, 1)
        if got is not None:
            inbox_a[(row["ra_c"], row["ra_s"])] = got
        got = shift(sent_c if rc_prev[t] else None,
                    (row["rc_c"], row["rc_s"]) if row["rc_v"] else None, -1)
        if got is not None:
            inbox_c[(row["rc_c"], row["rc_s"])] = got

        if row["do_f"]:  # ---- the forward micro-op
            c, m = row["f_c"], row["f_idx"]
            g = c * pp + stage
            x_in = x_micro[m] if g == 0 else inbox_a.pop((c, m % S))
            with torch.no_grad():
                y = stage_fn(chunks[c], x_in)
            stash_x[(c, m)] = x_in
            peak = max(peak, len(stash_x))
            if g == N - 1:  # the tail: loss and dy, in this tick
                with torch.enable_grad():
                    yy = y.detach().requires_grad_()
                    if lparams is None:
                        lm = loss_fn(yy, y_micro[m])
                        dys = torch.autograd.grad(lm, [yy])
                    else:
                        lp = pytree.tree_map(
                            lambda p: p.detach().requires_grad_(), lparams)
                        lm = loss_fn(lp, yy, y_micro[m])
                        dys = torch.autograd.grad(
                            lm, [yy] + pytree.tree_leaves(lp),
                            allow_unused=True)
                        lacc = _accumulate(lacc, dys[1:])
                loss = loss + lm.detach().float()
                stash_dy[m] = dys[0].to(dtype)
            else:
                sent_a = y

        if row["do_b"]:  # ---- the backward micro-op, recomputing
            c, m = row["b_c"], row["b_idx"]
            g = c * pp + stage
            x_b = stash_x.pop((c, m))
            dy = stash_dy.pop(m) if g == N - 1 else inbox_c.pop((c, m % S))
            want_dx = g > 0 or return_dx
            with torch.enable_grad():
                pc = pytree.tree_map(lambda p: p.detach().requires_grad_(),
                                     chunks[c])
                leaves = pytree.tree_leaves(pc)
                xb = x_b.detach().requires_grad_(want_dx)
                y = stage_fn(pc, xb)
                grads = torch.autograd.grad(
                    y, leaves + ([xb] if want_dx else []), dy.to(y.dtype),
                    allow_unused=True)
            gacc[c] = _accumulate(gacc[c], grads[:len(leaves)])
            if g > 0:
                sent_c = grads[-1]
            elif return_dx:
                dx[m] = grads[-1].float()

    if stats is not None:
        stats.update(ticks=T, stash_peak=peak, max_in_flight=cap)

    def reduce(x):
        if pp > 1:
            x = x.contiguous()
            torch.distributed.all_reduce(x, group=axis.group)
        return x

    loss = reduce(loss) / n_micro
    gacc = [pytree.tree_map(lambda a: a / n_micro, g) for g in gacc]
    if v == 1:
        grads = gacc[0]
    else:
        flat = [pytree.tree_flatten(g)[0] for g in gacc]
        spec = pytree.tree_flatten(gacc[0])[1]
        grads = pytree.tree_unflatten(
            [torch.stack(ls) for ls in zip(*flat)], spec)
    grads = pytree.tree_map(lambda gr, p: gr.to(p.dtype), grads, params)
    result = [loss, grads]
    if lparams is not None:
        # accumulated on the last stage only; summed so every stage
        # holds the tail's grads
        result.append(pytree.tree_map(
            lambda a, p: (reduce(a) / n_micro).to(p.dtype), lacc, lparams))
    if return_dx:
        result.append((dx / n_micro).to(dtype))
    return tuple(result)
