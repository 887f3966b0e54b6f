"""Ring attention: exact attention over sequences sharded across ranks.

The counterpart of ``horovod_tpu/parallel/ring_attention.py``: the
sequence is sharded over the sp axis and K/V blocks rotate around the
ring (:func:`~..ops._collectives.permute`, one shift a hop) while each
rank accumulates attention online, so it only ever holds seq_len/sp
keys. Differentiation is a second ring pass: the forward saves only (q,
k, v, out, lse), and the backward recomputes each block's probabilities
from the logsumexp and rotates (k, v) and (dk, dv) together, so every
gradient block arrives back at its owner having accumulated all ranks'
contributions. Both engines are ``torch.autograd.Function``s.

- :func:`ring_attention`, the dense ring: each hop's [B, H, Tq, Tk]
  scores in fp32, as the JAX scan (``ring_attention.py:53-196``);
  grouped-query inputs are repeated to full width outside the Function,
  so autograd sums the groups' dk/dv.
- :func:`ring_flash_attention`, the flash ring: each hop runs the flash
  forward kernel (``ops/flash_attention.flash_fwd``, B5), causal on the
  diagonal hop, non-causal on earlier hops and not at all on future ones,
  and merges the hops' normalized outputs by their logsumexps
  (``ring_attention.py:264-290``). The backward runs the flash backward
  kernels (``flash_bwd_dq``/``flash_bwd_dkv``, B6) a hop with the
  GLOBAL (o, lse) — ``p = exp(s − lse)`` against the global lse is that
  hop's share of the gradients — and the delta pass once a backward, its
  ``rowsum(dO ⊙ O)`` being the same for every hop. Grouped-query k/v go
  to the kernels as they are (their ``kv_heads``), never repeated.

The JAX ring rotates on the last hop too and masks future hops with
−inf; here the forward's last shift (nobody reads it) and future hops'
work are skipped, which changes no value: a masked block's correction
factor is exactly 1 and its probabilities exactly 0.

On CPU tensors the flash ring's kernels take their plain versions (the
wrappers' rule); on CUDA tensors a shape or dtype the kernels do not
take raises — the flash ring never falls back to the dense one.

The kernels' lse convention differs from the JAX ring's: a query row
with no live key gets −1e30 + log(1e−30) from a kernel, where a skipped
JAX hop carries −inf. The merge gives both weight 0.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops import flash_attention as fa
from ..ops._collectives import permute
from .mesh import Axis, world_axis

_DEAD = -1e29  # an lse at or below this carries no live key


def _shift(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` one step along the ring: rank j's lands on rank j+1."""
    if axis.size == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    permute(x, out, [(j + 1) % axis.size for j in range(axis.size)],
            axis.group)
    return out


def _check_heads(q, k, v):
    if v.shape[2] != k.shape[2] or q.shape[2] % k.shape[2]:
        raise ValueError(
            "kv heads must match and divide q heads: "
            f"q={q.shape[2]}, k={k.shape[2]}, v={v.shape[2]}"
        )


def _hops(axis: Axis, causal: bool):
    """``(hop, origin rank of the block held, diagonal?, live?)`` for
    each of the ring's hops on this rank."""
    for i in range(axis.size):
        src = (axis.index - i) % axis.size
        yield i, src, src == axis.index, not causal or src <= axis.index


# --------------------------------------------------------- the dense ring


def _block_scores(qf, k_cur, scale, diag_mask):
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k_cur.float()) * scale
    if diag_mask is not None:
        s = s.masked_fill(~diag_mask, float("-inf"))
    return s


def _causal_mask(t, device):
    r = torch.arange(t, device=device)
    return r[:, None] >= r[None, :]


def _dense_fwd_pass(q, k, v, axis: Axis, causal: bool):
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    tri = _causal_mask(t, q.device) if causal else None
    out = q.new_zeros((b, h, t, d), dtype=torch.float32)
    m = torch.full((b, h, t), float("-inf"), device=q.device)
    denom = torch.zeros((b, h, t), device=q.device)
    kv = torch.stack([k, v])
    for i, _, diag, live in _hops(axis, causal):
        if live:
            s = _block_scores(qf, kv[0], scale, tri if diag else None)
            new_m = torch.maximum(m, s.amax(dim=-1))
            # with causal masking a whole row of a block can be -inf
            safe_m = torch.where(torch.isfinite(new_m), new_m, 0.0)
            corr = torch.exp(torch.where(torch.isfinite(m), m - safe_m,
                                         float("-inf")))
            p = torch.exp(s - safe_m[..., None])
            denom = denom * corr + p.sum(dim=-1)
            out = out * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, kv[1].float())
            m = new_m
        if i < axis.size - 1:
            kv = _shift(kv, axis)
    denom_safe = denom.clamp_min(1e-30)
    out = out / denom_safe[..., None]
    lse = torch.where(torch.isfinite(m), m, 0.0) + torch.log(denom_safe)
    return out.permute(0, 2, 1, 3).to(q.dtype), lse


class _RingDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axis, causal):
        out, lse = _dense_fwd_pass(q, k, v, axis, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.axis, ctx.causal = axis, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        axis, causal = ctx.axis, ctx.causal
        b, t, h, d = q.shape
        scale = 1.0 / math.sqrt(d)
        qf, dof = q.float(), do.float()
        tri = _causal_mask(t, q.device) if causal else None
        delta = torch.einsum("bqhd,bqhd->bhq", dof, out.float())
        dq = torch.zeros((b, t, h, d), device=q.device)
        kv = torch.stack([k, v])
        dkv = torch.zeros((2,) + tuple(k.shape), device=q.device)
        for i, _, diag, live in _hops(axis, causal):
            if live:
                s = _block_scores(qf, kv[0], scale, tri if diag else None)
                p = torch.exp(s - lse[..., None])  # masked entries -> 0
                dp = torch.einsum("bqhd,bkhd->bhqk", dof, kv[1].float())
                ds = p * (dp - delta[..., None])
                dq = dq + scale * torch.einsum("bhqk,bkhd->bqhd", ds,
                                               kv[0].float())
                dkv = dkv + torch.stack([
                    scale * torch.einsum("bhqk,bqhd->bkhd", ds, qf),
                    torch.einsum("bhqk,bqhd->bkhd", p, dof)])
            if i < axis.size - 1:
                kv = _shift(kv, axis)
            # the gradient blocks travel WITH their K/V blocks; after sp
            # shifts every block is home with all contributions on board
            dkv = _shift(dkv, axis)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None)


def ring_attention(q, k, v, axis: Optional[Axis] = None,
                   causal: bool = False):
    """q, k, v: [B, T_local, H, Dh] (this rank's sequence shard along
    ``axis``, default the world).

    Returns [B, T_local, H, Dh] — exact softmax(QKᵀ)V over the full
    (sp·T_local)-token sequence, differentiable by the second ring pass.
    Grouped-query inputs (fewer kv heads) are repeated to full width
    here, outside the Function, so autograd group-sums dk/dv; use
    :func:`ring_flash_attention` to keep the shared-KV saving."""
    _check_heads(q, k, v)
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return _RingDense.apply(q, k, v, axis or world_axis(), causal)


# --------------------------------------------------------- the flash ring


def _rows(lse: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """``[b·h, t]`` → ``[b, t, h, 1]``, to weight ``[b, t, h, d]``."""
    return lse.view(b, h, -1).transpose(1, 2)[..., None]


def _merge(o_acc, lse_acc, o_i, lse_i):
    """Online merge of two normalized softmax partials: o = Σ w·o, w =
    exp(lse_part − lse), lse the logaddexp. A dead partial (−inf, or a
    kernel's −1e30 + log(1e−30)) weighs 0."""
    b, t, h, _ = o_acc.shape
    live_acc, live_i = lse_acc > _DEAD, lse_i > _DEAD
    ninf = float("-inf")
    m = torch.maximum(torch.where(live_acc, lse_acc, ninf),
                      torch.where(live_i, lse_i, ninf))
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    w_acc = torch.where(live_acc, torch.exp(lse_acc - m_safe), 0.0)
    w_i = torch.where(live_i, torch.exp(lse_i - m_safe), 0.0)
    denom = w_acc + w_i
    denom_safe = denom.clamp_min(1e-30)
    o = (o_acc * _rows(w_acc, b, h) + o_i.float() * _rows(w_i, b, h)) / (
        _rows(denom_safe, b, h))
    lse = torch.where(denom > 0, m_safe + torch.log(denom_safe), ninf)
    return o, lse


def _flash_fwd_pass(q, k, v, axis: Axis, causal: bool, plain: bool):
    fwd = fa.flash_fwd_plain if plain else fa.flash_fwd
    b, t, h, d = q.shape
    o = torch.zeros((b, t, h, d), device=q.device)
    lse = torch.full((b * h, t), float("-inf"), device=q.device)
    kv = torch.stack([k, v])
    for i, _, diag, live in _hops(axis, causal):
        if live:
            o_i, lse_i = fwd(q, kv[0], kv[1], causal and diag)
            o, lse = _merge(o, lse, o_i, lse_i)
        if i < axis.size - 1:
            kv = _shift(kv, axis)
    # every query attends to at least its own position under causal, so
    # lse is finite here; the guards only protect intermediates
    return o.to(q.dtype), lse


def _flash_hop_bwd(q, k, v, out, lse, do, causal, delta, plain):
    """One hop's (dq, dk, dv) from the global (out, lse): the dQ and
    dK/dV kernels on CUDA tensors (the delta pass ran once), the plain
    backward on CPU tensors or when asked for."""
    if plain or q.device.type != "cuda":
        return fa.flash_bwd_plain(q, k, v, out, lse, do, causal)
    a = fa._bwd_inputs(q, k, v, out, lse, do, causal, None, None)
    dk, dv = fa._dkv(a, delta)
    return fa._dq(a, delta), dk, dv


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axis, causal, plain):
        out, lse = _flash_fwd_pass(q, k, v, axis, causal, plain)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.axis, ctx.causal, ctx.plain = axis, causal, plain
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        axis, causal, plain = ctx.axis, ctx.causal, ctx.plain
        do = do.contiguous()
        delta = (fa.flash_bwd_delta(out, do) if q.is_cuda and not plain
                 else None)
        dq = torch.zeros(q.shape, device=q.device)
        kv = torch.stack([k, v])
        dkv = torch.zeros((2,) + tuple(k.shape), device=q.device)
        for i, _, diag, live in _hops(axis, causal):
            if live:
                dq_i, dk_i, dv_i = _flash_hop_bwd(
                    q, kv[0], kv[1], out, lse, do, causal and diag, delta,
                    plain)
                dq = dq + dq_i.float()
                dkv = dkv + torch.stack([dk_i.float(), dv_i.float()])
            if i < axis.size - 1:
                kv = _shift(kv, axis)
            dkv = _shift(dkv, axis)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None)


def ring_flash_attention(q, k, v, axis: Optional[Axis] = None,
                         causal: bool = False):
    """:func:`ring_attention` with the flash kernels as the block engine:
    the same exact math and [B, T_local, H, Dh] contract, but no hop
    materializes a score matrix — per-hop memory is O(T_local·Dh).

    Grouped-query attention: k/v may carry fewer heads than q (q heads %
    kv heads == 0) — the per-hop kernels read shared KV rows directly,
    so long-context GQA rides the ring without a head repeat."""
    _check_heads(q, k, v)
    return _RingFlash.apply(q, k, v, axis or world_axis(), causal, False)


def ring_flash_attention_plain(q, k, v, axis: Optional[Axis] = None,
                               causal: bool = False):
    """:func:`ring_flash_attention` with each hop's kernels replaced by
    their plain PyTorch versions (``flash_fwd_plain``,
    ``flash_bwd_plain``) on any device: the twin that the kernels are
    held against on the card."""
    _check_heads(q, k, v)
    return _RingFlash.apply(q, k, v, axis or world_axis(), causal, True)
