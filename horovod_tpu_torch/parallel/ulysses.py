"""Ulysses-style all-to-all sequence parallelism.

The counterpart of ``horovod_tpu/parallel/ulysses.py``, the second of
the two long-context strategies (the first is ring attention): instead
of rotating K/V blocks around a ring, **exchange sequence shards for
head shards** with one all-to-all, run ordinary full-sequence attention
on each rank's subset of heads, and exchange back (DeepSpeed-Ulysses).

Communication: 3 all-to-alls in (q, k, v) + 1 out, each moving
(sp−1)/sp of a [B, T/sp, H, D] shard. Ulysses wins when heads ≥ sp and
the interconnect favors few large transfers; ring wins when H < sp or
memory for the full-sequence scores binds.

``seq_to_heads``/``heads_to_seq`` are ``all_to_all_single`` exchanges
over the axis's process group, each an autograd Function whose backward
is the other. The inner attention (``attn_fn=None``) is the flash
kernels' :class:`~..ops.flash_attention.FlashAttentionFunction` (B5/B6)
on CUDA tensors whose head_dim and dtype the kernels take, and the dense
fp32-softmax attention otherwise; the JAX gate's Mosaic rungs (block
divisibility, the VMEM budget, the 8192-token cap) are gone, as the
kernels take any sequence length.

q/k/v: [batch, seq_local, heads, head_dim]; heads % sp == 0.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..ops import flash_attention as fa
from .mesh import Axis, world_axis


def _dense_attention(q, k, v, causal: bool):
    """fp32-softmax reference attention over [B, T, H, D]: fp32 scores,
    fp32 probability-value product, cast at the end. Grouped-query
    inputs (fewer kv heads) are repeated here — the flash path shares
    rows instead."""
    d = q.shape[-1]
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        t_q, t_k = s.shape[-2], s.shape[-1]
        rows = torch.arange(t_q, device=q.device)[:, None]
        cols = torch.arange(t_k, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _flash(q, k, v, causal: bool):
    return fa.FlashAttentionFunction.apply(q, k, v, None, causal, None)


def flash_takes(q: torch.Tensor) -> bool:
    """The auto gate: CUDA tensors of a dtype and head_dim the flash
    kernels take."""
    return (q.is_cuda and q.dtype in fa.DTYPE_CODES
            and fa.unsupported_reason(q.shape[-1]) is None)


def _exchange(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Equal dim-0 blocks to and from every member of the axis."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=axis.group)
    return out


def _seq_to_heads(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    # [B, T/sp, H, D] -> [B, T, H/sp, D]: head group j to rank j, every
    # rank's sequence shard collected in rank order
    b, t, h, d = x.shape
    sp = axis.size
    send = x.reshape(b, t, sp, h // sp, d).permute(2, 0, 1, 3, 4)
    recv = _exchange(send, axis)  # [sp (source), B, T/sp, H/sp, D]
    return recv.permute(1, 0, 2, 3, 4).reshape(b, sp * t, h // sp, d)


def _heads_to_seq(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    # [B, T, H/sp, D] -> [B, T/sp, H, D]: the inverse exchange
    b, t, hs, d = x.shape
    sp = axis.size
    send = x.reshape(b, sp, t // sp, hs, d).permute(1, 0, 2, 3, 4)
    recv = _exchange(send, axis)  # [sp (head group), B, T/sp, H/sp, D]
    return recv.permute(1, 2, 0, 3, 4).reshape(b, t // sp, sp * hs, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _seq_to_heads(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.axis), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _heads_to_seq(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.axis), None


def ulysses_attention(q, k, v, axis: Optional[Axis] = None,
                      causal: bool = False,
                      attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """All-to-all sequence-parallel attention over ``axis`` (default the
    world; module docstring).

    ``attn_fn(q, k, v, causal)`` runs the full-sequence attention on the
    head shard. None takes the flash kernels where :func:`flash_takes`
    (CUDA, a dtype and head_dim they take), the dense fp32-softmax
    attention otherwise. Pass a callable to override either way."""
    axis = axis or world_axis()
    sp = axis.size
    h, kv_h = q.shape[2], k.shape[2]
    if h % sp or kv_h % sp:
        # kv heads must ALSO split evenly (grouped-query inputs): each
        # rank then holds whole q-head groups, so the post-exchange
        # local q-head -> kv-head map stays the kernel's contiguous
        # x // (h/g) rule.
        raise ValueError(
            f"ulysses_attention needs q heads ({h}) and kv heads "
            f"({kv_h}) divisible by the sequence-parallel axis size "
            f"({sp}); use ring_attention for head-poor models"
        )
    if v.shape[2] != kv_h or h % kv_h:
        raise ValueError(
            "kv heads must match and divide q heads: "
            f"q={h}, k={kv_h}, v={v.shape[2]}"
        )
    if attn_fn is None:
        attn_fn = _flash if flash_takes(q) else _dense_attention
    if sp == 1:
        return attn_fn(q, k, v, causal).to(q.dtype)
    qg, kg, vg = (_SeqToHeads.apply(x, axis) for x in (q, k, v))
    out = attn_fn(qg, kg, vg, causal)
    return _HeadsToSeq.apply(out.to(q.dtype), axis)
