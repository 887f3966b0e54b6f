"""Expert parallelism: switch-style MoE FFN over the ep axis.

The counterpart of ``horovod_tpu/parallel/moe.py``: experts are sharded
across the ep axis, tokens are routed top-1 (switch transformer style)
with a fixed capacity per destination (static buffers, as the JAX
function's), dispatched to their expert's rank with an all-to-all,
transformed, and returned by the inverse all-to-all.

The dispatch wire (``wire=``): fp32, bf16, or block-scaled int8 with
stochastic rounding (``ops/traced.quantized_alltoall``, kernel B3;
dropped and pad slots are all-zero rows with a ``-1`` expert sentinel,
so they are excluded from every block scale by construction). ``hier=``
routes the exchange through the two-level recipe of
``traced.hierarchical_alltoall``: under a split, ``wire`` names the
inter hop and ``intra_wire`` (fp32, bf16) the intra legs. Routing is
computed on fp32 logits BEFORE any wire cast, so it is identical across
wires. On the lossy wires (bf16, int8) the cotangent rides the exact
inverse exchange (straight-through): stochastic rounding has no useful
gradient, and the exact exchange is the all-to-all's own transpose.
``wire="auto"`` needs the wire tuner (ROADMAP A12) and raises.

Every exchange is an autograd Function over the axis's process group,
so each rank differentiates its own program: the experts' gradients
arrive from every rank's tokens through the return exchange's backward.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..common import basics
from ..common import topology as topo_mod
from ..ops import traced
from .mesh import Axis, world_axis


class MoEParams(NamedTuple):
    router: torch.Tensor  # [D, E_total]
    w1: torch.Tensor  # [E_local, D, F]
    b1: torch.Tensor  # [E_local, F]
    w2: torch.Tensor  # [E_local, F, D]
    b2: torch.Tensor  # [E_local, D]


class MoEStats(NamedTuple):
    """Per-step expert-load counters, summed over the axis so that every
    rank holds the global view (the capacity tuner's feed, ROADMAP
    A12)."""

    expert_tokens: torch.Tensor  # [E_total] f32 — kept tokens per expert
    dropped: torch.Tensor  # scalar f32 — tokens past capacity (zero out)
    total: torch.Tensor  # scalar f32 — live tokens routed


def init_moe_params(generator: Optional[torch.Generator], d_model: int,
                    d_ff: int, n_experts_local: int, n_experts_total: int,
                    dtype=torch.float32, device=None) -> MoEParams:
    """Normal weights scaled by 1/√fan-in from ``generator`` (a
    ``torch.Generator`` on ``device``), zero biases."""
    def normal(*shape, fan):
        return (torch.randn(shape, generator=generator, device=device)
                / fan ** 0.5).to(dtype)

    return MoEParams(
        router=normal(d_model, n_experts_total, fan=d_model),
        w1=normal(n_experts_local, d_model, d_ff, fan=d_model),
        b1=torch.zeros((n_experts_local, d_ff), dtype=dtype, device=device),
        w2=normal(n_experts_local, d_ff, d_model, fan=d_ff),
        b2=torch.zeros((n_experts_local, d_model), dtype=dtype,
                       device=device),
    )


def hier_partitions(stages, axis: Axis):
    """``stages`` ``(intra, inter)`` in positions along ``axis`` mapped to
    global rank lists on every instance of the axis: two partitions of
    the ranks the axis covers, which ``traced.prepare_groups`` makes
    groups of."""
    intra, inter = stages
    return ([[inst[p] for p in g] for inst in axis.instances for g in intra],
            [[inst[p] for p in g] for inst in axis.instances for g in inter])


def _resolve_hier(hier, ep: int):
    """The two-level decision: explicit ``(intra, inter)`` stages pass
    through; None consults ``HOROVOD_HIERARCHICAL``; "on"/True force any
    resolvable split; "off"/False keep it flat."""
    if hier is None:
        return topo_mod.hierarchy_stages(world=ep)
    if hier in ("off", False):
        return None
    if hier in ("on", True):
        return topo_mod.hierarchy_stages(world=ep, mode="on")
    return hier


def _resolve_wire(wire, intra_wire):
    cfg = basics.live_config()
    wire = cfg.moe_wire if wire is None else wire
    intra_wire = cfg.moe_intra_wire if intra_wire is None else intra_wire
    if wire == "auto":
        raise NotImplementedError(
            "moe wire='auto' needs the wire tuner, not ported yet (ROADMAP "
            "A12's autotune); use fp32, bf16 or int8")
    if wire not in ("fp32", "bf16", "int8"):
        raise ValueError(
            f"moe wire must be fp32/bf16/int8/auto, got {wire!r}")
    if intra_wire not in ("fp32", "bf16"):
        raise ValueError(
            f"moe intra_wire must be fp32/bf16, got {intra_wire!r}")
    return wire, intra_wire


class _Wire:
    """One dispatch-shaped hop of the expert wire (``[k, C, ·]``) over
    the axis (``flat``), its two-level groups (``hier``) or a process
    set's group (``pset``)."""

    def __init__(self, axis: Axis, k: int, wire: str, intra_wire: str,
                 block: int, hier=None, pset=None):
        self.axis, self.k, self.wire, self.intra_wire = axis, k, wire, \
            intra_wire
        self.block, self.hier, self.pset = block, hier, pset

    def exact(self, buf: torch.Tensor) -> torch.Tensor:
        """The exact exchange (its own transpose)."""
        if self.pset is not None:
            if not self.pset.member:
                return buf
            return traced._all_to_all(buf, self.pset.group)
        if self.hier is not None:
            return traced.hierarchical_alltoall_in(buf, *self.hier)
        if self.axis.size == 1:
            return buf
        return traced._all_to_all(buf, self.axis.group)

    def lossy(self, buf: torch.Tensor, seed: int) -> torch.Tensor:
        """The forward exchange on the configured wire (float payloads)."""
        if self.pset is None and self.hier is not None:
            if self.wire == "fp32" and self.intra_wire == "fp32":
                return self.exact(buf)
            return traced.hierarchical_alltoall_in(
                buf, *self.hier, intra_wire=self.intra_wire,
                inter_wire=self.wire, seed=seed,
                block_size=self.block).to(buf.dtype)
        if self.wire == "fp32":
            return self.exact(buf)
        if self.wire == "int8" and self.pset is None:
            return traced.quantized_alltoall_in(
                buf, self.axis.group, self.k, seed, self.block).to(
                    buf.dtype)
        return self.exact(buf.to(torch.bfloat16)).to(buf.dtype)


class _Exchange(torch.autograd.Function):
    """The wire's forward; the exact inverse exchange backward (the
    straight-through rule on a lossy wire, the transpose on fp32)."""

    @staticmethod
    def forward(ctx, buf, wire, seed):
        ctx.wire = wire
        return wire.lossy(buf, seed)

    @staticmethod
    def backward(ctx, g):
        return ctx.wire.exact(g.contiguous()), None, None


def _keep_graph(x: torch.Tensor, flag: bool) -> torch.Tensor:
    """``x`` where ``flag``, else zeros — still in the autograd graph, so
    that every rank runs the exchanges' backward."""
    if flag:
        return x
    return torch.where(torch.tensor(flag, device=x.device), x,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def moe_ffn(
    params: MoEParams,
    x: torch.Tensor,
    axis: Optional[Axis] = None,
    capacity_factor: Optional[float] = None,
    wire: Optional[str] = None,
    intra_wire: Optional[str] = None,
    hier=None,
    seed: int = 0,
    block_size: Optional[int] = None,
    mask=None,
    process_set=None,
    return_stats: bool = False,
):
    """x: [T_local, D] tokens on this rank → [T_local, D].

    Routing: top-1 over E_total experts; expert e lives on position e //
    E_local of ``axis`` (default the world). Tokens over capacity are
    dropped (their output is zero and the residual connection carries
    them).

    ``capacity_factor`` (None = HOROVOD_MOE_CAPACITY_FACTOR) sizes the
    static per-destination buffer. ``wire`` ∈ {fp32, bf16, int8} (None =
    HOROVOD_MOE_WIRE) is the dispatch and return wire; with a two-level
    split (``hier``: ``(intra, inter)`` position lists along the axis,
    "on"/"off", or None for HOROVOD_HIERARCHICAL) it names the inter hop
    and ``intra_wire`` ∈ {fp32, bf16} the intra legs. Over a mesh axis
    narrower than the world the split's groups must exist first
    (``traced.prepare_groups(*hier_partitions(stages, axis))``, as the
    composed step does). The expert-index map always moves exact int32.
    ``seed`` decorrelates the stochastic rounding.

    ``mask`` is the join mask ([axis size] bool, ``mask[r] == False`` =
    position r ran out of data): a masked rank contributes no tokens
    (its output rows are zeros) while its experts keep serving the live
    ranks. ``process_set`` (over the world axis only) restricts routing
    to the member ranks' experts (non-members return zeros; the wire is
    the set's exact or bf16 alltoall — hier and int8 need the full
    axis). ``return_stats=True`` also returns :class:`MoEStats`.
    """
    axis = axis or world_axis()
    ep = axis.size
    t_local, d = x.shape
    e_local = params.w1.shape[0]
    e_total = e_local * ep
    dev = x.device
    cfg = basics.live_config()
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    if block_size is None:
        block_size = cfg.moe_wire_block

    info = traced._set_info(process_set)
    if info is not None and axis.ranks != tuple(range(dist.get_world_size())):
        raise NotImplementedError(
            "moe_ffn(process_set=) routes over the world axis only")
    member = True if info is None else info.member
    live = True if mask is None else bool(
        torch.as_tensor(mask, dtype=torch.bool)[axis.index])

    # participating-rank count and the wire
    k = info.size if info is not None else ep
    stages = None if info is not None else _resolve_hier(hier, ep)
    capacity = int(max(1, round(float(capacity_factor) * t_local / k)))
    wire, intra_wire = _resolve_wire(wire, intra_wire)
    if info is not None and wire == "int8":
        # the set's alltoall moves raw blocks; quantized + process set is
        # not a supported combination (as in the JAX function)
        wire = "fp32"
    hier_groups = None
    if stages is not None:
        if axis.ranks == tuple(range(dist.get_world_size())):
            intra, inter = stages
        else:
            intra, inter = hier_partitions(stages, axis)
        hier_groups = (traced._mine(intra), traced._mine(inter))
    link = _Wire(axis, k, wire, intra_wire, block_size, hier_groups, info)

    logits = x.float() @ params.router.float()
    if info is not None:
        # non-member ranks' experts are outside the set: route over
        # member experts only (set order = member rank order)
        owner = torch.arange(e_total, device=dev) // e_local
        allowed = torch.zeros(ep, dtype=torch.bool, device=dev)
        allowed[list(info.ranks)] = True
        logits = torch.where(allowed[owner][None, :], logits,
                             float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    expert_idx = probs.argmax(dim=-1)  # [T]
    gate = probs.gather(1, expert_idx[:, None])[:, 0]

    owner_rank = expert_idx // e_local
    if info is not None:
        pos_table = torch.zeros(ep, dtype=torch.long, device=dev)
        pos_table[list(info.ranks)] = torch.arange(info.size, device=dev)
        dest = pos_table[owner_rank]
    else:
        dest = owner_rank
    # position of each token within its destination's buffer
    onehot = F.one_hot(dest, k)
    my_pos = (onehot.cumsum(dim=0) - 1).gather(1, dest[:, None])[:, 0]
    keep = my_pos < capacity
    if not (member and live):
        keep = torch.zeros_like(keep)

    # Scatter the kept tokens into the zero-initialized [k, C, D]
    # dispatch buffer; empty slots stay zeros with a -1 expert sentinel
    # (the quantized wire's pad-exclusion contract).
    kept = keep.nonzero()[:, 0]
    slot = (dest[kept], my_pos[kept])
    dispatch = x.new_zeros((k, capacity, d)).index_put(slot, x[kept])
    token_expert = torch.full((k, capacity), -1, dtype=torch.int32,
                              device=dev).index_put(
        slot, (expert_idx[kept] % e_local).to(torch.int32))

    recv = _Exchange.apply(dispatch, link, seed).reshape(k * capacity, d)
    which = link.exact(token_expert[..., None]).reshape(k * capacity)

    # each local expert on its tokens: dense einsums over a one-hot
    # selector (no gather in the expert bank)
    valid = (which >= 0)[:, None]
    sel = (F.one_hot(which.long().clamp_min(0), e_local) * valid).to(
        recv.dtype)
    h = torch.einsum("nd,edf,ne->nf", recv, params.w1, sel)
    h = h + torch.einsum("ef,ne->nf", params.b1, sel)
    h = F.gelu(h, approximate="tanh")
    y = torch.einsum("nf,efd,ne->nd", h, params.w2, sel)
    y = y + torch.einsum("ed,ne->nd", params.b2, sel)
    # pad slots produce zeros, which also keeps them out of the return
    # wire's block scales
    y = y * valid

    y_back = _Exchange.apply(y.reshape(k, capacity, d).contiguous(), link,
                             seed + 0x9E37)
    # un-scatter: token i's result sits at [dest[i], my_pos[i]]
    out = y_back[torch.where(keep, dest, 0), torch.where(keep, my_pos, 0)]
    out = torch.where(keep[:, None], out, 0.0)
    out = (out * gate[:, None]).to(x.dtype)
    out = _keep_graph(out, member and live)
    if not return_stats:
        return out

    # expert-load counters, summed so that every rank holds the global
    # view: ``total`` counts live routed tokens, ``dropped`` the
    # capacity gate's losses among them
    routed = torch.full((t_local,), float(member and live), device=dev)
    kept_f = torch.where(keep, routed, 0.0)
    hist = (F.one_hot(expert_idx, e_total).float() * kept_f[:, None]).sum(0)
    packed = torch.cat([hist, (routed - kept_f).sum()[None],
                        routed.sum()[None]])
    if ep > 1:
        packed = packed.contiguous()
        dist.all_reduce(packed, group=axis.group)
    return out, MoEStats(expert_tokens=packed[:e_total],
                         dropped=packed[e_total], total=packed[e_total + 1])
