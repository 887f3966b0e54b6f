"""The flagship distributed model: a causal transformer trained with
dp × pp × ep × sp × tp parallelism composed over one mesh.

The counterpart of ``horovod_tpu/parallel/transformer.py``, whose step
is one ``shard_map`` program. Here every rank runs its own program on
its shards and meets the others in the mesh's process groups
(:mod:`.mesh`):

- dp: batch sharded; gradients summed over the data axes.
- pp: layers split into stages, GPipe (:func:`.pipeline.gpipe`,
  differentiated by autograd) or 1F1B (:func:`.pipeline.pipeline_1f1b`,
  the default at pp > 1; the MoE+head tail runs per microbatch there,
  with per-microbatch expert capacity).
- sp: sequence sharded; exact attention by the dense or the flash ring
  (:mod:`.ring_attention`).
- tp: heads and FFN sharded Megatron-style (:mod:`.tp`), the head
  vocab-parallel.
- ep: a switch-MoE FFN block after the pipelined stack, tokens routed
  across ep (:mod:`.moe`).

Data layout: the batch is sharded over (dp, ep) — ep acts as more data
parallelism for the dense layers, and the MoE block's all-to-all routes
each shard's tokens to their experts — and the sequence over sp.

Gradient synchronization. The JAX step divides sharded leaves'
gradients by the sizes of their pp, ep and tp axes and scales 1F1B's
stage gradients by pp, because shard_map transposes psum to psum and so
over-counts cotangents. Autograd through the conjugate Functions of this
port (Megatron's f and g in :mod:`.tp`, the ring's second pass, the
expert exchanges' transposes) does not over-count: after the backward
every rank holds the whole gradient of its tp- and pp-replicated leaves
and the exact gradient of its shards, over the tokens of its own data
shard. So the rule here is

    for each leaf with partition spec S:
      g ← Σ over the data axes (dp, ep, sp) NOT in S of g,
          divided by dp·ep·sp (the loss is the mean over data shards)

— an expert-sharded leaf already gathered every ep rank's tokens through
the return exchange's backward, so it sums over dp and sp only. The
pp-replicated leaves (embeddings, tail) are made whole on every stage
first: the 1F1B tail's gradients and input cotangents are summed over
pp (as the JAX pipeline does), and the embeddings' gradient of the GPipe
path, which only stage 0 computes. One SGD step then lands every
factorization on the dp-only mesh's parameters (the tests hold it to
that and to the JAX step).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from ..common.config import resolve_device
from ..ops import flash_attention as fa
from ..ops import traced
from .mesh import Axis, Mesh
from .moe import MoEParams, MoEStats, _resolve_hier, hier_partitions, \
    init_moe_params, moe_ffn
from .pipeline import gpipe, pipeline_1f1b
from .ring_attention import ring_attention, ring_flash_attention
from .tp import column_parallel_dense, copy_to, reduce_from, \
    row_parallel_dense


@dataclasses.dataclass(frozen=True)
class ParallelTransformerConfig:
    vocab_size: int = 256
    num_layers: int = 4  # total; must divide by pp
    d_model: int = 64
    num_heads: int = 4  # must divide by tp
    d_ff: int = 128  # must divide by tp
    max_len: int = 128
    n_experts: int = 4  # total; must divide by ep
    moe_capacity_factor: float = 2.0
    # Expert wire (parallel/moe.py): None defers to HOROVOD_MOE_WIRE;
    # "int8" rides the block-scaled quantized wire. moe_hier routes the
    # exchange two-level (None = the HOROVOD_HIERARCHICAL decision,
    # "on"/"off", or explicit (intra, inter) position lists along ep);
    # under a split moe_wire names the inter hop and moe_intra_wire the
    # intra legs.
    moe_wire: Any = None
    moe_intra_wire: Any = None
    moe_hier: Any = None
    n_microbatches: int = 2
    # the compute dtype; the parameters are fp32 masters cast to it at
    # use, as the port's Transformer keeps them (the JAX step stores
    # them in it, where an SGD step rounds bf16 updates below a weight's
    # last place away)
    dtype: torch.dtype = torch.float32
    learning_rate: float = 1e-2
    # SP attention engine. "auto": the flash ring on CUDA when the
    # kernels take the head_dim and dtype, the dense ring otherwise. True
    # forces the flash ring (the kernels' plain versions on CPU tensors;
    # a shape the kernels do not take raises on CUDA), False the dense.
    flash_ring: Any = "auto"
    # Rotary position embeddings instead of the learned position table:
    # the rotation offset is this shard's global start (sp index ·
    # t_local).
    rope: bool = False
    # "1f1b" (default at pp > 1): the bounded-memory schedule, the
    # MoE+head tail per microbatch; "gpipe": autograd through the
    # fill/drain schedule. pp = 1 always takes the gpipe path (nothing
    # to schedule; full-batch expert capacity).
    pipeline_schedule: str = "1f1b"


Params = Dict[str, Any]
DATA_AXES = ("dp", "ep", "sp")  # batch over dp+ep, sequence over sp


class _Axes(NamedTuple):
    """This rank's axes of the mesh, by name."""

    pp: Axis
    ep: Axis
    sp: Axis
    tp: Axis


def _init_full_params(cfg: ParallelTransformerConfig,
                      generator: Optional[torch.Generator] = None,
                      device=None) -> Params:
    """Full (unsharded) fp32 parameters from ``generator``: normal ×
    0.02 weights, unit LayerNorm scales, zero biases, as the JAX
    init."""
    d, f, h = cfg.d_model, cfg.d_ff, cfg.num_heads
    hd = d // h
    L, V = cfg.num_layers, cfg.vocab_size
    dt = torch.float32

    def normal(*shape):
        return (torch.randn(shape, generator=generator, device=device)
                * 0.02).to(dt)

    def const(fill, *shape):
        return torch.full(shape, fill, dtype=dt, device=device)

    return {
        "embed": {"tok": normal(V, d), "pos": normal(cfg.max_len, d)},
        "stages": {
            # leading axis L: layer-stacked, split into pp stages
            "ln1_scale": const(1.0, L, d),
            "ln1_bias": const(0.0, L, d),
            "wqkv": normal(L, d, 3, h, hd),
            "wo": normal(L, h, hd, d),
            "ln2_scale": const(1.0, L, d),
            "ln2_bias": const(0.0, L, d),
            "w1": normal(L, d, f),
            "b1": const(0.0, L, f),
            "w2": normal(L, f, d),
            "b2": const(0.0, L, d),
        },
        "tail": {
            "lnf_scale": const(1.0, d),
            "lnf_bias": const(0.0, d),
            "lm_head": normal(d, V),
            "moe": init_moe_params(generator, d, f, cfg.n_experts,
                                   cfg.n_experts, dtype=dt, device=device),
        },
    }


def param_specs(cfg: ParallelTransformerConfig) -> Params:
    """How each leaf shards over the mesh: a tuple a leaf, one mesh axis
    (or None) a dimension, as the JAX PartitionSpecs."""
    return {
        "embed": {"tok": (), "pos": ()},
        "stages": {
            "ln1_scale": ("pp",),
            "ln1_bias": ("pp",),
            "wqkv": ("pp", None, None, "tp", None),
            "wo": ("pp", "tp", None, None),
            "ln2_scale": ("pp",),
            "ln2_bias": ("pp",),
            "w1": ("pp", None, "tp"),
            "b1": ("pp", "tp"),
            "w2": ("pp", "tp", None),
            "b2": ("pp",),
        },
        "tail": {
            "lnf_scale": (),
            "lnf_bias": (),
            "lm_head": (None, "tp"),  # vocab-parallel head (see loss)
            "moe": MoEParams(router=(), w1=("ep",), b1=("ep",),
                             w2=("ep",), b2=("ep",)),
        },
    }


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def _tree_map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a parameter tree and its specs, matched by
    key; the result has the specs' key order."""
    if isinstance(specs, dict):
        return {k: _tree_map_specs(fn, tree[k], s) for k, s in specs.items()}
    if hasattr(specs, "_fields"):
        return type(specs)(*(
            _tree_map_specs(fn, getattr(tree, f), getattr(specs, f))
            for f in specs._fields))
    return fn(tree, specs)


def shard_leaf(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the full leaf ``x`` under ``spec``."""
    for dim, name in enumerate(spec):
        if name is not None:
            n = mesh.size(name)
            step = x.shape[dim] // n
            x = x.narrow(dim, mesh.coords[name] * step, step)
    return x.contiguous().clone()


def shard_params(full: Params, cfg: ParallelTransformerConfig,
                 mesh: Mesh) -> Params:
    """This rank's shards of the full parameter tree (``param_specs``)."""
    return _tree_map_specs(lambda x, s: shard_leaf(x, s, mesh), full,
                           param_specs(cfg))


def make_sharded_params(cfg: ParallelTransformerConfig, mesh: Mesh,
                        generator: Optional[torch.Generator] = None,
                        device=None) -> Params:
    """The full init from ``generator`` (every rank draws the same tree
    from the same seed), cut to this rank's shards, on ``device`` (the
    card unless ``"cpu"`` is passed)."""
    dev = resolve_device(device)
    return shard_params(_init_full_params(cfg, generator, dev), cfg, mesh)


def _layer_norm(x, scale, bias):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-5) * scale + bias).to(x.dtype)


def _block(layer, x, ax: _Axes, use_flash_ring=False, rope=False):
    """One transformer block on this rank: heads and FFN tp-sharded,
    the sequence sp-sharded (the ring covers the full context)."""
    from ..models.transformer import apply_rope

    h = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"])
    qkv = torch.einsum("btd,dchx->btchx", copy_to(h, ax.tp), layer["wqkv"])
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # [B,T,H/tp,hd]
    if rope:
        offset = ax.sp.index * x.shape[1]
        q = apply_rope(q, offset=offset)
        k = apply_rope(k, offset=offset)
    attn_fn = ring_flash_attention if use_flash_ring else ring_attention
    attn = attn_fn(q, k, v, axis=ax.sp, causal=True)
    proj = torch.einsum("bthx,hxd->btd", attn, layer["wo"])
    x = x + reduce_from(proj, ax.tp)
    h = _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"])
    h = column_parallel_dense(h, layer["w1"], layer["b1"], axis=ax.tp)
    h = F.gelu(h, approximate="tanh")
    h = row_parallel_dense(h, layer["w2"], axis=ax.tp)
    return x + h + layer["b2"]


def _resolve_flash_ring(cfg: ParallelTransformerConfig,
                        device: torch.device) -> bool:
    """The engine: "auto" takes the flash ring where the kernels take
    the head_dim and dtype on a CUDA device."""
    if cfg.flash_ring == "auto":
        return (torch.device(device).type == "cuda"
                and cfg.dtype in fa.DTYPE_CODES
                and fa.unsupported_reason(cfg.d_model // cfg.num_heads)
                is None)
    return bool(cfg.flash_ring)


def _cast(tree, dtype):
    """Every leaf in ``dtype`` (differentiably; a no-op when it is)."""
    return pytree.tree_map(lambda p: p.to(dtype), tree)


def _stage_fn(stage_params, x, ax: _Axes, use_flash_ring=False,
              rope=False):
    """Apply this pp stage's layer stack, in ``x``'s dtype."""
    stage_params = _cast(stage_params, x.dtype)
    for i in range(stage_params["wqkv"].shape[0]):
        layer = {k: p[i] for k, p in stage_params.items()}
        x = _block(layer, x, ax, use_flash_ring, rope)
    return x


def _embed(embed_params, tokens, cfg: ParallelTransformerConfig,
           sp_index: int):
    """Token (+ learned position, unless RoPE) embedding. tokens:
    [B_local, T_local] -> [B_local, T_local, d]."""
    t_local = tokens.shape[1]
    embed_params = _cast(embed_params, cfg.dtype)
    x = embed_params["tok"][tokens]
    if not cfg.rope:
        start = sp_index * t_local
        x = x + embed_params["pos"][start:start + t_local][None]
    return x


def _tail_loss(tail_params, x, labels, cfg: ParallelTransformerConfig,
               ax: _Axes, sink=None):
    """MoE block + final norm + vocab-parallel cross-entropy over the
    stack's output. x: [B, T_local, d], labels: [B, T_local] -> scalar
    (this rank's mean; the data-axis reduction is the caller's). A
    ``sink`` list takes the MoE block's :class:`~.moe.MoEStats`."""
    b, t_local = labels.shape
    tail_params = _cast(tail_params, cfg.dtype)
    # expert-parallel MoE block (switch-style) + residual
    flat = x.reshape(b * t_local, -1)
    y = moe_ffn(
        tail_params["moe"], flat, axis=ax.ep,
        capacity_factor=cfg.moe_capacity_factor, wire=cfg.moe_wire,
        intra_wire=cfg.moe_intra_wire, hier=cfg.moe_hier,
        return_stats=sink is not None,
    )
    if sink is not None:
        y, st = y
        sink.append(MoEStats(*(t.detach() for t in st)))
    x = x + y.reshape(x.shape)
    x = _layer_norm(x, tail_params["lnf_scale"], tail_params["lnf_bias"])
    # Vocab-parallel cross-entropy: each tp member computes only its
    # (bt, V/tp) logit shard, and the softmax statistics cross the axis
    # as scalars per token (the max, the scaled expsum, the target
    # logit); full-vocabulary logits never exist on any rank.
    head = tail_params["lm_head"]  # local shard: [d, V/tp]
    v_local = head.shape[1]
    logits = torch.einsum("btd,dv->btv", copy_to(x.float(), ax.tp),
                          head.float())
    # the stability shift carries no gradient
    m = logits.detach().amax(dim=-1)
    if ax.tp.size > 1:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=ax.tp.group)
    s = reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1), ax.tp)
    lse = m + torch.log(s)
    local = labels - ax.tp.index * v_local
    hit = (local >= 0) & (local < v_local)
    idx = local.clamp(0, v_local - 1)
    target = reduce_from(
        torch.where(hit, logits.gather(-1, idx[..., None])[..., 0], 0.0),
        ax.tp)
    return (lse - target).mean()


def _pick_n_micro(b_local: int, want: int) -> int:
    """Largest microbatch count <= want that divides the local batch."""
    n = min(want, b_local)
    while b_local % n:
        n -= 1
    return n


def _spec_axes(spec) -> set:
    """Mesh axes a spec shards over."""
    return {a for a in spec if a is not None}


def _sync_grads(grads, specs, mesh: Mesh):
    """The module docstring's rule: a sum over each leaf's unsharded data
    axes, bucketed by (axes, dtype) into one all-reduce each, divided by
    the data-shard count."""
    n_data = math.prod(mesh.size(a) for a in DATA_AXES)
    leaves, treedef = pytree.tree_flatten(grads)
    spec_leaves = pytree.tree_flatten(specs, is_leaf=_is_spec)[0]
    buckets: Dict[tuple, list] = {}
    for i, spec in enumerate(spec_leaves):
        axes = tuple(a for a in DATA_AXES if a not in _spec_axes(spec))
        buckets.setdefault((axes, str(leaves[i].dtype)), []).append(i)
    out = list(leaves)
    for (axes, _), idx in sorted(buckets.items()):
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        group = mesh.axis(*axes) if axes else None
        if group is not None and group.size > 1:
            dist.all_reduce(flat, group=group.group)
        flat = flat / n_data
        off = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = flat[off:off + n].view(leaves[i].shape)
            off += n
    return pytree.tree_unflatten(out, treedef)


def _leaves_requiring_grad(tree):
    return pytree.tree_map(lambda p: p.detach().requires_grad_(), tree)


def _sum_over(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    if axis.size > 1:
        x = x.contiguous()
        dist.all_reduce(x, group=axis.group)
    return x


def make_train_step(cfg: ParallelTransformerConfig, mesh: Mesh,
                    device=None, moe_stats: bool = False):
    """The full train step over ``mesh`` for this rank: forward,
    backward, gradient sync on every axis, SGD update. Returns
    ``step(params, tokens, labels, capacity_factor=None) -> (params,
    loss)``: ``params`` this rank's shards (``make_sharded_params``),
    ``tokens``/``labels`` the GLOBAL ``[batch, seq]`` batch (every rank
    passes the same; the step takes its own (dp, ep) batch block and sp
    sequence block), ``loss`` the global mean; ``capacity_factor``
    overrides ``cfg.moe_capacity_factor`` for the step (the capacity
    harness, ``moe.tune_capacity``). Runs on the card unless
    ``device="cpu"``. ``step.stats`` holds the last 1F1B step's schedule
    readings (``ticks``, ``stash_peak``, ``n_micro``,
    ``max_in_flight``); with ``moe_stats=True`` ``step.moe_stats`` holds
    the last step's :class:`~.moe.MoEStats`, summed over the MoE block's
    calls (one a microbatch under 1F1B; None on a stage that runs no
    tail)."""
    dev = resolve_device(device)
    specs = param_specs(cfg)
    tp = mesh.size("tp")
    if cfg.vocab_size % tp:
        raise ValueError(
            f"vocab_size={cfg.vocab_size} must divide evenly over the "
            f"tp axis ({tp}) for the vocab-parallel head"
        )
    if cfg.pipeline_schedule not in ("1f1b", "gpipe"):
        raise ValueError(
            f"unknown pipeline_schedule {cfg.pipeline_schedule!r}"
        )
    if cfg.num_layers % mesh.size("pp"):
        raise ValueError(f"num_layers={cfg.num_layers} must divide by pp "
                         f"({mesh.size('pp')})")
    if not mesh.member:
        raise ValueError(f"rank {dist.get_rank()} is not on the mesh")
    # the expert wire's two-level groups, made now on every rank: a
    # group made lazily inside the step would deadlock the stages that
    # never reach the tail
    stages = _resolve_hier(cfg.moe_hier, mesh.size("ep"))
    if stages is not None:
        ep_axis = mesh.axis("ep")
        world = dist.get_world_size()
        if len(ep_axis.instances) * ep_axis.size != world:
            raise NotImplementedError(
                "a two-level expert wire needs a mesh over the whole world")
        if ep_axis.ranks == tuple(range(world)):
            traced.prepare_groups(stages)
        else:
            traced.prepare_groups(hier_partitions(stages, ep_axis))
    ax = _Axes(*(mesh.axis(a) for a in ("pp", "ep", "sp", "tp")))
    # the tail's configuration this step and the MoEStats it collects
    tail = {"cfg": cfg, "sink": [] if moe_stats else None}
    use_flash_ring = _resolve_flash_ring(cfg, dev)
    stage_fn = functools.partial(_stage_fn, ax=ax,
                                 use_flash_ring=use_flash_ring,
                                 rope=cfg.rope)
    n_batch = mesh.size("dp") * mesh.size("ep")
    b_index = mesh.coords["dp"] * mesh.size("ep") + mesh.coords["ep"]

    def local(batch):
        batch = torch.as_tensor(batch, device=dev).long()
        b, t = batch.shape
        bl, tl = b // n_batch, t // ax.sp.size
        return batch[b_index * bl:(b_index + 1) * bl,
                     ax.sp.index * tl:(ax.sp.index + 1) * tl]

    def grads_gpipe(params, tokens, labels):
        """Autograd through the GPipe schedule: the tail runs on every
        stage on the last stage's output (summed over pp), so its
        gradients are whole everywhere; only stage 0 holds the
        embeddings' gradient, summed over pp after."""
        p = _leaves_requiring_grad(params)
        t_local = tokens.shape[1]
        with torch.enable_grad():
            x = _embed(p["embed"], tokens, cfg, ax.sp.index)
            b_local = x.shape[0]
            n_micro = _pick_n_micro(b_local, cfg.n_microbatches)
            xm = x.reshape(n_micro, b_local // n_micro, t_local, -1)
            out = gpipe(stage_fn, p["stages"], xm, axis=ax.pp)
            out = reduce_from(out, ax.pp).reshape(b_local, t_local, -1)
            loss = _tail_loss(p["tail"], out, labels, tail["cfg"], ax,
                              tail["sink"])
            leaves, treedef = pytree.tree_flatten(p)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = pytree.tree_unflatten(
            [torch.zeros_like(x_) if g is None else g
             for x_, g in zip(leaves, grads)], treedef)
        grads["embed"] = pytree.tree_map(lambda g: _sum_over(g, ax.pp),
                                         grads["embed"])
        return loss.detach(), grads

    def grads_1f1b(params, tokens, labels):
        """The bounded-memory 1F1B schedule: the embeddings under
        autograd in front, the stage stack inside ``pipeline_1f1b``, the
        MoE+head tail as its parameterized loss (per-microbatch expert
        capacity). The input cotangents live on stage 0 and are summed
        over pp, so that every stage computes the same embedding
        gradient."""
        t_local = tokens.shape[1]
        pe = _leaves_requiring_grad(params["embed"])
        with torch.enable_grad():
            x = _embed(pe, tokens, cfg, ax.sp.index)
        b_local = x.shape[0]
        n_micro = _pick_n_micro(b_local, cfg.n_microbatches)
        xm = x.detach().reshape(n_micro, b_local // n_micro, t_local, -1)
        lm = labels.reshape(n_micro, b_local // n_micro, t_local)
        stats = {}
        loss, stage_grads, tail_grads, dxm = pipeline_1f1b(
            stage_fn,
            lambda tp_, y, tgt: _tail_loss(tp_, y, tgt, tail["cfg"], ax,
                                           tail["sink"]),
            params["stages"], xm, lm, axis=ax.pp,
            loss_params=params["tail"], return_dx=True, stats=stats)
        step.stats = dict(stats, n_micro=n_micro)
        dx = _sum_over(dxm, ax.pp).reshape(x.shape)
        leaves, treedef = pytree.tree_flatten(pe)
        embed_grads = torch.autograd.grad(x, leaves, dx.to(x.dtype))
        grads = {"embed": pytree.tree_unflatten(list(embed_grads), treedef),
                 "stages": stage_grads, "tail": tail_grads}
        return loss, grads

    grads_fn = (grads_1f1b if cfg.pipeline_schedule == "1f1b"
                and ax.pp.size > 1 else grads_gpipe)
    data = mesh.axis(*DATA_AXES)
    n_data = data.size

    def step(params, tokens, labels, capacity_factor=None):
        tail["cfg"] = cfg if capacity_factor is None else dataclasses.replace(
            cfg, moe_capacity_factor=float(capacity_factor))
        if moe_stats:
            tail["sink"].clear()
        loss, grads = grads_fn(params, local(tokens), local(labels))
        if moe_stats:
            sink = tail["sink"]
            step.moe_stats = MoEStats(*(
                torch.stack([getattr(s, f) for s in sink]).sum(0)
                for f in MoEStats._fields)) if sink else None
        grads = _sync_grads(grads, specs, mesh)
        new = pytree.tree_map(
            lambda p, g: p.detach() - cfg.learning_rate * g.to(p.dtype),
            params, grads)
        loss = _sum_over(loss.detach().float().reshape(1), data)[0] / n_data
        return new, loss

    step.stats = {}
    step.moe_stats = None
    return step

