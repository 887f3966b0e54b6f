"""GPT-2-style Transformer in PyTorch: the model the port trains and
serves.

The counterpart of ``horovod_tpu/models/transformer.py``: the same
configuration, the same parameter layout (``DenseGeneral`` kernels keep
the Flax shapes, so :mod:`.convert` carries a JAX checkpoint across by
name) and the same numerics: parameters in fp32, cast to ``cfg.dtype``
at use; LayerNorm in fp32 with eps 1e-6; tanh GELU; attention scores as
an fp32 product divided by ``sqrt(head_dim)``, masked with −1e30; the LM
head multiplies ``cfg.dtype`` operands into an fp32 result and adds an
fp32 bias (``return_hidden=True`` hands the final LayerNorm's output to
:func:`~..ops.fused_xent.fused_linear_cross_entropy` instead).

Two forwards share the parameters:

* the uncached forward (``model(tokens)``), the training forward of
  ``horovod_tpu/models/transformer.py:549-714``: ``train=`` with
  dropout (``dropout_rate``; the masks come from the ``rng=``
  ``torch.Generator``), ``remat`` (each block under
  ``torch.utils.checkpoint``), ``lengths=`` for right-padded batches,
  ``mask=`` (a ``[batch, seq]`` key-padding mask, dense attention only),
  ``return_hidden``, and attention through the flash kernels
  (:mod:`..ops.flash_attention`) where ``cfg.uses_flash`` says so. It is
  also the reference the serving path is held against;
* the cache-threaded forward (``model(tokens, cache=, cache_index=,
  pages=)``), the serving engine's model contract. Each call writes its
  k/v into the cache at every row's own position and attends under the
  global causal mask ``key_pos <= query_pos``. The cache is either the
  contiguous slab ``[batch, max_len, kv_heads, head_dim]`` per layer or,
  with ``pages=`` (an int32 page table), the paged block pool
  ``[num_pages, page_tokens, kv_heads, head_dim]`` of
  ``serving/paged_kv.py``. It is written in place, where the JAX model
  returns an updated copy for the engine to donate.

On the paged layout ``paged_attn=True`` reads the pool through
``hvd_torch::paged_attention``
(:func:`~horovod_tpu_torch.ops.paged_attention.paged_attention` as a
custom operator): the hand-written kernel for CUDA tensors (it launches
or raises), its plain version for CPU tensors. ``paged_attn=False`` takes the plain version
(gather the pages, attend densely) on any device. A model with
``sliding_window`` reads the cache as the JAX model's gather read does,
on every device: the slab, or each row's pages gathered in logical
order, attended densely under the causal mask and ``q_pos − key_pos <
window``; the paged kernel has no window, so ``paged_attn=True`` with
one raises.

``moe_experts > 0`` replaces each block's feed-forward with
:class:`MoEFFN`, the JAX model's switch-style top-1 bank (fp32 router,
softmax, argmax, the experts as one-hot einsums); it serves the full and
the cached forward alike, since the FFN is position-wise.

The flash gate differs from the JAX one where the TPU shaped it: the
Mosaic rungs (``supports_seq``'s block divisibility, ``fits_vmem``)
are gone, since the kernels take any sequence length; the kernels' own
limits (head_dim a multiple of 8 up to 256) take their place, and
``flash_block_q``/``_k`` (Mosaic tiling) are not carried over. Where
the JAX model warns and goes dense (``flash_attention=True`` with a
``mask=``), the port raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..common.config import resolve_device
from ..ops import flash_attention as _fa
from ..ops.fused_xent import mixed_linear
from ..ops import paged_attention as _pa

_NEG_INF = -1e30
_LN_EPS = 1e-6  # Flax's LayerNorm default (torch's is 1e-5)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50257
    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12
    d_ff: int = 3072
    max_len: int = 1024
    causal: bool = True
    dropout_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    # recompute each block's activations in backward
    # (torch.utils.checkpoint, non-reentrant)
    remat: bool = False
    # flash attention on the uncached forward: True/False, or "auto" =
    # the kernels for CUDA tensors when no mask= is passed (see
    # uses_flash)
    flash_attention: Any = "auto"
    # rotary position embeddings on q/k ("rotate-half"); when on, the
    # learned absolute position table is not built
    rope: bool = False
    rope_base: float = 10000.0
    # causal sliding window: a query attends to the ``sliding_window``
    # newest positions up to its own, cached or not
    sliding_window: Optional[int] = None
    # grouped-query attention: KV heads (None = MHA, the fused qkv
    # projection)
    num_kv_heads: Optional[int] = None
    # MoE feed-forward banks: experts per block (0 = the dense FFN)
    moe_experts: int = 0
    # LM head: cfg.dtype operands, fp32 accumulation (True) or all fp32
    head_mixed_precision: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    def uses_flash(self, mask=None, seq=None, device=None) -> bool:
        """The gate of the flash path. An arbitrary ``mask`` goes dense
        (the kernels mask causally and by ``lengths`` only); "auto"
        takes the kernels for CUDA tensors whose geometry they support;
        True and False force the choice. ``seq`` is accepted for the
        JAX signature: the kernels take any length."""
        if mask is not None:
            return False
        if self.flash_attention == "auto":
            return (
                device is not None
                and torch.device(device).type == "cuda"
                and _fa.unsupported_reason(self.head_dim) is None
            )
        return bool(self.flash_attention)

    @staticmethod
    def gpt2_medium() -> "TransformerConfig":
        """GPT-2 medium (345M): 24 layers, d_model 1024, 16 heads."""
        return TransformerConfig(
            num_layers=24, d_model=1024, num_heads=16, d_ff=4096, causal=True
        )

    @staticmethod
    def bert_large() -> "TransformerConfig":
        """BERT-large (340M): 24 layers, d_model 1024, 16 heads,
        bidirectional, vocab 30522, 512 positions."""
        return TransformerConfig(
            vocab_size=30522,
            num_layers=24,
            d_model=1024,
            num_heads=16,
            d_ff=4096,
            max_len=512,
            causal=False,
        )

    @staticmethod
    def tiny(causal: bool = True) -> "TransformerConfig":
        """Test-sized config."""
        return TransformerConfig(
            vocab_size=256,
            num_layers=2,
            d_model=64,
            num_heads=4,
            d_ff=128,
            max_len=128,
            causal=causal,
            dtype=torch.float32,
        )


def apply_rope(x: torch.Tensor, base: float = 10000.0, offset=0):
    """Rotate ``[batch, seq, heads, head_dim]`` q or k by absolute
    position, pairs ``(x[..., :d/2], x[..., d/2:])``, trig in fp32.
    ``offset`` is a scalar or a ``[batch]`` tensor (each cache slot at
    its own position)."""
    b, t, h, d = x.shape
    if d % 2:
        raise ValueError(f"RoPE needs an even head_dim, got {d}")
    half = d // 2
    dev = x.device
    pos = torch.as_tensor(offset, dtype=torch.float32, device=dev)[
        ..., None
    ] + torch.arange(t, dtype=torch.float32, device=dev)
    inv_freq = torch.pow(
        torch.tensor(base, dtype=torch.float32, device=dev),
        -torch.arange(0, half, dtype=torch.float32, device=dev) / half,
    )
    angles = pos[..., :, None] * inv_freq  # [(b,) t, half]
    cos, sin = torch.cos(angles), torch.sin(angles)
    if angles.dim() == 2:  # scalar offset: broadcast over batch
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat(
        [x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1
    ).to(x.dtype)


def init_cache(cfg: TransformerConfig, batch: int, max_len=None,
               dtype=None, device=None) -> List[dict]:
    """An empty decode KV cache: one ``{"k", "v"}`` dict per layer, each
    ``[batch, max_len, kv_heads, head_dim]`` of zeros. The paged pool
    uses the same factory with ``batch = num_pages`` and ``max_len =
    page_tokens``. Zeros, not uninitialised memory: stale positions are
    masked to probability 0, and 0 times a NaN left in unwritten memory
    would still be NaN."""
    seq = int(max_len) if max_len is not None else cfg.max_len
    if not cfg.rope and seq > cfg.max_len:
        raise ValueError(
            f"KV cache max_len ({seq}) exceeds the learned position "
            f"table ({cfg.max_len}); raise cfg.max_len or use rope=True"
        )
    dt = cfg.dtype if dtype is None else dtype
    shape = (batch, seq, cfg.kv_heads, cfg.head_dim)
    return [
        {
            "k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
        }
        for _ in range(cfg.num_layers)
    ]


@dataclasses.dataclass
class CacheStep:
    """Where one cached forward reads and writes, shared by every layer.

    ``index`` is each row's count of tokens cached before the call and
    ``table`` the page table (None for the slab), both int32 on the
    cache's device. ``dst`` are the flat cache rows (``[pages ×
    page_tokens]`` or ``[batch × max_len]``) that rows ``src`` of the
    call's ``[batch × t]`` new k/v land in; ``src`` None means all rows.
    Positions past a slot's page table, or mapped to the sentinel page,
    are left out of ``src``: the paged write drops them, as the JAX
    model's ``mode="drop"`` scatter does. The rows are worked out once
    per forward on the host, so no layer waits on the device.

    :meth:`on_device` builds the step a CUDA graph can capture instead:
    fixed shapes, worked out on the device from device tensors, with no
    host-to-device copy."""

    index: torch.Tensor
    table: Optional[torch.Tensor]
    src: Optional[torch.Tensor]
    dst: torch.Tensor

    @staticmethod
    def on_device(cache, index: torch.Tensor, table: Optional[torch.Tensor],
                  t: int, spare_row0: Optional[int] = None) -> "CacheStep":
        """The step of :meth:`build` from ``index`` (``[batch]`` int32)
        and ``table`` (``[batch, n_logical]`` int32, None for the slab),
        both on the cache's device: every row of the call's ``[batch ×
        t]`` k/v gets a destination, so ``src`` is None and every shape
        depends on ``batch`` and ``t`` alone. On the paged pool a row the
        host-built step drops (past the table, or on a sentinel page)
        goes to its own spare row, ``spare_row0 + row``: the pool's
        spare pages past the ``spare_row0 // page_tokens`` live ones,
        which no table names, so no live row reads it and no two rows
        share one."""
        leaf = cache[0]["k"]
        dev = leaf.device
        b = index.shape[0]
        idx = index.to(torch.int64)
        steps = torch.arange(t, device=dev)
        if table is None:
            seq = leaf.shape[1]
            start = idx.clamp(0, max(seq - t, 0))
            dst = (torch.arange(b, device=dev)[:, None] * seq
                   + start[:, None] + steps).reshape(-1)
        else:
            rows, page_tokens = leaf.shape[0] * leaf.shape[1], leaf.shape[1]
            if spare_row0 is None or spare_row0 + b * t > rows:
                raise ValueError(
                    f"the pool holds {rows} rows; a device-built step of "
                    f"{b} × {t} rows needs that many spare rows from "
                    f"{spare_row0}")
            num_pages = spare_row0 // page_tokens
            n_logical = table.shape[1]
            pos = idx[:, None] + steps
            lp, off = pos // page_tokens, pos % page_tokens
            phys = torch.gather(table.to(torch.int64), 1,
                                lp.clamp(0, n_logical - 1))
            keep = (lp < n_logical) & (phys >= 0) & (phys < num_pages)
            spare = spare_row0 + torch.arange(b * t, device=dev).reshape(b, t)
            dst = torch.where(keep, phys * page_tokens + off,
                              spare).reshape(-1)
            table = table.to(torch.int32)
        return CacheStep(index=index.to(torch.int32), table=table, src=None,
                         dst=dst)

    @staticmethod
    def build(cache, cache_index, pages, batch: int, t: int,
              device) -> "CacheStep":
        idx = np.asarray(_host(cache_index), np.int64).reshape(-1)
        if idx.size != batch:
            raise ValueError(
                f"cache_index has {idx.size} entries for batch {batch}"
            )
        steps = np.arange(t, dtype=np.int64)
        leaf = cache[0]["k"]
        src = None
        table = None
        if pages is None:
            seq = leaf.shape[1]
            # a write that would run past the row shifts back to fit,
            # as jax.lax.dynamic_update_slice clamps its start
            start = np.clip(idx, 0, max(seq - t, 0))
            dst = (
                np.arange(batch, dtype=np.int64)[:, None] * seq
                + start[:, None] + steps
            ).reshape(-1)
        else:
            tbl = np.asarray(_host(pages), np.int64)
            if tbl.ndim != 2 or tbl.shape[0] != batch:
                raise ValueError(
                    f"pages {tbl.shape} must be [batch={batch}, n_logical]"
                )
            num_pages, page_tokens = leaf.shape[:2]
            n_logical = tbl.shape[1]
            pos = idx[:, None] + steps
            lp, off = pos // page_tokens, pos % page_tokens
            phys = np.take_along_axis(
                tbl, np.clip(lp, 0, n_logical - 1), axis=1
            )
            keep = ((lp < n_logical) & (phys >= 0)
                    & (phys < num_pages)).reshape(-1)
            rows = np.nonzero(keep)[0]
            dst = (phys * page_tokens + off).reshape(-1)[rows]
            if rows.size != keep.size:
                src = torch.as_tensor(rows, device=device)
            table = torch.as_tensor(tbl.astype(np.int32), device=device)
        return CacheStep(
            index=torch.as_tensor(idx.astype(np.int32), device=device),
            table=table,
            src=src,
            dst=torch.as_tensor(dst, device=device),
        )


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _trunc_normal_(t: torch.Tensor, fan_in: int, generator=None):
    """Flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(
            t, std=std, a=-2 * std, b=2 * std, generator=generator
        )


class DenseGeneral(nn.Module):
    """Flax's ``DenseGeneral``: contract the last ``len(in_shape)``
    axes of ``x`` with a kernel of shape ``in_shape + out_shape``, cast
    to ``dtype`` at use, then add the bias in ``dtype``."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
                 dtype: torch.dtype, device=None, generator=None):
        super().__init__()
        self.in_shape = tuple(int(s) for s in in_shape)
        self.out_shape = tuple(int(s) for s in out_shape)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(
            self.in_shape + self.out_shape, device=device
        ))
        self.bias = nn.Parameter(torch.zeros(self.out_shape, device=device))
        _trunc_normal_(self.kernel, math.prod(self.in_shape), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in, n_out = math.prod(self.in_shape), math.prod(self.out_shape)
        lead = x.shape[: x.dim() - len(self.in_shape)]
        w = self.kernel.reshape(n_in, n_out).to(self.dtype)
        y = x.reshape(*lead, n_in).to(self.dtype) @ w
        y = y + self.bias.reshape(n_out).to(self.dtype)
        return y.reshape(*lead, *self.out_shape)


def _attend(q, k, v, valid, dtype):
    """Dense softmax attention: ``q [b, t, h, d]``, ``k``/``v`` ``[b, s,
    kvh, d]`` (KV heads repeated for GQA), ``valid`` broadcastable to
    the ``[b, h, t, s]`` scores. fp32 scores and softmax, probabilities
    cast to ``dtype`` before the product with v."""
    r = q.shape[2] // k.shape[2]
    if r > 1:
        k = k.repeat_interleave(r, dim=2)
        v = v.repeat_interleave(r, dim=2)
    scores = torch.einsum(
        "bqhd,bkhd->bhqk", q.float(), k.float()
    ) / math.sqrt(q.shape[-1])
    scores = scores.masked_fill(~valid, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(dtype))


class MultiHeadAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
        kw = dict(dtype=cfg.dtype, device=device, generator=generator)
        if cfg.num_kv_heads:
            if h % cfg.num_kv_heads:
                raise ValueError(
                    f"num_kv_heads ({cfg.num_kv_heads}) must divide "
                    f"num_heads ({h})"
                )
            self.q = DenseGeneral((d,), (h, hd), **kw)
            self.kv = DenseGeneral((d,), (2, cfg.num_kv_heads, hd), **kw)
        else:
            self.qkv = DenseGeneral((d,), (3, h, hd), **kw)
        self.out = DenseGeneral((h, hd), (d,), **kw)

    def forward(self, x, mask=None, lengths=None,
                cache: Optional[dict] = None,
                step: Optional[CacheStep] = None, paged_attn: bool = False):
        cfg = self.cfg
        if cache is not None:
            if not cfg.causal:
                raise ValueError(
                    "incremental decode (cache=) requires causal=True"
                )
            if mask is not None or lengths is not None:
                raise ValueError(
                    "cache= does not compose with mask=/lengths=: the "
                    "cache_index is the per-slot length"
                )
        if cfg.num_kv_heads:
            q = self.q(x)
            kv = self.kv(x)
            k, v = kv[..., 0, :, :], kv[..., 1, :, :]
        else:
            qkv = self.qkv(x)
            q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
        if cfg.rope:
            offset = 0 if cache is None else step.index
            q = apply_rope(q, cfg.rope_base, offset=offset)
            k = apply_rope(k, cfg.rope_base, offset=offset)
        if cache is not None:
            return self.out(self._cached_attention(q, k, v, cache, step,
                                                   paged_attn))
        if cfg.sliding_window and not cfg.causal:
            raise ValueError("sliding_window requires causal=True")
        if mask is not None and cfg.flash_attention not in ("auto", False):
            raise ValueError(
                "flash_attention=True but a mask= was passed: the flash "
                "kernels mask causally and by lengths= only; pass lengths= "
                "for right-padded batches, or flash_attention=False"
            )
        t = x.shape[1]
        if cfg.uses_flash(mask, t, x.device):
            return self.out(_fa.flash_attention(
                q, k, v, causal=cfg.causal, lengths=lengths,
                window=cfg.sliding_window,
            ))
        rows = torch.arange(t, device=x.device)[:, None]
        cols = torch.arange(t, device=x.device)[None, :]
        valid = torch.ones((t, t), dtype=torch.bool, device=x.device)
        if cfg.causal:
            valid = cols <= rows
            if cfg.sliding_window:
                valid = valid & (rows - cols < cfg.sliding_window)
        valid = valid[None, None]
        live = None
        if lengths is not None:
            # the dense twin of the kernels' lengths contract, combined
            # (AND) with an explicit mask
            live = cols < lengths.to(x.device).long()[:, None]  # [b, t]
            mask = live if mask is None else (mask & live)
        if mask is not None:
            valid = valid & mask.to(x.device, torch.bool)[:, None, None, :]
        out = _attend(q, k, v, valid, cfg.dtype)
        if live is not None:
            # as on the flash path: padded query rows are zero
            out = torch.where(live[:, :, None, None], out, 0.0)
        return self.out(out)

    def _cached_attention(self, q, k, v, cache, step, paged_attn):
        """Write this call's k/v into the cache at ``step.dst``, then
        attend q against the whole cache under the global causal mask
        (and the window, where the model has one). Stale and unwritten
        positions sit past every row's frontier and get probability
        exactly 0."""
        cfg = self.cfg
        if cfg.sliding_window and paged_attn:
            raise ValueError(
                "sliding_window is not implemented by the paged kernel: "
                "pass paged_attn=False for the windowed gather read"
            )
        b, t, h, d = q.shape
        k_cache, v_cache = cache["k"], cache["v"]
        kvh = k_cache.shape[2]
        for new, buf in ((k, k_cache), (v, v_cache)):
            rows = new.reshape(b * t, kvh, d)
            if step.src is not None:
                rows = rows[step.src]
            buf.view(-1, kvh, d).index_copy_(0, step.dst, rows.to(buf.dtype))
        if step.table is not None and not cfg.sliding_window:
            if paged_attn:
                return _pa.OPS.paged_attention(q, k_cache, v_cache,
                                               step.table, step.index, True)
            return _pa.paged_attention_plain(q, k_cache, v_cache, step.table,
                                             step.index, causal=True)
        if step.table is not None:
            # the gather read: each row's pages in logical order (sentinel
            # entries clamp to a page whose rows the mask zeroes)
            table = step.table.long().clamp(0, k_cache.shape[0] - 1)
            seq = table.shape[1] * k_cache.shape[1]
            k_cache = k_cache[table].reshape(b, seq, kvh, d)
            v_cache = v_cache[table].reshape(b, seq, kvh, d)
        q_pos = step.index.long()[:, None] + torch.arange(t, device=q.device)
        key_pos = torch.arange(k_cache.shape[1], device=q.device)
        dist = q_pos[:, :, None] - key_pos[None, None, :]  # [b, t, seq]
        valid = dist >= 0
        if cfg.sliding_window:
            valid = valid & (dist < cfg.sliding_window)
        return _attend(q, k_cache, v_cache, valid[:, None], cfg.dtype)


class MoEFFN(nn.Module):
    """Switch-style top-1 MoE FFN (``horovod_tpu/models/transformer.py:
    505-546``): router logits in fp32, argmax routing (data: no shape
    depends on it), and the expert bank applied through dense one-hot
    einsums over the leading ``[E]`` axis. Every token is served by its
    routed expert, gated by the router probability; no capacity, no
    drops. Flax's ``lecun_normal(in_axis=-2, out_axis=-1)`` of an ``[E,
    d, f]`` bank counts the expert axis into the fan-in (E·d)."""

    def __init__(self, cfg: TransformerConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        e, d, f = cfg.moe_experts, cfg.d_model, cfg.d_ff
        self.router = DenseGeneral((d,), (e,), torch.float32, device=device,
                                   generator=generator)
        self.w1 = nn.Parameter(torch.empty(e, d, f, device=device))
        self.b1 = nn.Parameter(torch.zeros(e, f, device=device))
        self.w2 = nn.Parameter(torch.empty(e, f, d, device=device))
        self.b2 = nn.Parameter(torch.zeros(e, d, device=device))
        _trunc_normal_(self.w1, e * d, generator)
        _trunc_normal_(self.w2, e * f, generator)

    def forward(self, x):
        cfg = self.cfg
        probs = torch.softmax(self.router(x.float()), dim=-1)  # [b, t, E]
        idx = probs.argmax(dim=-1)
        gate = probs.gather(-1, idx[..., None])
        # the einsums run in the promoted type of the (fp32) input and
        # cfg.dtype, as jnp.einsum promotes its operands
        ct = torch.promote_types(x.dtype, cfg.dtype)
        sel = F.one_hot(idx, cfg.moe_experts).to(cfg.dtype).to(ct)
        w1, b1, w2, b2 = (p.to(cfg.dtype).to(ct)
                          for p in (self.w1, self.b1, self.w2, self.b2))
        h = torch.einsum("btd,edf,bte->btf", x.to(ct), w1, sel)
        h = h + torch.einsum("ef,bte->btf", b1, sel)
        h = F.gelu(h, approximate="tanh")
        y = torch.einsum("btf,efd,bte->btd", h, w2, sel)
        y = y + torch.einsum("ed,bte->btd", b2, sel)
        # cfg.dtype out, as the dense branch it replaces
        return (y * gate).to(cfg.dtype)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=device, generator=generator)
        self.ln1 = nn.LayerNorm(cfg.d_model, eps=_LN_EPS, device=device)
        self.attn = MultiHeadAttention(cfg, device=device, generator=generator)
        self.ln2 = nn.LayerNorm(cfg.d_model, eps=_LN_EPS, device=device)
        if cfg.moe_experts:
            self.moe = MoEFFN(cfg, device=device, generator=generator)
        else:
            self.fc1 = DenseGeneral((cfg.d_model,), (cfg.d_ff,), **kw)
            self.fc2 = DenseGeneral((cfg.d_ff,), (cfg.d_model,), **kw)

    def forward(self, x, mask=None, lengths=None, seed=None, cache=None,
                step=None, paged_attn=False):
        """``seed`` (an int, or None for no dropout) seeds this block's
        dropout masks, so a recompute under ``remat`` draws the same."""
        rate = self.cfg.dropout_rate
        gen = None
        if seed is not None and rate > 0:
            gen = torch.Generator(device=x.device)
            gen.manual_seed(seed)
        h = self.attn(self.ln1(x.float()), mask=mask, lengths=lengths,
                      cache=cache, step=step, paged_attn=paged_attn)
        x = x + _dropout(h, rate, gen)
        if self.cfg.moe_experts:
            return x + _dropout(self.moe(self.ln2(x.float())), rate, gen)
        h = F.gelu(self.fc1(self.ln2(x.float())), approximate="tanh")
        return x + _dropout(self.fc2(h), rate, gen)


def _dropout(x: torch.Tensor, rate: float,
             gen: Optional[torch.Generator]) -> torch.Tensor:
    """Flax's ``Dropout``: keep each element with probability ``1 −
    rate`` and scale the kept ones by ``1 / (1 − rate)``; the identity
    without a generator (not training)."""
    if gen is None:
        return x
    keep = 1.0 - rate
    kept = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(kept, x / keep, 0.0).to(x.dtype)


class LMHead(nn.Module):
    """Vocabulary projection: ``cfg.dtype`` operands with an fp32
    result (``head_mixed_precision``, the default) or all fp32, plus an
    fp32 bias. The product is :func:`~..ops.fused_xent.mixed_mm`, the
    one the fused loss takes: on CUDA a bf16 tensor-core product with
    fp32 output; on the CPU the fp32 product of the rounded operands."""

    def __init__(self, cfg: TransformerConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.kernel = nn.Parameter(
            torch.empty(cfg.d_model, cfg.vocab_size, device=device)
        )
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size, device=device))
        _trunc_normal_(self.kernel, cfg.d_model, generator)

    def forward(self, x):
        cfg = self.cfg
        dtype = cfg.dtype if cfg.head_mixed_precision else None
        return mixed_linear(x, self.kernel, self.bias, dtype)


class Transformer(nn.Module):
    """The decoder stack. Parameters are created in fp32 on ``device``
    (None means the CUDA card, and raises without one; the CPU only when
    asked for) and initialised from ``generator`` (a ``torch.Generator``
    on the same device) as Flax initialises the JAX model: embeddings
    normal with variance 1/d_model, kernels ``lecun_normal``, biases 0,
    LayerNorm scale 1."""

    def __init__(self, cfg: TransformerConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device)
        self.pos_embed = None
        if not cfg.rope:
            self.pos_embed = nn.Embedding(cfg.max_len, cfg.d_model,
                                          device=device)
        std = 1.0 / math.sqrt(cfg.d_model)
        with torch.no_grad():
            for emb in (self.embed, self.pos_embed):
                if emb is not None:
                    emb.weight.normal_(0.0, std, generator=generator)
        self.blocks = nn.ModuleList(
            Block(cfg, device=device, generator=generator)
            for _ in range(cfg.num_layers)
        )
        self.ln_f = nn.LayerNorm(cfg.d_model, eps=_LN_EPS, device=device)
        self.lm_head = LMHead(cfg, device=device, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    @torch.no_grad()
    def cast_weights_(self) -> "Transformer":
        """Store in ``cfg.dtype`` every parameter that each use casts to
        ``cfg.dtype`` first: the embeddings, the ``DenseGeneral`` kernels
        and biases and, with ``head_mixed_precision``, the LM head
        kernel. The forward then reads the same values without a cast
        kernel per weight per call. LayerNorm parameters and the LM head
        bias stay fp32, as their uses are fp32. In place; returns
        ``self``."""
        dt = self.cfg.dtype
        params = [self.embed.weight]
        if self.pos_embed is not None:
            params.append(self.pos_embed.weight)
        for mod in self.modules():
            if isinstance(mod, DenseGeneral) and mod.dtype == dt:
                params += [mod.kernel, mod.bias]  # not the fp32 router
            elif isinstance(mod, MoEFFN):
                params += [mod.w1, mod.b1, mod.w2, mod.b2]
        if self.cfg.head_mixed_precision:
            params.append(self.lm_head.kernel)
        for p in params:
            p.data = p.data.to(dt)
        return self

    def forward(self, tokens, mask=None, train: bool = True,
                return_hidden: bool = False, lengths=None,
                cache: Optional[List[dict]] = None, cache_index=None,
                pages=None, paged_attn: bool = False,
                rng: Optional[torch.Generator] = None,
                step: Optional[CacheStep] = None):
        """Logits ``[batch, t, vocab]`` in fp32.

        Uncached: ``tokens`` is the whole sequence. ``train`` turns
        dropout on (``cfg.dropout_rate`` > 0 then needs ``rng``, a
        ``torch.Generator`` on the model's device) and, with
        ``cfg.remat`` under autograd, recomputes each block in backward.
        ``lengths`` (``[batch]``) right-pads the batch; ``mask``
        (``[batch, t]`` bool, keys to attend) takes the dense path;
        ``return_hidden`` returns the final LayerNorm's output instead
        of the logits.
        Cached: ``cache`` (from :func:`init_cache`, one dict per layer)
        takes this call's k/v at ``cache_index`` (``[batch]``: tokens
        already cached per row) and is updated in place; ``pages``
        (``[batch, n_logical]`` int32) switches it to the paged pool.
        ``step`` (a :class:`CacheStep`, e.g. :meth:`CacheStep.on_device`)
        replaces ``cache_index`` and ``pages``."""
        cfg = self.cfg
        dev = self.device
        tokens = torch.as_tensor(tokens, device=dev).long()
        b, t = tokens.shape
        if cache is not None:
            if return_hidden:
                raise ValueError("return_hidden with cache= is not supported")
            if step is None:
                step = CacheStep.build(cache, cache_index, pages, b, t,
                                       cache[0]["k"].device)
        elif step is not None:
            raise ValueError("step= requires cache=")
        elif pages is not None:
            raise ValueError("pages= (the page table) requires cache=")
        x = self.embed(tokens).to(cfg.dtype)
        if self.pos_embed is not None:
            positions = torch.arange(t, device=dev)[None]
            if step is not None:
                positions = step.index.to(dev).long()[:, None] + positions
            x = x + self.pos_embed(positions).to(cfg.dtype)
        if cache is not None:
            for i, block in enumerate(self.blocks):
                x = block(x, cache=cache[i], step=step,
                          paged_attn=paged_attn)
            return self.lm_head(self.ln_f(x.float()))
        seeds = [None] * cfg.num_layers
        if train and cfg.dropout_rate > 0:
            if rng is None:
                raise ValueError(
                    "train=True with dropout_rate > 0 needs rng= (a "
                    "torch.Generator on the model's device)"
                )
            seeds = torch.randint(0, 2 ** 62, (cfg.num_layers,),
                                  generator=rng, device=rng.device).tolist()
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=dev)
        if mask is not None:
            mask = torch.as_tensor(mask, device=dev, dtype=torch.bool)
        remat = cfg.remat and train and torch.is_grad_enabled()
        for block, seed in zip(self.blocks, seeds):
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    block, x, mask, lengths, seed, use_reentrant=False
                )
            else:
                x = block(x, mask, lengths, seed)
        h = self.ln_f(x.float())
        return h if return_hidden else self.lm_head(h)
