"""GPT-2-style Transformer in PyTorch: the serving model of the port.

The counterpart of ``horovod_tpu/models/transformer.py``: the same
configuration, the same parameter layout (``DenseGeneral`` kernels keep
the Flax shapes, so :mod:`.convert` carries a JAX checkpoint across by
name) and the same numerics: parameters in fp32, cast to ``cfg.dtype``
at use; LayerNorm in fp32 with eps 1e-6; tanh GELU; attention scores as
an fp32 product divided by ``sqrt(head_dim)``, masked with −1e30; the LM
head multiplies ``cfg.dtype`` operands with fp32 accumulation and adds
an fp32 bias.

Two forwards share the parameters:

* the uncached dense forward (``model(tokens)``), the reference the
  serving path is held against;
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
:func:`~horovod_tpu_torch.ops.paged_attention.paged_attention`: the
hand-written kernel for CUDA tensors (it launches or raises), its plain
version for CPU tensors. ``paged_attn=False`` takes the plain version
(gather the pages, attend densely) on any device. MoE feed-forward
banks and the sliding window on the cached path are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..common.config import resolve_device
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
    dtype: torch.dtype = torch.bfloat16
    # rotary position embeddings on q/k ("rotate-half"); when on, the
    # learned absolute position table is not built
    rope: bool = False
    rope_base: float = 10000.0
    # causal sliding window (uncached forward only in this port)
    sliding_window: Optional[int] = None
    # grouped-query attention: KV heads (None = MHA, the fused qkv
    # projection)
    num_kv_heads: Optional[int] = None
    # MoE feed-forward banks are not ported yet; must stay 0
    moe_experts: int = 0
    # LM head: cfg.dtype operands, fp32 accumulation (True) or all fp32
    head_mixed_precision: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @staticmethod
    def gpt2_medium() -> "TransformerConfig":
        """GPT-2 medium (345M): 24 layers, d_model 1024, 16 heads."""
        return TransformerConfig(
            num_layers=24, d_model=1024, num_heads=16, d_ff=4096, causal=True
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
    per forward on the host, so no layer waits on the device."""

    index: torch.Tensor
    table: Optional[torch.Tensor]
    src: Optional[torch.Tensor]
    dst: torch.Tensor

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

    def forward(self, x, cache: Optional[dict] = None,
                step: Optional[CacheStep] = None, paged_attn: bool = False):
        cfg = self.cfg
        if cache is not None and not cfg.causal:
            raise ValueError("incremental decode (cache=) requires causal=True")
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
        t = x.shape[1]
        valid = None
        if cfg.causal:
            rows = torch.arange(t, device=x.device)[:, None]
            cols = torch.arange(t, device=x.device)[None, :]
            valid = cols <= rows
            if cfg.sliding_window:
                valid = valid & (rows - cols < cfg.sliding_window)
        elif cfg.sliding_window:
            raise ValueError("sliding_window requires causal=True")
        if valid is None:
            valid = torch.ones((t, t), dtype=torch.bool, device=x.device)
        return self.out(_attend(q, k, v, valid, cfg.dtype))

    def _cached_attention(self, q, k, v, cache, step, paged_attn):
        """Write this call's k/v into the cache at ``step.dst``, then
        attend q against the whole cache under the global causal mask.
        Stale and unwritten positions sit past every row's frontier and
        get probability exactly 0."""
        cfg = self.cfg
        if cfg.sliding_window:
            raise NotImplementedError(
                "sliding_window on the cached path is not ported yet"
            )
        b, t, h, d = q.shape
        k_cache, v_cache = cache["k"], cache["v"]
        kvh = k_cache.shape[2]
        for new, buf in ((k, k_cache), (v, v_cache)):
            rows = new.reshape(b * t, kvh, d)
            if step.src is not None:
                rows = rows[step.src]
            buf.view(-1, kvh, d).index_copy_(0, step.dst, rows.to(buf.dtype))
        if step.table is not None:
            attend = (_pa.paged_attention if paged_attn
                      else _pa.paged_attention_plain)
            return attend(q, k_cache, v_cache, step.table, step.index,
                          causal=True)
        q_pos = step.index.long()[:, None] + torch.arange(t, device=q.device)
        key_pos = torch.arange(k_cache.shape[1], device=q.device)
        valid = key_pos[None, None, :] <= q_pos[:, :, None]  # [b, t, seq]
        return _attend(q, k_cache, v_cache, valid[:, None], cfg.dtype)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=device, generator=generator)
        self.ln1 = nn.LayerNorm(cfg.d_model, eps=_LN_EPS, device=device)
        self.attn = MultiHeadAttention(cfg, device=device, generator=generator)
        self.ln2 = nn.LayerNorm(cfg.d_model, eps=_LN_EPS, device=device)
        self.fc1 = DenseGeneral((cfg.d_model,), (cfg.d_ff,), **kw)
        self.fc2 = DenseGeneral((cfg.d_ff,), (cfg.d_model,), **kw)

    def forward(self, x, cache=None, step=None, paged_attn=False):
        h = self.attn(self.ln1(x.float()), cache, step, paged_attn)
        x = x + h
        h = F.gelu(self.fc1(self.ln2(x.float())), approximate="tanh")
        return x + self.fc2(h)


class LMHead(nn.Module):
    """Vocabulary projection: ``cfg.dtype`` operands with fp32
    accumulation (``head_mixed_precision``, the default) or all fp32,
    fp32 logits plus an fp32 bias. The mixed product runs as an fp32
    product of the rounded operands: a product of two bf16 values is
    exact in fp32, so this is the bf16 product accumulated in fp32."""

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
        w = self.kernel
        if cfg.head_mixed_precision:
            x = x.to(cfg.dtype)
            w = w.to(cfg.dtype)
        return x.float() @ w.float() + self.bias


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
        if cfg.moe_experts:
            raise NotImplementedError(
                "MoE feed-forward banks (moe_experts > 0) are not ported yet"
            )
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
            if isinstance(mod, DenseGeneral):
                params += [mod.kernel, mod.bias]
        if self.cfg.head_mixed_precision:
            params.append(self.lm_head.kernel)
        for p in params:
            p.data = p.data.to(dt)
        return self

    def forward(self, tokens, cache: Optional[List[dict]] = None,
                cache_index=None, pages=None, paged_attn: bool = False):
        """Logits ``[batch, t, vocab]`` in fp32.

        Uncached: ``tokens`` is the whole sequence, attended causally.
        Cached: ``cache`` (from :func:`init_cache`, one dict per layer)
        takes this call's k/v at ``cache_index`` (``[batch]``: tokens
        already cached per row) and is updated in place; ``pages``
        (``[batch, n_logical]`` int32) switches it to the paged pool."""
        cfg = self.cfg
        dev = self.device
        tokens = torch.as_tensor(tokens, device=dev).long()
        b, t = tokens.shape
        step = None
        if cache is not None:
            step = CacheStep.build(cache, cache_index, pages, b, t,
                                   cache[0]["k"].device)
        elif pages is not None:
            raise ValueError("pages= (the page table) requires cache=")
        x = self.embed(tokens).to(cfg.dtype)
        if self.pos_embed is not None:
            positions = torch.arange(t, device=dev)[None]
            if step is not None:
                positions = step.index.to(dev).long()[:, None] + positions
            x = x + self.pos_embed(positions).to(cfg.dtype)
        for i, block in enumerate(self.blocks):
            x = block(x, None if cache is None else cache[i], step,
                      paged_attn)
        return self.lm_head(self.ln_f(x.float()))
