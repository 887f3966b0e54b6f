"""Paged attention: the serving attention read, straight from the page pool.

The paged memory plane (``serving/paged_kv.py``) keeps KV in a block pool
``[num_pages, page_tokens, kv_heads, head_dim]`` per layer, each slot
mapping its sequence through an int32 page table. :func:`paged_attention`
attends the queries against that pool through the table without
assembling a contiguous copy of each slot's cache first.

It replaces the Pallas kernel of ``horovod_tpu/ops/paged_attention.py``
(``paged_attention``, its ``_kernel``) with a kernel written by hand in
CUDA C++ for Hopper, ``csrc/paged_attention.cu``, built with ``nvcc`` for
``sm_90a`` and bound through ``ctypes`` (``_build.py``). The kernel is
bound by device-memory bytes: a decode step reads each slot's live K/V
bytes once, so its floor is those bytes over the card's 3.35 TB/s. The
source says how its design follows from that.

Beside it, :func:`paged_attention_plain` computes the same function in
plain PyTorch (gather the pages, mask, softmax, multiply). The wrapper
takes the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises. Every launch adds one to
``paged_attention.launches``.

The kernel comes in three variants, chosen by one rule,
:func:`kernel_variant`, on the packed query rows of one (slot, KV head),
``t · h / kv_heads``: at most 4 (every decode step of an MHA model) take
the decode kernel, whose warps split the slot's keys; more (prefill
chunks, wide GQA groups) take the tiled kernel: on the tensor cores
(``wgmma``, the tile step of ``csrc/attention_tc.cuh``, 64 packed rows
a block, so each K/V page is read once for 64 rows) for bf16 at
head_dim 64 or 128, on the CUDA cores (16 rows a block) for fp32, fp16
and other head dims.
``paged_attention.chunk_launches`` counts the tiled kernel's launches of
either kind and ``paged_attention.tc_launches`` those on the tensor
cores. A call whose kernel fails to build or launch raises; it never
takes another variant or the plain version.

Numerics follow the reference: fp32 scores divided by ``sqrt(head_dim)``
after the product, the causal and length masks at −1e30, online softmax
in fp32 with the denominator floored at 1e-30, output in q's dtype. The
CUDA-core kernels and the plain version differ only in the order of
fp32 sums; the tensor-core kernel also feeds P to P·V as a bf16 pair
``hi + lo`` (about 2^-17 relative a term), within two bf16 ulp of the
plain output.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .flash_attention import tensor_core_path

LIBRARY = "paged_attention"
MAX_HEAD_DIM = 256
HEAD_DIM_MULTIPLE = 8  # one 16-byte load covers 8 two-byte elements
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
DECODE_MAX_ROWS = 4  # packed rows a (slot, KV head) the decode kernel takes
# the kernel variants, as csrc/paged_attention.cu's Variant numbers them
VARIANT_CODES = {"decode": 0, "cuda_cores": 1, "tensor_cores": 2}
_NEG_INF = -1e30


def kernel_variant(dtype: torch.dtype, head_dim: int, rows: int) -> str:
    """The dispatch rule, by the packed query rows of one (slot, KV
    head), ``rows = t · h / kv_heads``: at most 4 take the decode kernel
    (``"decode"``); more take the tiled kernel, on the tensor cores where
    the flash kernels take them, by the same rule
    (:func:`~.flash_attention.tensor_core_path`: bf16 at head_dim 64 or
    128; ``"tensor_cores"``), and on the CUDA cores otherwise
    (``"cuda_cores"``: fp32, fp16, other head dims)."""
    if rows <= DECODE_MAX_ROWS:
        return "decode"
    if tensor_core_path(dtype, head_dim):
        return "tensor_cores"
    return "cuda_cores"


def unsupported_reason(
    head_dim: int,
    page_tokens: int,
    *,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> Optional[str]:
    """The support ladder, one rung per return: None means the kernel
    takes this geometry on ``device``; a string names the rung (the
    engine raises with it when the kernel was asked for). The TPU ladder's
    lane and sublane floors are gone: Hopper takes GPT-2 medium's
    head_dim 64 and any page size. The kernel's own limits remain."""
    if head_dim < HEAD_DIM_MULTIPLE or head_dim > MAX_HEAD_DIM:
        return f"head_dim {head_dim} outside [8, {MAX_HEAD_DIM}]"
    if head_dim % HEAD_DIM_MULTIPLE:
        return f"head_dim {head_dim} is not a multiple of 8"
    if page_tokens < 1:
        return f"page_tokens {page_tokens} < 1"
    if dtype is not None and dtype not in DTYPE_CODES:
        return f"dtype {dtype} is not float32, bfloat16 or float16"
    if device is not None and torch.device(device).type == "cuda":
        if not _build.available(LIBRARY):
            return "the CUDA kernel is not built and no nvcc can build it"
        major, minor = torch.cuda.get_device_capability(device)
        if (major, minor) != (9, 0):
            return (
                f"the kernel is built for sm_90a (Hopper); this card is "
                f"sm_{major}{minor}"
            )
    return None


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hvd_paged_attention.argtypes = [p] * 6 + [i] * 12 + [p]
    lib.hvd_paged_attention.restype = i
    lib.hvd_cuda_error_string.argtypes = [i]
    lib.hvd_cuda_error_string.restype = ctypes.c_char_p


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _check(q, k_pool, v_pool, page_table, lengths):
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError(
            f"q must be [b, t, h, d] and the pools [pages, page_tokens, "
            f"kv_heads, d]; got {tuple(q.shape)} and {tuple(k_pool.shape)}"
        )
    b, _, h, d = q.shape
    kvh, dk = k_pool.shape[2:]
    if v_pool.shape != k_pool.shape:
        raise ValueError(
            f"k_pool {tuple(k_pool.shape)} vs v_pool "
            f"{tuple(v_pool.shape)} mismatch"
        )
    if dk != d:
        raise ValueError(f"head_dim mismatch: q has {d}, pool has {dk}")
    if h % kvh:
        raise ValueError(
            f"num_heads ({h}) must be a multiple of kv_heads ({kvh})"
        )
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(
            f"page_table {tuple(page_table.shape)} must be [batch={b}, "
            "n_logical]"
        )
    if lengths.numel() != b:
        raise ValueError(f"lengths has {lengths.numel()} entries, batch {b}")


def paged_attention_plain(q, k_pool, v_pool, page_table, lengths, *,
                          causal: bool = True):
    """The kernel's function in plain PyTorch: gather every slot's pages
    (table entries clamped to the last page, as the reference's index
    map clamps), then masked dense softmax attention in fp32."""
    _check(q, k_pool, v_pool, page_table, lengths)
    b, t, h, d = q.shape
    num_pages, page_tokens, kvh, _ = k_pool.shape
    table = page_table.to(device=q.device, dtype=torch.long)
    table = table.clamp(0, num_pages - 1)
    seq = table.shape[1] * page_tokens
    k = k_pool[table].reshape(b, seq, kvh, d).float()
    v = v_pool[table].reshape(b, seq, kvh, d).float()
    r = h // kvh
    k = k.repeat_interleave(r, dim=2)
    v = v.repeat_interleave(r, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(d)
    start = lengths.to(device=q.device, dtype=torch.long).reshape(b)
    key_pos = torch.arange(seq, device=q.device)
    q_pos = start[:, None] + torch.arange(t, device=q.device)  # [b, t]
    valid = key_pos[None, None, :] < (start + t)[:, None, None]
    if causal:
        valid = valid & (key_pos[None, None, :] <= q_pos[:, :, None])
    s = s.masked_fill(~valid[:, None], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def paged_attention(q, k_pool, v_pool, page_table, lengths, *,
                    causal: bool = True):
    """Attention of ``q`` against paged KV, read straight from the pool.

    Args:
      q: ``[batch, t, num_heads, head_dim]`` queries, RoPE already
        applied. ``t`` is 1 for decode, the chunk width for prefill.
      k_pool / v_pool: ``[num_pages, page_tokens, kv_heads, head_dim]``,
        this call's k/v already written in.
      page_table: ``[batch, n_logical]`` int32, each row a slot's
        physical pages in logical order; out-of-range entries clamp to
        the last page (the length bound keeps them unattended).
      lengths: ``[batch]`` int32, tokens cached before this call; the
        live KV length is ``lengths + t``.
      causal: query row ``lengths + i`` attends keys ``<= lengths + i``.

    Returns ``[batch, t, num_heads, head_dim]`` in q's dtype. CPU tensors
    take :func:`paged_attention_plain`; CUDA tensors launch the kernel
    :func:`kernel_variant` names.
    """
    if not _on_cuda(q):
        return paged_attention_plain(
            q, k_pool, v_pool, page_table, lengths, causal=causal
        )
    _check(q, k_pool, v_pool, page_table, lengths)
    _, t, h, d = q.shape
    variant = kernel_variant(q.dtype, d, t * (h // k_pool.shape[2]))
    out = _launch(q, k_pool, v_pool, page_table, lengths, causal, variant)
    paged_attention.launches += 1
    if variant != "decode":
        paged_attention.chunk_launches += 1
        paged_attention.tc_launches += variant == "tensor_cores"
    return out


def _launch(q, k_pool, v_pool, page_table, lengths, causal, variant):
    """One launch of the kernel ``variant`` (a key of VARIANT_CODES);
    raises on what the kernels do not take."""
    b, t, h, d = q.shape
    num_pages, page_tokens, kvh, _ = k_pool.shape
    if q.dtype not in DTYPE_CODES or k_pool.dtype != q.dtype or (
        v_pool.dtype != q.dtype
    ):
        raise ValueError(
            f"paged_attention takes q and pools of one dtype among "
            f"{sorted(map(str, DTYPE_CODES))}; got {q.dtype}, "
            f"{k_pool.dtype}, {v_pool.dtype}"
        )
    if d % HEAD_DIM_MULTIPLE or d > MAX_HEAD_DIM:
        raise ValueError(
            f"head_dim {d} must be a multiple of 8 and at most "
            f"{MAX_HEAD_DIM}"
        )
    for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
        if not pool.is_contiguous() or pool.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if b > 65535 or kvh > 65535:
        raise ValueError(f"batch {b} or kv_heads {kvh} exceeds 65535")
    lib = _build.load(LIBRARY, _declare)
    q = q.contiguous()
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    lens = lengths.to(device=q.device, dtype=torch.int32).reshape(b)
    lens = lens.contiguous()
    out = torch.empty_like(q)
    index = q.device.index
    if index is None:
        index = torch.cuda.current_device()
    err = lib.hvd_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        table.data_ptr(), lens.data_ptr(), out.data_ptr(),
        b, t, h, kvh, d, num_pages, page_tokens, table.shape[1],
        int(bool(causal)), VARIANT_CODES[variant], DTYPE_CODES[q.dtype],
        index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"paged_attention kernel ({variant}) launch failed: "
            + lib.hvd_cuda_error_string(err).decode()
        )
    return out


# every launch; the tiled kernel's (more than 4 packed rows: prefill
# chunks, wide GQA groups), so decode's are launches - chunk_launches;
# the tiled kernel's on the tensor cores
paged_attention.launches = 0
paged_attention.chunk_launches = 0
paged_attention.tc_launches = 0
