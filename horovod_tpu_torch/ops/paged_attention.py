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
``paged_attention.launches`` (at capture only, under a CUDA graph: a
replay launches without Python).

The model calls it as the ``torch.library`` custom operator
``hvd_torch::paged_attention`` (``OPS.paged_attention``), with a fake
shaped like q, so the engine's decode step can be captured into a CUDA
graph and a compiled forward traces it, as the JAX kernel runs inside
the compiled decode executable.

The kernel comes in three variants, chosen by one rule,
:func:`kernel_variant`, on the packed query rows of one (slot, KV head),
``t · h / kv_heads``: at most 4 (every decode step of an MHA model) take
the decode kernel, which splits each slot's keys over blocks
(:func:`split_plan`: 64 keys a block, the number of splits from the
table's width, so the wrapper never reads ``lengths`` on the host),
each block writing its split's softmax state to a workspace and the
last live split of a (slot, KV head) merging them; more (prefill
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
import threading
from typing import Optional

import torch

from . import _build
from .flash_attention import tensor_core_path

LIBRARY = "paged_attention"
MAX_HEAD_DIM = 256
HEAD_DIM_MULTIPLE = 8  # one 16-byte load covers 8 two-byte elements
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
DECODE_MAX_ROWS = 4  # packed rows a (slot, KV head) the decode kernel takes
SPLIT_KEYS = 64  # keys a block of the decode kernel takes (split_plan)
# the kernel variants; the tiled ones as csrc/paged_attention.cu's Variant
# numbers them (the decode kernel has its own entry, hvd_paged_decode)
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
    lib.hvd_paged_decode.argtypes = [p] * 8 + [ctypes.POINTER(i), p]
    lib.hvd_paged_decode.restype = i
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


def split_plan(n_logical: int, page_tokens: int):
    """The decode kernel's split of a slot's keys over blocks, from the
    table's width alone (never from ``lengths``, which lie on the card):
    ``(split_pages, n_splits)``, a split being ``split_pages`` pages of
    the table (``SPLIT_KEYS`` keys, or one page where a page holds more),
    ``n_splits = ceil(n_logical / split_pages)`` of them a (slot, KV
    head). A split past a slot's live keys exits at once."""
    split_pages = max(1, SPLIT_KEYS // page_tokens)
    return split_pages, -(-n_logical // split_pages)


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
    :func:`kernel_variant` names. The checks run once a geometry (the
    shapes, dtypes, device and ``causal``), then the call is a launch.
    """
    if not _on_cuda(q):
        return paged_attention_plain(
            q, k_pool, v_pool, page_table, lengths, causal=causal
        )
    key = (q.shape, k_pool.shape, v_pool.shape, page_table.shape,
           lengths.shape, q.dtype, k_pool.dtype, v_pool.dtype, q.device,
           causal)
    plan = _plans.get(key)
    if plan is None:
        _check(q, k_pool, v_pool, page_table, lengths)
        _, t, h, d = q.shape
        variant = kernel_variant(q.dtype, d, t * (h // k_pool.shape[2]))
        plan = _plans[key] = _Plan(q, k_pool, v_pool, page_table, causal,
                                   variant)
    out = plan.launch(q, k_pool, v_pool, page_table, lengths)
    _count(plan.variant)
    return out


def _count(variant: str) -> None:
    """One launch of ``variant``, on the wrapper's counters and on this
    thread's (:func:`thread_counts`)."""
    fn = paged_attention
    mine = getattr(_local, "counts", None)
    if mine is None:
        mine = _local.counts = dict.fromkeys(COUNTERS, 0)
    keys = ["launches"]
    if variant != "decode":
        keys.append("chunk_launches")
        if variant == "tensor_cores":
            keys.append("tc_launches")
    for key in keys:
        setattr(fn, key, getattr(fn, key) + 1)
        mine[key] += 1


def thread_counts() -> dict:
    """This thread's launches by counter (``launches``,
    ``chunk_launches``, ``tc_launches``): what a capture on this thread
    recorded, whatever other threads launched meanwhile."""
    return dict(getattr(_local, "counts", None)
                or dict.fromkeys(COUNTERS, 0))


def _launch(q, k_pool, v_pool, page_table, lengths, causal, variant):
    """One launch of the kernel ``variant`` (a key of VARIANT_CODES),
    past the dispatch rule and the launch counters. Raises on what the
    kernels do not take."""
    _check(q, k_pool, v_pool, page_table, lengths)
    plan = _Plan(q, k_pool, v_pool, page_table, causal, variant)
    return plan.launch(q, k_pool, v_pool, page_table, lengths)


class _Plan:
    """One geometry's launch: checked, its library loaded and its
    integer arguments packed once, so a call costs the launch."""

    def __init__(self, q, k_pool, v_pool, page_table, causal, variant):
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
        if b > 65535 or kvh > 65535:
            raise ValueError(f"batch {b} or kv_heads {kvh} exceeds 65535")
        if variant == "decode" and t * (h // kvh) > DECODE_MAX_ROWS:
            raise ValueError(
                f"the decode kernel takes at most {DECODE_MAX_ROWS} packed "
                f"rows a KV head; got {t * (h // kvh)}"
            )
        self.lib = _build.load(LIBRARY, _declare)
        self.variant = variant
        self.device = q.device
        n_logical = page_table.shape[1]
        if variant == "decode":
            split_pages, n_splits = split_plan(n_logical, page_tokens)
            self.ws_numel = b * kvh * n_splits * (8 + 4 * d)
            self.tickets_numel = b * kvh
            self.params = (ctypes.c_int * 13)(
                b, t, h, kvh, d, num_pages, page_tokens, n_logical,
                split_pages, n_splits, int(bool(causal)),
                DTYPE_CODES[q.dtype], self.device.index or 0)
        else:
            self.args = (b, t, h, kvh, d, num_pages, page_tokens, n_logical,
                         int(bool(causal)), VARIANT_CODES[variant],
                         DTYPE_CODES[q.dtype], self.device.index or 0)

    def launch(self, q, k_pool, v_pool, page_table, lengths):
        k_ptr, v_ptr = k_pool.data_ptr(), v_pool.data_ptr()
        if (k_ptr | v_ptr) % 16 or not (k_pool.is_contiguous()
                                        and v_pool.is_contiguous()):
            raise ValueError(
                "k_pool and v_pool must be contiguous and 16-byte aligned")
        q = q.contiguous()
        if (page_table.dtype != torch.int32 or not page_table.is_contiguous()
                or page_table.device != q.device):
            page_table = page_table.to(device=q.device, dtype=torch.int32)
            page_table = page_table.contiguous()
        if (lengths.dtype != torch.int32 or not lengths.is_contiguous()
                or lengths.device != q.device):
            lengths = lengths.to(device=q.device, dtype=torch.int32)
            lengths = lengths.contiguous()
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        if self.variant == "decode":
            ws = torch.empty(self.ws_numel, dtype=torch.float32,
                             device=q.device)
            err = self.lib.hvd_paged_decode(
                q.data_ptr(), k_ptr, v_ptr,
                page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                ws.data_ptr(), _tickets(self.device, self.tickets_numel),
                self.params, stream)
        else:
            err = self.lib.hvd_paged_attention(
                q.data_ptr(), k_ptr, v_ptr,
                page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                *self.args, stream)
        if err:
            raise RuntimeError(
                f"paged_attention kernel ({self.variant}) launch failed: "
                + self.lib.hvd_cuda_error_string(err).decode()
            )
        return out


def _tickets(device: torch.device, numel: int) -> int:
    """The decode merge's ticket words on ``device``: zeroed once, left
    zeroed by every launch (the block that takes a (slot, KV head)'s
    last ticket resets it), so a call adds no memset. Calls on one
    device share them, so they must not overlap in time on two streams.
    Grows outside a CUDA graph capture only, and a grown buffer never
    frees the one it replaces: a captured graph keeps its address."""
    buf = _ticket_words.get(device)
    if buf is None or buf.numel() < numel:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "paged_attention's decode kernel needs more ticket words "
                "than it holds; run the call once before capturing it")
        if buf is not None:
            _retired_tickets.append(buf)
        buf = _ticket_words[device] = torch.zeros(
            max(numel, MIN_TICKET_WORDS), dtype=torch.int32, device=device)
    return buf.data_ptr()


MIN_TICKET_WORDS = 1 << 16  # 256 KiB: (slots × KV heads) up to 65536
COUNTERS = ("launches", "chunk_launches", "tc_launches")
_local = threading.local()
_plans = {}
_ticket_words = {}
_retired_tickets = []

# every launch; the tiled kernel's (more than 4 packed rows: prefill
# chunks, wide GQA groups), so decode's are launches - chunk_launches;
# the tiled kernel's on the tensor cores
paged_attention.launches = 0
paged_attention.chunk_launches = 0
paged_attention.tc_launches = 0


# ------------------------------------------------------- custom operator


@torch.library.custom_op("hvd_torch::paged_attention", mutates_args=(),
                         device_types="cuda")
def _paged_attention_op(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, page_table: torch.Tensor,
                        lengths: torch.Tensor, causal: bool) -> torch.Tensor:
    """B7 as an operator: :func:`paged_attention` (the variant
    :func:`kernel_variant` picks). The decode kernel keeps hidden state,
    its per-device ticket words, which every launch leaves zeroed; so
    a replayed graph and an eager call see the same zeroed words, as
    long as they do not overlap on two streams."""
    return paged_attention(q, k_pool, v_pool, page_table, lengths,
                           causal=causal)


_paged_attention_op.register_kernel("cpu")(
    lambda q, k_pool, v_pool, page_table, lengths, causal:
    paged_attention_plain(q, k_pool, v_pool, page_table, lengths,
                          causal=causal).contiguous())


@_paged_attention_op.register_fake
def _(q, k_pool, v_pool, page_table, lengths, causal):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


OPS = torch.ops.hvd_torch


def warm_operator() -> None:
    """One call of the operator on tiny CPU tensors (its plain version:
    no launch, no count). A process's first call of a ``torch.library``
    custom operator imports parts of PyTorch's compiler, seconds of
    host; the engine pays them when it is built, not in a request."""
    q = torch.zeros((1, 1, 1, HEAD_DIM_MULTIPLE))
    pool = torch.zeros((1, 1, 1, HEAD_DIM_MULTIPLE))
    idx = torch.zeros((1, 1), dtype=torch.int32)
    OPS.paged_attention(q, pool, pool, idx, idx[0], True)
