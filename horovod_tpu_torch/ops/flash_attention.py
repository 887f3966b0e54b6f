"""Flash attention: the training attention, forward and backward.

:func:`flash_attention` is the counterpart of
``horovod_tpu/ops/flash_attention.py``'s function of the same name: the
same ``[batch, seq, heads, head_dim]`` layout, softmax scale ``1/√d``,
causal masking, per-sequence ``lengths`` for right-padded batches,
grouped-query attention (k/v with fewer heads, never repeated) and a
causal sliding ``window``, all composable. Padded query rows come out
zero and no gradient flows through padded positions.

It replaces the three Pallas kernels of that module with kernels written
by hand in CUDA C++ for Hopper, ``csrc/flash_attention.cu``, built with
``nvcc`` for ``sm_90a`` and bound through ``ctypes`` (``_build.py``):

* :func:`flash_fwd` (the forward, ``_flash_fwd``'s ``pallas_call``):
  ``o`` and the fp32 per-row logsumexp ``lse``;
* :func:`flash_bwd_dq` (``_dq_kernel``): dQ from the saved ``lse``;
* :func:`flash_bwd_dkv` (``_dkv_kernel``): dK and dV, summed over each
  KV head's group of query heads inside the kernel;
* :func:`flash_bwd_delta`: ``delta = rowsum(dO ⊙ O)``, the input both
  backward kernels share, once per backward.

The forward and each backward kernel come in two variants, chosen by
one rule, :func:`tensor_core_path`: bf16 with head_dim 64 or 128 runs on
the tensor cores (``wgmma``, ``csrc/hopper_mma.cuh``; the forward on the
tile step of ``csrc/attention_tc.cuh`` it shares with the paged
kernel), every other dtype and head_dim (fp32, fp16) on the CUDA cores.
``launches`` counts both; ``tc_launches`` the tensor-core ones. A call
whose kernel fails to build or launch raises: it never takes the other
variant or the plain version.

The four JAX custom VJPs (MHA or GQA, with or without lengths) are one
:class:`FlashAttentionFunction` here. The kernels read q, k, v, o and dO
through their strides in the ``[b, t, h, d]`` layout, so the slices of
the fused qkv projection go in without the ``[b·h, t, d]`` copies the
JAX wrapper makes.

Beside them, :func:`flash_fwd_plain`, :func:`flash_bwd_plain` and
:func:`flash_bwd_delta_plain` compute the same functions with the same
formulas in plain PyTorch: dense fp32 scores, the explicit ``dS = P ⊙
(dP − rowsum(dO ⊙ O))`` and the GQA group sum. Each wrapper takes the
plain version only for tensors on the CPU; for CUDA tensors it launches
its kernel or raises. Every launch adds one to the wrapper's
``launches``.

Numerics follow the reference: q is scaled before ``QKᵀ`` in the
forward, the backward scales after; masked scores get probability 0;
``lse = m + log(max(l, 1e-30))``; ``P V`` runs in fp32; outputs are
rounded once to the input's type. The tensor-core kernels scale after
the product and feed P (and dS) to their second products as bf16 pairs
``hi + lo`` (about 2^-17 relative a term), within one bf16 rounding of
the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build

LIBRARY = "flash_attention"
MAX_HEAD_DIM = 256
HEAD_DIM_MULTIPLE = 8  # one 16-byte load covers 8 two-byte elements
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
TENSOR_CORE_HEAD_DIMS = (64, 128)
_NEG_INF = -1e30
_N_TENSORS = 10  # q, k, v, o, dO, out, out2, lse, lengths, delta
_N_STRIDED = 7  # q, k, v, o, dO, out, out2


def tensor_core_path(dtype: torch.dtype, head_dim: int) -> bool:
    """The kernels' dispatch rule, forward and backward: bf16 at
    head_dim 64 or 128 runs on the tensor cores (``*_tc`` kernels),
    anything else on the CUDA cores. fp16 stays on the CUDA cores: the
    tensor-core kernels split P and dS into bf16 pairs, and an fp16 pair
    was never held to the card's check."""
    return dtype == torch.bfloat16 and head_dim in TENSOR_CORE_HEAD_DIMS


def unsupported_reason(head_dim: int) -> Optional[str]:
    """None when the kernels take this head_dim, else why not. The TPU
    gate's rungs (Mosaic's block divisibility, the VMEM budget) are gone:
    any sequence length runs. The kernels' own limit remains."""
    if head_dim < HEAD_DIM_MULTIPLE or head_dim > MAX_HEAD_DIM:
        return f"head_dim {head_dim} outside [8, {MAX_HEAD_DIM}]"
    if head_dim % HEAD_DIM_MULTIPLE:
        return f"head_dim {head_dim} is not a multiple of 8"
    return None


def _check(q, k, v, causal, lengths, window) -> Optional[int]:
    """The reference's validation; returns the effective window (None
    when it covers the whole sequence)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"q, k and v must be [batch, seq, heads, head_dim]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, t, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != t or (
        k.shape[3] != d
    ):
        raise ValueError(
            f"k {tuple(k.shape)} and v {tuple(v.shape)} must be [{b}, {t}, "
            f"kv_heads, {d}]"
        )
    kv_h = k.shape[2]
    if h % kv_h:
        raise ValueError(
            f"kv heads must match and divide q heads: q={h}, k={kv_h}, "
            f"v={v.shape[2]}"
        )
    if lengths is not None and tuple(lengths.shape) != (b,):
        raise ValueError(
            f"lengths must be [batch]=({b},), got {tuple(lengths.shape)}"
        )
    if window is not None:
        if not causal:
            raise ValueError("window= requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        window = int(window)
        if window >= t:
            window = None  # full causal attention
    return window


def _valid(t, causal, window, lengths, device, pad_rows):
    """``[b or 1, 1, t_query, t_key]`` bool: which pairs attend."""
    rows = torch.arange(t, device=device)[:, None]
    cols = torch.arange(t, device=device)[None, :]
    valid = torch.ones((t, t), dtype=torch.bool, device=device)
    if causal:
        valid = cols <= rows
    if window is not None:
        valid = valid & (rows - cols < window)
    valid = valid[None, None]
    if lengths is not None:
        lens = lengths.to(device=device, dtype=torch.long)
        lens = lens.clamp(0, t)[:, None, None, None]
        valid = valid & (cols[None, None] < lens)
        if pad_rows:
            valid = valid & (rows[None, None] < lens)
    return valid


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    # fp32 statistics, as the kernels; float64 stays float64 (gradcheck)
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _bhtd(x: torch.Tensor, r: int, dt: torch.dtype) -> torch.Tensor:
    """``[b, t, heads, d]`` → ``[b, heads·r, t, d]`` in ``dt``, each KV
    head repeated for its ``r`` query heads (the plain version's GQA)."""
    x = x.to(dt).transpose(1, 2)
    return x.repeat_interleave(r, dim=1) if r > 1 else x


def flash_fwd_plain(q, k, v, causal: bool = False, lengths=None,
                    window: Optional[int] = None):
    """The forward kernel's function in plain PyTorch: ``(o, lse)``, o
    ``[b, t, h, d]`` in q's type and lse ``[b·h, t]`` fp32. Rows with no
    live key get o = 0 and lse = −1e30 + log(1e−30)."""
    window = _check(q, k, v, causal, lengths, window)
    b, t, h, d = q.shape
    r = h // k.shape[2]
    dt = _acc_dtype(q)
    scale = 1.0 / (d ** 0.5)
    qf = q.to(dt).transpose(1, 2) * scale
    s = qf @ _bhtd(k, r, dt).transpose(-1, -2)  # [b, h, t, t]
    valid = _valid(t, causal, window, lengths, q.device, pad_rows=False)
    s = s.masked_fill(~valid, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = (p @ _bhtd(v, r, dt)) / l_safe
    lse = (m + torch.log(l_safe)).reshape(b * h, t)
    return o.transpose(1, 2).to(q.dtype), lse


def flash_bwd_plain(q, k, v, o, lse, do, causal: bool = False,
                    lengths=None, window: Optional[int] = None):
    """The backward kernels' function in plain PyTorch: ``(dq, dk, dv)``
    from the saved ``o`` and ``lse``, recomputing ``P = exp(scale·QKᵀ −
    lse)``; with ``lengths`` padded query rows get P = 0. dK and dV sum
    over each KV head's query-head group."""
    window = _check(q, k, v, causal, lengths, window)
    b, t, h, d = q.shape
    kvh = k.shape[2]
    r = h // kvh
    dt = _acc_dtype(q)
    scale = 1.0 / (d ** 0.5)
    qf = q.to(dt).transpose(1, 2)
    kf, vf = _bhtd(k, r, dt), _bhtd(v, r, dt)
    dof = do.to(dt).transpose(1, 2)
    s = scale * (qf @ kf.transpose(-1, -2))
    valid = _valid(t, causal, window, lengths, q.device,
                   pad_rows=lengths is not None)
    p = torch.where(valid, torch.exp(s - lse.to(dt).reshape(b, h, t, 1)),
                    0.0)
    dp = dof @ vf.transpose(-1, -2)
    delta = (dof * o.to(dt).transpose(1, 2)).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = scale * (ds @ kf)
    dk = (scale * (ds.transpose(-1, -2) @ qf)).reshape(b, kvh, r, t, d)
    dv = (p.transpose(-1, -2) @ dof).reshape(b, kvh, r, t, d)
    return (
        dq.transpose(1, 2).to(q.dtype),
        dk.sum(dim=2).transpose(1, 2).to(k.dtype),
        dv.sum(dim=2).transpose(1, 2).to(v.dtype),
    )


def flash_bwd_delta_plain(o, do):
    """``rowsum(dO ⊙ O)`` in fp32 as ``[b·h, t]``: the backward kernels'
    shared input, in plain PyTorch."""
    b, t, h, _ = o.shape
    dt = _acc_dtype(o)
    delta = (do.to(dt) * o.to(dt)).sum(dim=-1)  # [b, t, h]
    return delta.transpose(1, 2).reshape(b * h, t)


# ------------------------------------------------------------ the kernels

_ENTRIES = ("hvd_flash_fwd", "hvd_flash_fwd_tc", "hvd_flash_bwd_delta",
            "hvd_flash_bwd_dq", "hvd_flash_bwd_dkv", "hvd_flash_bwd_dq_tc",
            "hvd_flash_bwd_dkv_tc")


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in _ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, i, i, p]
        fn.restype = i
    lib.hvd_flash_error_string.argtypes = [i]
    lib.hvd_flash_error_string.restype = ctypes.c_char_p


def _kernel_input(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernels read it: head_dim contiguous, 16-byte aligned
    rows; a strided slice of the qkv projection passes as it is."""
    ok = (
        x.stride(3) == 1
        and all(s % HEAD_DIM_MULTIPLE == 0 for s in x.stride()[:3])
        and x.data_ptr() % 16 == 0
    )
    return x if ok else x.contiguous()


def _check_kernel(q, k, v, *more):
    if q.dtype not in DTYPE_CODES or any(
        x.dtype != q.dtype for x in (k, v) + more
    ):
        raise ValueError(
            f"the flash kernels take tensors of one dtype among "
            f"{sorted(map(str, DTYPE_CODES))}; got "
            f"{[str(x.dtype) for x in (q, k, v) + more]}"
        )
    reason = unsupported_reason(q.shape[3])
    if reason:
        raise ValueError(f"flash attention kernel: {reason}")
    if any(x.device != q.device for x in (k, v) + more):
        raise ValueError("q, k, v (and o, dO) must lie on one device")
    b, _, h, _ = q.shape
    if b * max(h, k.shape[2]) > 65535:
        raise ValueError(f"batch × heads = {b * h} exceeds 65535")


def _launch(entry: str, q, tensors, strided, causal, window, kv_heads):
    lib = _build.load(LIBRARY, _declare)
    ptrs = (ctypes.c_void_p * _N_TENSORS)(
        *[None if x is None else x.data_ptr() for x in tensors]
    )
    strides = []
    for x in strided:
        strides += [0, 0, 0] if x is None else list(x.stride()[:3])
    stride_arr = (ctypes.c_longlong * (3 * _N_STRIDED))(*strides)
    b, t, h, d = q.shape
    dims = (ctypes.c_int * 7)(b, t, h, kv_heads, d, int(bool(causal)),
                              int(window or 0))
    index = q.device.index
    if index is None:
        index = torch.cuda.current_device()
    err = getattr(lib, entry)(
        ptrs, stride_arr, dims, DTYPE_CODES[q.dtype], index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"{entry} kernel launch failed: "
            + lib.hvd_flash_error_string(err).decode()
        )


def _lengths_arg(lengths, device):
    if lengths is None:
        return None
    return lengths.to(device=device, dtype=torch.int32).contiguous()


def flash_fwd(q, k, v, causal: bool = False, lengths=None,
              window: Optional[int] = None):
    """``(o, lse)`` of attention over ``[b, t, h, d]`` q and ``[b, t,
    kv_heads, d]`` k/v: o in q's type, lse ``[b·h, t]`` fp32. CPU tensors
    take :func:`flash_fwd_plain`; CUDA tensors launch the kernel
    :func:`tensor_core_path` picks."""
    if q.device.type != "cuda":
        return flash_fwd_plain(q, k, v, causal, lengths, window)
    window = _check(q, k, v, causal, lengths, window)
    _check_kernel(q, k, v)
    q, k, v = (_kernel_input(x) for x in (q, k, v))
    b, t, h, d = q.shape
    tc = tensor_core_path(q.dtype, d)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    lens = _lengths_arg(lengths, q.device)
    _launch("hvd_flash_fwd_tc" if tc else "hvd_flash_fwd", q,
            [q, k, v, None, None, o, None, lse, lens, None],
            [q, k, v, None, None, o, None], causal, window, k.shape[2])
    flash_fwd.launches += 1
    flash_fwd.tc_launches += tc
    return o, lse


class _Bwd(NamedTuple):
    """The backward's inputs, validated and laid out for the kernels."""
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    o: torch.Tensor
    do: torch.Tensor
    lse: torch.Tensor
    lengths: Optional[torch.Tensor]
    causal: bool
    window: Optional[int]


def _bwd_inputs(q, k, v, o, lse, do, causal, lengths, window) -> _Bwd:
    window = _check(q, k, v, causal, lengths, window)
    _check_kernel(q, k, v, o, do)
    q, k, v, o, do = (_kernel_input(x) for x in (q, k, v, o, do))
    return _Bwd(q, k, v, o, do, lse.to(torch.float32).contiguous(),
                _lengths_arg(lengths, q.device), causal, window)


def _delta(o, do) -> torch.Tensor:
    b, t, h, _ = o.shape
    delta = torch.empty((b * h, t), dtype=torch.float32, device=o.device)
    _launch("hvd_flash_bwd_delta", o,
            [None, None, None, o, do, None, None, None, None, delta],
            [None, None, None, o, do, None, None], False, None, h)
    flash_bwd_delta.launches += 1
    return delta


def _dq(a: _Bwd, delta: torch.Tensor) -> torch.Tensor:
    tc = tensor_core_path(a.q.dtype, a.q.shape[3])
    dq = torch.empty_like(a.q, memory_format=torch.contiguous_format)
    _launch("hvd_flash_bwd_dq_tc" if tc else "hvd_flash_bwd_dq", a.q,
            [a.q, a.k, a.v, None, a.do, dq, None, a.lse, a.lengths, delta],
            [a.q, a.k, a.v, None, a.do, dq, None], a.causal, a.window,
            a.k.shape[2])
    flash_bwd_dq.launches += 1
    flash_bwd_dq.tc_launches += tc
    return dq


def _dkv(a: _Bwd, delta: torch.Tensor):
    tc = tensor_core_path(a.q.dtype, a.q.shape[3])
    dk = torch.empty_like(a.k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(a.v, memory_format=torch.contiguous_format)
    _launch("hvd_flash_bwd_dkv_tc" if tc else "hvd_flash_bwd_dkv", a.q,
            [a.q, a.k, a.v, None, a.do, dk, dv, a.lse, a.lengths, delta],
            [a.q, a.k, a.v, None, a.do, dk, dv], a.causal, a.window,
            a.k.shape[2])
    flash_bwd_dkv.launches += 1
    flash_bwd_dkv.tc_launches += tc
    return dk, dv


def _delta_arg(a: _Bwd, delta) -> torch.Tensor:
    if delta is None:
        return _delta(a.o, a.do)
    b, t, h, _ = a.q.shape
    if (delta.shape != (b * h, t) or delta.dtype != torch.float32
            or delta.device != a.q.device):
        raise ValueError(
            f"delta must be fp32 [b·h, t] = [{b * h}, {t}] on "
            f"{a.q.device}; got {delta.dtype} {tuple(delta.shape)} on "
            f"{delta.device}"
        )
    return delta.contiguous()


def flash_bwd_delta(o, do):
    """``rowsum(dO ⊙ O)`` of ``[b, t, h, d]`` o and dO as fp32 ``[b·h,
    t]``; CPU tensors take :func:`flash_bwd_delta_plain`."""
    if o.device.type != "cuda":
        return flash_bwd_delta_plain(o, do)
    if o.shape != do.shape or o.dim() != 4:
        raise ValueError(
            f"o {tuple(o.shape)} and dO {tuple(do.shape)} must be one "
            "[batch, seq, heads, head_dim] shape"
        )
    _check_kernel(o, o, o, do)
    return _delta(_kernel_input(o), _kernel_input(do))


def flash_bwd_dq(q, k, v, o, lse, do, causal: bool = False, lengths=None,
                 window: Optional[int] = None, delta=None):
    """dQ of :func:`flash_fwd` given its ``o``, ``lse`` and the incoming
    ``do``; ``delta`` (:func:`flash_bwd_delta`) is computed when not
    given. CPU tensors take :func:`flash_bwd_plain`."""
    if q.device.type != "cuda":
        return flash_bwd_plain(q, k, v, o, lse, do, causal, lengths,
                               window)[0]
    a = _bwd_inputs(q, k, v, o, lse, do, causal, lengths, window)
    return _dq(a, _delta_arg(a, delta))


def flash_bwd_dkv(q, k, v, o, lse, do, causal: bool = False, lengths=None,
                  window: Optional[int] = None, delta=None):
    """``(dk, dv)`` of :func:`flash_fwd`, each KV head's sum over its
    query-head group; ``delta`` is computed when not given. CPU tensors
    take :func:`flash_bwd_plain`."""
    if q.device.type != "cuda":
        return flash_bwd_plain(q, k, v, o, lse, do, causal, lengths,
                               window)[1:]
    a = _bwd_inputs(q, k, v, o, lse, do, causal, lengths, window)
    return _dkv(a, _delta_arg(a, delta))


flash_fwd.launches = flash_fwd.tc_launches = 0
flash_bwd_delta.launches = 0
flash_bwd_dq.launches = flash_bwd_dq.tc_launches = 0
flash_bwd_dkv.launches = flash_bwd_dkv.tc_launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """One differentiable attention for every variant (MHA or GQA, with
    or without ``lengths``, with or without ``window``): the forward
    kernel, then the delta pass, dQ and dK/dV from the saved fp32
    ``lse``. On the CPU the plain backward computes all three at once."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, causal, window):
        o, lse = flash_fwd(q, k, v, causal, lengths, window)
        ctx.save_for_backward(q, k, v, o, lse, lengths)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, lengths = ctx.saved_tensors
        args = (q, k, v, o, lse, do.contiguous(), ctx.causal, lengths,
                ctx.window)
        if q.device.type == "cuda":
            a = _bwd_inputs(*args)  # validated and laid out once
            delta = _delta(a.o, a.do)
            dq = _dq(a, delta)
            dk, dv = _dkv(a, delta)
        else:
            dq, dk, dv = flash_bwd_plain(*args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = False, lengths=None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Attention over ``[batch, seq, heads, head_dim]`` tensors, softmax
    scale ``1/√d``, differentiable, with the reference's contract.

    ``lengths`` (``[batch]`` int): valid tokens per right-padded
    sequence. Keys at or past a sequence's length are masked, outputs at
    padded query rows are zero, and no gradient flows through padded
    positions. k/v may carry fewer heads than q (grouped-query
    attention). ``window`` (requires ``causal``): row i attends keys in
    ``(i − window, i]``. Any sequence length runs."""
    lens = None
    if lengths is not None:
        lens = torch.as_tensor(lengths, device=q.device).to(torch.int32)
    window = _check(q, k, v, causal, lens, window)
    out = FlashAttentionFunction.apply(q, k, v, lens, causal, window)
    if lens is None:
        return out
    # zero padded query rows outside the Function: the contract, and the
    # zeroed cotangent keeps their dq/dk/dv contributions at zero
    t = q.shape[1]
    valid = torch.arange(t, device=q.device)[None, :] < lens[:, None].long()
    return torch.where(valid[:, :, None, None], out, 0.0)
