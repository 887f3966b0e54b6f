"""Wire kernels: scale-cast, int8 stochastic quantization and the Adasum
combine.

The counterpart of ``horovod_tpu/ops/pallas_kernels.py``, with its
function names. Its Pallas kernels become kernels written by hand in
CUDA C++ for Hopper, ``csrc/cuda_kernels.cu`` (the file name its
docstring gives for its own model, the reference's
``horovod/common/ops/cuda/cuda_kernels.cu``), built with ``nvcc`` for
``sm_90a`` and bound through ``ctypes`` (``_build.py``):

* :func:`scale_cast` — ``(float32(x) * s).astype(out_dtype)``;
  :func:`int8_dequantize` is this kernel;
* :func:`int8_quantize` — one scale ``max(absmax, 1e-30) / 127`` per
  tensor (the product with fp32(1/127) that XLA makes of the JAX
  wrapper's division, so the scales agree bitwise), stochastic rounding
  to int8 (two launches, absmax then rounding, 16 bytes a thread a
  load);
* :func:`int8_block_quantize` — one scale per ``block_size`` elements,
  stochastic rounding, in one pass that reads x once (at the paths'
  blocks a warp holds a block in registers; the variant comes from the
  block size alone, :func:`block_quantize_variant`); with ``rows=True`` a
  2-D tensor's blocks follow its rows (the fused wire's per-peer chunks);
* :func:`adasum_dots` and :func:`adasum_apply` — ``[a·b, a·a, b·b]``
  with fp32 accumulation (a deterministic two-stage reduction), then
  ``ca·a + cb·b`` with the coefficients computed on the device from
  those sums; :func:`adasum_pair` is the two together.

Each has a ``*_plain`` version in plain PyTorch computing the same
function. A wrapper takes the plain version only for a tensor on the
CPU; a CUDA tensor launches the kernel or raises. Every launch adds one
to the wrapper's ``launches``. :func:`int8_block_dequantize` is plain
PyTorch on every device, as the JAX function is plain jnp.

A ctypes call is opaque to ``torch.compile``, so each kernel is also a
``torch.library`` custom operator in the port's namespace ``hvd_torch``
(:data:`OPS`, e.g. ``OPS.int8_block_quantize``): its CUDA implementation
is the wrapper, so the launch counter advances inside a compiled call
too; its CPU implementation is the plain version; a fake implementation
states the outputs' shapes and dtypes for tracing. The in-step
collectives (``ops/traced.py``) call the operators; the eager paths
(fusion, Adasum's tree, the codecs) call the wrappers, which skip the
dispatcher.

The stochastic rounding's uniform ``u`` is a pure function of (seed,
stream, element index): element ``i`` takes word ``i % 4`` of
Philox4x32-10 at counter ``(i // 4, 0, 0)`` under key ``(seed,
stream)``, ``u = (bits >> 8) · 2⁻²⁴``. The plain versions compute the
same Philox in int64 torch ops (:func:`philox4x32_10`), and every
division is IEEE on both sides, so a kernel and its plain version agree
bit for bit, values and scales. Against the JAX package, whose
interpret path draws ``u`` from ``jax.random``, they agree by contract:
equal scales, each value ``floor`` or ``floor + 1`` of ``x / scale``,
unbiased means.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

LIBRARY = "cuda_kernels"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int8: 3}
FLOAT_CODES = {k: v for k, v in DTYPE_CODES.items() if k != torch.int8}
DOTS_MAX_GRID = 1024  # the dots kernel's partials: 3 × this many floats
QUANTIZE_PARTIALS = 1024  # the per-tensor quantizer's per-block maxima

_INV_127 = 1.0 / 127.0  # rounded to fp32 where it meets an fp32 tensor
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_uint)
    lib.hvd_scale_cast.argtypes = [p, i, p, p, i, ll, i, p]
    lib.hvd_int8_quantize.argtypes = [p, i, ll, p, p, p, u, u, i, p]
    lib.hvd_int8_block_quantize.argtypes = [p, i, ll, ll, ll, i, i, p, p,
                                            u, u, i, p]
    lib.hvd_adasum_dots.argtypes = [p, p, i, ll, p, p, i, p]
    lib.hvd_adasum_apply.argtypes = [p, p, p, p, i, ll, i, p]
    for fn in (lib.hvd_scale_cast, lib.hvd_int8_quantize,
               lib.hvd_int8_block_quantize, lib.hvd_adasum_dots,
               lib.hvd_adasum_apply):
        fn.restype = i
    lib.hvd_wire_error_string.argtypes = [i]
    lib.hvd_wire_error_string.restype = ctypes.c_char_p


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _device_args(t: torch.Tensor):
    index = t.device.index
    if index is None:
        index = torch.cuda.current_device()
    return index, torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, lib, what: str) -> None:
    if err:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            + lib.hvd_wire_error_string(err).decode()
        )


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1)


def _check_dtype(x: torch.Tensor, codes, what: str) -> None:
    if x.dtype not in codes:
        raise ValueError(
            f"{what} takes {sorted(map(str, codes))}; got {x.dtype}"
        )


def _u32(v) -> int:
    return int(v) & _MASK32


# --------------------------------------------------------------- Philox


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of ``a · m`` for int64 ``a`` in [0, 2³²),
    through 16-bit halves of ``m`` so no product leaves int64."""
    p1 = a * (m & 0xFFFF)
    p2 = a * (m >> 16)
    mid = p1 + ((p2 & 0xFFFF) << 16)
    return (p2 >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding 32-bit words (Random123's
    round function), the plain twin of the kernels' ``philox``. Returns
    the four output words."""
    k0, k1 = _u32(k0), _u32(k1)
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def random_words(n: int, seed: int, stream: int, device) -> torch.Tensor:
    """The 32-bit words (as int64) of elements ``0 .. n-1``: word
    ``i % 4`` of Philox at counter ``(i // 4, 0, 0)``, key (seed,
    stream)."""
    nq = -(-n // 4)
    q = torch.arange(nq, dtype=torch.int64, device=device)
    zero = torch.zeros_like(q)
    words = philox4x32_10(q & _MASK32, q >> 32, zero, zero, seed, stream)
    return torch.stack(words, dim=1).reshape(-1)[:n]


def _uniform(n: int, seed: int, stream: int, device) -> torch.Tensor:
    bits = random_words(n, seed, stream, device)
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


def _round_plain(xf, scale, u):
    """floor(x / scale) + (u < frac), clipped, as int8 (all fp32)."""
    scaled = xf / scale
    floor = torch.floor(scaled)
    rounded = floor + (u < scaled - floor).to(torch.float32)
    return rounded.clamp_(-128.0, 127.0).to(torch.int8)


def _scale_plain(absmax: torch.Tensor) -> torch.Tensor:
    """max(absmax, 1e-30) / 127 as XLA computes the JAX wrapper's
    division, and as the kernels do: times the fp32 reciprocal of 127."""
    return absmax.clamp_min(1e-30) * torch.full_like(absmax, _INV_127)


# ------------------------------------------------------------ scale_cast


def scale_cast_plain(x, scale, out_dtype=None) -> torch.Tensor:
    out_dtype = out_dtype or x.dtype
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    return (x.to(torch.float32) * s.reshape(())).to(out_dtype)


def scale_cast(x: torch.Tensor, scale, out_dtype=None) -> torch.Tensor:
    """``(float32(x) * scale).astype(out_dtype)`` (out_dtype defaults to
    x's). ``scale`` is a float or a one-element fp32 tensor; on the card
    it is read from device memory, never from the host."""
    if not _on_cuda(x):
        return scale_cast_plain(x, scale, out_dtype)
    out_dtype = out_dtype or x.dtype
    _check_dtype(x, DTYPE_CODES, "scale_cast")
    _check_dtype(torch.empty(0, dtype=out_dtype), FLOAT_CODES,
                 "scale_cast's out_dtype")
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    s = s.reshape(1).contiguous()
    xf = _flat(x)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    lib = _build.load(LIBRARY, _declare)
    err = lib.hvd_scale_cast(xf.data_ptr(), DTYPE_CODES[x.dtype],
                             s.data_ptr(), out.data_ptr(),
                             DTYPE_CODES[out_dtype], xf.numel(),
                             *_device_args(x))
    _raise_on(err, lib, "scale_cast")
    scale_cast.launches += 1
    return out


scale_cast.launches = 0


def int8_dequantize(values, scale, out_dtype=torch.float32):
    """Inverse of :func:`int8_quantize`: exactly a scale-cast, so it is
    :func:`scale_cast`."""
    return scale_cast(values, scale, out_dtype)


# --------------------------------------------------- per-tensor quantize


def int8_quantize_plain(x, seed=0, stream=0):
    xf = x.reshape(-1).to(torch.float32)
    scale = _scale_plain(xf.abs().max() if xf.numel() else
                         xf.new_zeros(()))
    vals = _round_plain(xf, scale, _uniform(xf.numel(), seed, stream,
                                            x.device))
    return vals.reshape(x.shape), scale


def int8_quantize(x: torch.Tensor, seed=0, stream=0):
    """Quantize to int8 with one fp32 scale for the tensor and
    stochastic rounding. Returns ``(values_int8, scale_f32)`` with
    ``x ≈ values * scale``; ``scale`` is a 0-dim tensor on x's device."""
    if not _on_cuda(x):
        return int8_quantize_plain(x, seed, stream)
    _check_dtype(x, FLOAT_CODES, "int8_quantize")
    xf = _flat(x)
    if xf.data_ptr() % 16:  # the kernel reads 16 bytes at a time
        xf = xf.clone()
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((), dtype=torch.float32, device=x.device)
    partials = torch.empty((QUANTIZE_PARTIALS,), dtype=torch.float32,
                           device=x.device)
    lib = _build.load(LIBRARY, _declare)
    err = lib.hvd_int8_quantize(xf.data_ptr(), DTYPE_CODES[x.dtype],
                                xf.numel(), partials.data_ptr(),
                                scale.data_ptr(), q.data_ptr(), _u32(seed),
                                _u32(stream), *_device_args(x))
    _raise_on(err, lib, "int8_quantize")
    int8_quantize.launches += 1
    return q, scale


int8_quantize.launches = 0


# ------------------------------------------------------- block quantize


def _as_rows(x: torch.Tensor, rows: bool):
    if rows:
        if x.dim() != 2:
            raise ValueError(
                f"rows=True takes a [rows, cols] tensor; got "
                f"{tuple(x.shape)}"
            )
        return x.shape[0], x.shape[1]
    return 1, x.numel()


def int8_block_quantize_plain(x, block_size=512, seed=0, stream=0,
                              rows=False):
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    r, c = _as_rows(x, rows)
    xf = x.reshape(r, c).to(torch.float32)
    nb = -(-c // block_size)
    pad = nb * block_size - c
    blocks = F.pad(xf, (0, pad)).reshape(r, nb, block_size)
    scales = _scale_plain(blocks.abs().amax(dim=2) if c else
                          xf.new_zeros((r, 0)))
    per_elem = scales.repeat_interleave(block_size, dim=1)[:, :c]
    u = _uniform(r * c, seed, stream, x.device).reshape(r, c)
    vals = _round_plain(xf, per_elem, u).reshape(x.shape)
    return vals, (scales if rows else scales.reshape(nb))


# B3's variants, by block size alone (the kernels' comment in
# csrc/cuda_kernels.cu describes each)
BLOCK_VARIANTS = ("lanes", "warp", "cta", "cta_reread")
WARP_MIN_BLOCK = 32     # a warp a block from here
WARP_MAX_BLOCK = 2048   # the register window: 2048 fp32 values a warp
CTA_STAGE_MAX = 8192    # a CTA a block, staged as fp32 in 32 KB of smem


def block_quantize_variant(block_size: int) -> str:
    """The block quantizer's variant for ``block_size``: ``lanes`` below
    a warp (several blocks a warp), ``warp`` up to the register window
    (a warp a block, held in registers), ``cta`` up to what 32 KB of
    shared memory stages (a CTA a block), ``cta_reread`` above (a CTA a
    block, read again for the rounding)."""
    if block_size < WARP_MIN_BLOCK:
        return "lanes"
    if block_size <= WARP_MAX_BLOCK:
        return "warp"
    if block_size <= CTA_STAGE_MAX:
        return "cta"
    return "cta_reread"


def int8_block_quantize(x: torch.Tensor, block_size: int = 512, seed=0,
                        stream=0, rows: bool = False):
    """Block-scaled int8: one fp32 scale per ``block_size`` elements,
    stochastic rounding. Returns ``(values_int8, scales_f32)``, values
    shaped like ``x``. By default the tensor is flat and ``scales`` is
    ``[ceil(n / block_size)]``, as the JAX function; with ``rows=True``
    a ``[rows, cols]`` tensor is quantized row by row, blocks never
    crossing a row, and ``scales`` is ``[rows, ceil(cols /
    block_size)]``. A short tail block is zero-padded for the absmax
    only: padding never sets a scale and never writes a value.

    On the card the variant is :func:`block_quantize_variant`'s, and a
    base address that is not 16-byte aligned (a view such as ``x[1:]``)
    takes scalar loads instead of 16-byte ones."""
    if not _on_cuda(x):
        return int8_block_quantize_plain(x, block_size, seed, stream, rows)
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    _check_dtype(x, FLOAT_CODES, "int8_block_quantize")
    r, c = _as_rows(x, rows)
    nb = -(-c // block_size)
    xf = _flat(x)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((r, nb), dtype=torch.float32, device=x.device)
    variant = BLOCK_VARIANTS.index(block_quantize_variant(block_size))
    aligned = int(xf.data_ptr() % 16 == 0)
    lib = _build.load(LIBRARY, _declare)
    err = lib.hvd_int8_block_quantize(
        xf.data_ptr(), DTYPE_CODES[x.dtype], r, c, int(block_size), variant,
        aligned, q.data_ptr(), scales.data_ptr(), _u32(seed), _u32(stream),
        *_device_args(x),
    )
    _raise_on(err, lib, "int8_block_quantize")
    int8_block_quantize.launches += 1
    return q, (scales if rows else scales.reshape(nb))


int8_block_quantize.launches = 0


def int8_block_dequantize(values, scales, block_size: int = 512,
                          out_dtype=torch.float32):
    """Inverse of :func:`int8_block_quantize`, in plain PyTorch on every
    device (the JAX function is plain jnp too). A 2-D ``scales`` means
    the row form."""
    if scales.dim() == 2:
        r, c = values.shape
    else:
        r, c = 1, values.numel()
    per_elem = scales.reshape(r, -1).to(torch.float32).repeat_interleave(
        block_size, dim=1)[:, :c]
    out = values.reshape(r, c).to(torch.float32) * per_elem
    return out.reshape(values.shape).to(out_dtype)


# ---------------------------------------------------------------- adasum


def _check_pair(a, b, what):
    if a.shape != b.shape:
        raise ValueError(
            f"{what}: shapes {tuple(a.shape)} and {tuple(b.shape)} differ"
        )
    if a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"{what}: a and b must share dtype and device")


def adasum_dots_plain(a, b) -> torch.Tensor:
    af = a.reshape(-1).to(torch.float32)
    bf = b.reshape(-1).to(torch.float32)
    return torch.stack([(af * bf).sum(), (af * af).sum(), (bf * bf).sum()])


def adasum_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[a·b, a·a, b·b]`` as an fp32 ``[3]`` tensor on a's device, fp32
    accumulation whatever the input type. On the card: per-CTA partials
    over a grid that depends on the size alone, summed in a fixed order
    by one CTA, so equal inputs give equal bits."""
    _check_pair(a, b, "adasum_dots")
    if not _on_cuda(a):
        return adasum_dots_plain(a, b)
    _check_dtype(a, FLOAT_CODES, "adasum_dots")
    af, bf = _flat(a), _flat(b)
    partials = torch.empty((3 * DOTS_MAX_GRID,), dtype=torch.float32,
                           device=a.device)
    out = torch.empty((3,), dtype=torch.float32, device=a.device)
    lib = _build.load(LIBRARY, _declare)
    err = lib.hvd_adasum_dots(af.data_ptr(), bf.data_ptr(),
                              DTYPE_CODES[a.dtype], af.numel(),
                              partials.data_ptr(), out.data_ptr(),
                              *_device_args(a))
    _raise_on(err, lib, "adasum_dots")
    adasum_dots.launches += 1
    return out


adasum_dots.launches = 0


def adasum_coefficients(dots: torch.Tensor) -> torch.Tensor:
    """``[1 − a·b/(2‖a‖²), 1 − a·b/(2‖b‖²)]``, a coefficient of 1 where
    its norm is 0, in fp32 on the dots' device."""
    dot, asq, bsq = dots[0], dots[1], dots[2]
    two = torch.full_like(asq, 2.0)
    zero = torch.zeros_like(asq)
    ca = 1.0 - torch.where(asq > 0, dot / (two * asq), zero)
    cb = 1.0 - torch.where(bsq > 0, dot / (two * bsq), zero)
    return torch.stack([ca, cb])


def adasum_apply_plain(a, b, dots) -> torch.Tensor:
    ca, cb = adasum_coefficients(dots.to(torch.float32))
    return (ca * a.to(torch.float32) + cb * b.to(torch.float32)).to(a.dtype)


def adasum_apply(a: torch.Tensor, b: torch.Tensor,
                 dots: torch.Tensor) -> torch.Tensor:
    """``ca·a + cb·b`` in a's dtype, the coefficients computed on the
    device from ``dots = [a·b, ‖a‖², ‖b‖²]`` (fp32 ``[3]``)."""
    _check_pair(a, b, "adasum_apply")
    if not _on_cuda(a):
        return adasum_apply_plain(a, b, dots)
    _check_dtype(a, FLOAT_CODES, "adasum_apply")
    if dots.dtype != torch.float32 or dots.numel() != 3 or (
        dots.device != a.device
    ):
        raise ValueError("adasum_apply takes fp32 [3] dots on a's device")
    af, bf, d = _flat(a), _flat(b), dots.contiguous()
    out = torch.empty_like(a, memory_format=torch.contiguous_format)
    lib = _build.load(LIBRARY, _declare)
    err = lib.hvd_adasum_apply(af.data_ptr(), bf.data_ptr(), d.data_ptr(),
                               out.data_ptr(), DTYPE_CODES[a.dtype],
                               af.numel(), *_device_args(a))
    _raise_on(err, lib, "adasum_apply")
    adasum_apply.launches += 1
    return out


adasum_apply.launches = 0


def adasum_pair_plain(a, b) -> torch.Tensor:
    return adasum_apply_plain(a, b, adasum_dots_plain(a, b))


def adasum_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The Adasum combine of two same-shaped tensors: the dots pass,
    then the apply pass, both kernels on the card."""
    return adasum_apply(a, b, adasum_dots(a, b))


KERNELS = (scale_cast, int8_quantize, int8_block_quantize, adasum_dots,
           adasum_apply)


# ------------------------------------------------------- custom operators


@torch.library.custom_op("hvd_torch::scale_cast", mutates_args=(),
                         device_types="cuda")
def _scale_cast_op(x: torch.Tensor, scale: torch.Tensor,
                   out_dtype: torch.dtype) -> torch.Tensor:
    return scale_cast(x, scale, out_dtype)


_scale_cast_op.register_kernel("cpu")(
    lambda x, scale, out_dtype: scale_cast_plain(x, scale, out_dtype))


@_scale_cast_op.register_fake
def _(x, scale, out_dtype):
    return x.new_empty(x.shape, dtype=out_dtype)


@torch.library.custom_op("hvd_torch::int8_quantize", mutates_args=(),
                         device_types="cuda")
def _int8_quantize_op(x: torch.Tensor, seed: int,
                      stream: int) -> tuple[torch.Tensor, torch.Tensor]:
    return int8_quantize(x, seed, stream)


_int8_quantize_op.register_kernel("cpu")(
    lambda x, seed, stream: int8_quantize_plain(x, seed, stream))


@_int8_quantize_op.register_fake
def _(x, seed, stream):
    return (x.new_empty(x.shape, dtype=torch.int8),
            x.new_empty((), dtype=torch.float32))


@torch.library.custom_op("hvd_torch::int8_block_quantize", mutates_args=(),
                         device_types="cuda")
def _int8_block_quantize_op(
        x: torch.Tensor, block_size: int, seed: int, stream: int,
        rows: bool) -> tuple[torch.Tensor, torch.Tensor]:
    return int8_block_quantize(x, block_size, seed, stream, rows)


_int8_block_quantize_op.register_kernel("cpu")(
    lambda x, block_size, seed, stream, rows: int8_block_quantize_plain(
        x, block_size, seed, stream, rows))


@_int8_block_quantize_op.register_fake
def _(x, block_size, seed, stream, rows):
    r, c = (x.shape[0], x.shape[1]) if rows else (1, x.numel())
    nb = -(-c // block_size)
    scales = x.new_empty((r, nb) if rows else (nb,), dtype=torch.float32)
    return x.new_empty(x.shape, dtype=torch.int8), scales


@torch.library.custom_op("hvd_torch::adasum_dots", mutates_args=(),
                         device_types="cuda")
def _adasum_dots_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return adasum_dots(a, b)


_adasum_dots_op.register_kernel("cpu")(adasum_dots_plain)


@_adasum_dots_op.register_fake
def _(a, b):
    return a.new_empty((3,), dtype=torch.float32)


@torch.library.custom_op("hvd_torch::adasum_apply", mutates_args=(),
                         device_types="cuda")
def _adasum_apply_op(a: torch.Tensor, b: torch.Tensor,
                     dots: torch.Tensor) -> torch.Tensor:
    return adasum_apply(a, b, dots)


_adasum_apply_op.register_kernel("cpu")(adasum_apply_plain)


@_adasum_apply_op.register_fake
def _(a, b, dots):
    return torch.empty_like(a, memory_format=torch.contiguous_format)


OPS = torch.ops.hvd_torch
